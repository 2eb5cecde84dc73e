// K2: separable Gaussian blur of a batch of f32 images, for Hopper (sm_90a).
//
// Replaces imageanalysis_tpu/features/sift_tpu.py::_hblur_kernel, the
// row-direction pass that the reference's _blur runs twice (with a
// transpose between) for every level of the SIFT pyramid.
//
// What it computes: out = column pass of (row pass of in), each pass
//   y[x] = sum_{j=0..2r} p[x + j - r] * k_j   (taps summed in order j = 0..2r)
// over reflect-101 borders (cv2 BORDER_REFLECT_101 = jnp.pad "reflect").
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, so
// nvcc cannot contract them into FMAs): the result equals the plain
// PyTorch version (features/sift.py::blur_plain), which multiplies and
// adds in separate elementwise ops, bit for bit.
//
// What bounds it on the H100: it sits on the ridge. Each output pixel
// costs 2 (2(2r+1) - 1) separately rounded f32 operations (82 at the
// pyramid's largest 21 taps) against 8 bytes of compulsory traffic (one
// f32 read, one f32 write). An unfused FMUL or FADD issues at the CUDA
// cores' instruction rate, 132 SMs x 128 lanes x the clock (~33.5 T/s),
// against 3.35 TB/s: about 10 operations a byte, so at 21 taps the
// operations slightly exceed the bytes, and at 9 taps the bytes rule.
// Both the traffic and every instruction beside the taps' FMUL/FADD
// count.
//
// Design: one block per (image, 128 x 64 output tile), both passes fused,
// so the image is read once and written once and the reference's
// transposes and intermediate image disappear.
// - The radius is a template parameter (one kernel per r = 0..15, chosen
//   at launch): every loop over the taps unrolls, and each tap is an
//   immediate operand from the parameter bank.
// - The input tile with its halo goes to shared memory once. Where its
//   columns lie inside the image (rows 16-byte aligned), by 16-byte
//   cp.async copies of 16 extra columns on each side, reflected only in
//   the row index, in bands of 16 rows, each its own copy group: the row
//   pass starts on the first band while the others are in flight. Tiles
//   at the left and right edges take scalar loads through reflect101.
// - Register sliding windows: a thread computes a run of kV = 8
//   consecutive outputs (along x in the row pass, along y in the column
//   pass) from the kV + 2r inputs it holds in registers, so each input
//   leaves shared memory once a run, not 2r + 1 times (the row pass by
//   16-byte loads). The row pass covers the tile's 64 rows and the 2r
//   halo rows the column pass needs (at r = 10, 84/64 of its work), and
//   writes each row's outputs over the row it read (a warp reads its two
//   rows whole before it writes), so a block needs one buffer: <= 62 KB,
//   three blocks an SM.
// A row pass of a reflected row is the reflected row of the row-blurred
// image, so the fused form means the same as the reference's two passes as
// long as one reflection suffices (r < H and r < W; the caller checks).
//
// gauss_blur_loop_f32 keeps the first body as the yardstick: a 64 x 32
// tile, a runtime tap count, each output re-reading its 2r + 1 inputs
// from shared memory in each pass, and reflected scalar loads everywhere.

#include <cuda_runtime.h>
#include <stdint.h>
#include <cstring>

#include "mma_sync.cuh"

namespace {

constexpr int kRMax = 15;
constexpr int kThreads = 256;

struct Taps {
  float k[2 * kRMax + 1];
};

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);     // clamp: only masked outputs read these
}

// ---------------------------------------------------------------------------
// the kernel: per-radius instantiations, register windows
// ---------------------------------------------------------------------------

constexpr int kTW = 128;            // output tile width
constexpr int kTH = 64;             // output tile height
constexpr int kV = 8;               // outputs a thread computes in one run
constexpr int kHalo = 16;           // input columns each side: >= kRMax, 4 | it
constexpr int kInCols = kTW + 2 * kHalo;
constexpr int kInPitch = kInCols + 4;   // rows 16-byte aligned, and 4
                                        // banks apart (164 = 4 mod 32)
constexpr int kRuns = kTW / kV;     // row-pass runs a row
constexpr int kWarpRows = 32 / kRuns;      // rows a warp's row pass takes
constexpr int kBand = kWarpRows * kThreads / 32;   // rows a round covers
constexpr int kBlocks = 3;          // blocks an SM: <= 85 registers

template <int R>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kTH + 2 * R) * kInPitch;
}

// wait until at most n of this thread's cp.async groups are in flight
// (n < 8; a constant once the caller's loop unrolls)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: mma_sync::cp_async_wait<0>(); break;
    case 1: mma_sync::cp_async_wait<1>(); break;
    case 2: mma_sync::cp_async_wait<2>(); break;
    case 3: mma_sync::cp_async_wait<3>(); break;
    case 4: mma_sync::cp_async_wait<4>(); break;
    case 5: mma_sync::cp_async_wait<5>(); break;
    case 6: mma_sync::cp_async_wait<6>(); break;
    default: mma_sync::cp_async_wait<7>(); break;
  }
}

// acc = sum_j w[j] k_j over the 2R + 1 taps, in order, each operation
// rounded on its own
template <int R>
__device__ __forceinline__ float taps_sum(const float* w, const Taps& t) {
  float acc = __fmul_rn(w[0], t.k[0]);
#pragma unroll
  for (int j = 1; j <= 2 * R; ++j)
    acc = __fadd_rn(acc, __fmul_rn(w[j], t.k[j]));
  return acc;
}

template <int R>
__global__ void __launch_bounds__(kThreads, kBlocks)
gauss_blur_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int H, int W, bool vec,
                  const __grid_constant__ Taps taps) {
  constexpr int SH = kTH + 2 * R;   // shared rows: the tile's and the halo
  constexpr int kBands = (SH + kBand - 1) / kBand;
  static_assert(kBands <= 8, "cp.async groups in flight");
  // SH x kInPitch, column c = x0 - kHalo + c; the row pass writes its
  // outputs over columns 0 .. kTW - 1 of the row it read
  extern __shared__ __align__(16) float s[];
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const size_t plane = (size_t)H * W;
  const float* src = in + blockIdx.z * plane;
  float* dst = out + blockIdx.z * plane;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // 1. the input tile and its halo. Columns inside the image: 16-byte
  // copies of reflected rows, one cp.async group a band of kBand rows, so
  // the row pass starts on the first band while the others arrive.
  // Otherwise scalar loads through reflect101 in both directions.
  const bool vec_x = vec && x0 >= kHalo && x0 + kTW + kHalo <= W;
  if (vec_x) {
    constexpr int kQ = kInCols / 4;         // 16-byte chunks a row
#pragma unroll
    for (int b = 0; b < kBands; ++b) {
      const int rows = min(kBand, SH - b * kBand);
      for (int t = tid; t < rows * kQ; t += kThreads) {
        const int r = b * kBand + t / kQ, c = (t % kQ) * 4;
        const float* g = src + (size_t)reflect101(y0 - R + r, H) * W +
                         (x0 - kHalo);
        mma_sync::cp_async16(s + r * kInPitch + c, g + c);
      }
      mma_sync::cp_async_commit();
    }
  } else {
    for (int r = warp; r < SH; r += kThreads / 32) {
      const float* g = src + (size_t)reflect101(y0 - R + r, H) * W;
      for (int c = lane; c < kInCols; c += 32)
        s[r * kInPitch + c] = g[reflect101(x0 - kHalo + c, W)];
    }
  }

  // 2. the row pass, a band at a time: a warp takes kWarpRows rows, a lane
  // a run of kV outputs along x. Lanes 8j..8j+3 read four runs of one row,
  // lanes 8j+4..8j+7 the same runs of the next, so each quarter-warp's
  // 16-byte loads fall on distinct banks (rows are 4 banks apart). The
  // window of a run starts kHalo - R columns in, loaded from the 16-byte
  // boundary at or before it.
  {
    constexpr int kLo = (kHalo - R) & ~3;
    constexpr int kShift = (kHalo - R) - kLo;
    constexpr int kWin = (kShift + kV + 2 * R + 3) / 4;   // float4s
    static_assert(kLo + (kRuns - 1) * kV + 4 * kWin <= kInCols,
                  "the windows stay inside the loaded columns");
    static_assert(kRuns % 4 == 0 && 32 % kRuns == 0, "whole rows a warp");
    const int v0 = ((lane & 3) | (((lane >> 3) % (kRuns / 4)) << 2)) * kV;
    const int wr = ((lane >> 2) & 1) | (((lane >> 3) / (kRuns / 4)) << 1);
#pragma unroll
    for (int b = 0; b < kBands; ++b) {
      if (vec_x) cp_async_wait_upto(kBands - 1 - b);
      __syncthreads();              // band b (or the whole tile) is in
      const int r = b * kBand + kWarpRows * warp + wr;
      float w[4 * kWin];
      if (r < SH) {
        const float4* p =
            reinterpret_cast<const float4*>(s + r * kInPitch + kLo + v0);
#pragma unroll
        for (int i = 0; i < kWin; ++i) {
          const float4 q = p[i];
          w[4 * i] = q.x;
          w[4 * i + 1] = q.y;
          w[4 * i + 2] = q.z;
          w[4 * i + 3] = q.w;
        }
      }
      __syncwarp();                 // the row is read: write over it
      if (r < SH) {
        float o[kV];
#pragma unroll
        for (int v = 0; v < kV; ++v) o[v] = taps_sum<R>(w + kShift + v, taps);
        float4* m = reinterpret_cast<float4*>(s + r * kInPitch + v0);
#pragma unroll
        for (int i = 0; i < kV / 4; ++i)
          m[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2],
                             o[4 * i + 3]);
      }
    }
  }
  __syncthreads();

  // 3. the column pass, runs of kV outputs along y; a warp covers 32
  // neighbouring columns, so its reads and its stores are contiguous
  for (int t = tid; t < kTW * (kTH / kV); t += kThreads) {
    const int lx = t % kTW, v0 = (t / kTW) * kV;
    const int gx = x0 + lx;
    const float* p = s + v0 * kInPitch + lx;
    float w[kV + 2 * R];
#pragma unroll
    for (int i = 0; i < kV + 2 * R; ++i) w[i] = p[i * kInPitch];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int gy = y0 + v0 + v;
      const float y = taps_sum<R>(w + v, taps);
      if (gx < W && gy < H) dst[(size_t)gy * W + gx] = y;
    }
  }
}

template <int R>
int launch(const float* in, float* out, int n_img, int H, int W, bool vec,
           const Taps& t, cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<R>();
  // above 48 KB only after this opt-in; a refusal is returned, never lost
  const cudaError_t e = cudaFuncSetAttribute(
      gauss_blur_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, n_img);
  gauss_blur_kernel<R><<<grid, kThreads, kSmem, stream>>>(in, out, H, W, vec,
                                                          t);
  return (int)cudaGetLastError();
}

template <int R>
int dispatch(int r, const float* in, float* out, int n_img, int H, int W,
             bool vec, const Taps& t, cudaStream_t s) {
  if constexpr (R > kRMax) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (r == R) return launch<R>(in, out, n_img, H, W, vec, t, s);
    return dispatch<R + 1>(r, in, out, n_img, H, W, vec, t, s);
  }
}

// ---------------------------------------------------------------------------
// the yardstick: a runtime tap loop over shared memory
// ---------------------------------------------------------------------------

constexpr int kLoopTW = 64;
constexpr int kLoopTH = 32;

__global__ void __launch_bounds__(kThreads)
gauss_blur_loop_kernel(const float* __restrict__ in, float* __restrict__ out,
                       int H, int W, int r, Taps taps) {
  extern __shared__ float smem[];
  const int sw = kLoopTW + 2 * r;   // shared input tile: sh x sw
  const int sh = kLoopTH + 2 * r;
  float* s_in = smem;
  float* s_mid = smem + sh * sw;    // row-blurred halo rows: sh x kLoopTW
  const int n = 2 * r + 1;
  const int x0 = blockIdx.x * kLoopTW;
  const int y0 = blockIdx.y * kLoopTH;
  const size_t plane = (size_t)H * W;
  const float* src = in + blockIdx.z * plane;
  float* dst = out + blockIdx.z * plane;

  for (int t = threadIdx.x; t < sh * sw; t += kThreads) {
    const int gy = reflect101(y0 - r + t / sw, H);
    const int gx = reflect101(x0 - r + t % sw, W);
    s_in[t] = src[(size_t)gy * W + gx];
  }
  __syncthreads();

  for (int t = threadIdx.x; t < sh * kLoopTW; t += kThreads) {
    const float* p = s_in + (t / kLoopTW) * sw + (t % kLoopTW);
    float acc = __fmul_rn(p[0], taps.k[0]);
    for (int j = 1; j < n; ++j) acc = __fadd_rn(acc, __fmul_rn(p[j], taps.k[j]));
    s_mid[t] = acc;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < kLoopTH * kLoopTW; t += kThreads) {
    const int ly = t / kLoopTW, lx = t % kLoopTW;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const float* p = s_mid + ly * kLoopTW + lx;
    float acc = __fmul_rn(p[0], taps.k[0]);
    for (int j = 1; j < n; ++j)
      acc = __fadd_rn(acc, __fmul_rn(p[j * kLoopTW], taps.k[j]));
    dst[(size_t)gy * W + gx] = acc;
  }
}

bool bad_args(int n_img, int H, int W, int r, int tile_h) {
  return r < 0 || r > kRMax || r >= H || r >= W || n_img <= 0 ||
         n_img > 65535 || (H + tile_h - 1) / tile_h > 65535;
}

Taps make_taps(const void* taps, int r) {
  Taps t;
  std::memset(&t, 0, sizeof(t));
  std::memcpy(t.k, taps, sizeof(float) * (2 * r + 1));
  return t;
}

}  // namespace

// in, out: (n_img, H, W) f32 contiguous device buffers; taps: HOST pointer
// to 2r+1 floats (passed to the kernel by value). 0 <= r <= 15, r < H,
// r < W. Returns the cudaError_t of the launch.
extern "C" int gauss_blur_f32(const void* in, void* out, const void* taps,
                              int n_img, int H, int W, int r, void* stream) {
  if (bad_args(n_img, H, W, r, kTH)) return (int)cudaErrorInvalidValue;
  // 16-byte copies need 16-byte aligned rows
  const bool vec = W % 4 == 0 && (uintptr_t)in % 16 == 0;
  return dispatch<0>(r, (const float*)in, (float*)out, n_img, H, W, vec,
                     make_taps(taps, r), (cudaStream_t)stream);
}

// The yardstick body (gauss_blur_loop_kernel), same arguments and result.
extern "C" int gauss_blur_loop_f32(const void* in, void* out,
                                   const void* taps, int n_img, int H, int W,
                                   int r, void* stream) {
  if (bad_args(n_img, H, W, r, kLoopTH)) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (size_t)(kLoopTH + 2 * r) * (2 * kLoopTW + 2 * r);
  dim3 grid((W + kLoopTW - 1) / kLoopTW, (H + kLoopTH - 1) / kLoopTH, n_img);
  gauss_blur_loop_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, H, W, r,
      make_taps(taps, r));
  return (int)cudaGetLastError();
}
