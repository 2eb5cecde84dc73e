// Shared pieces of the 2-NN kernels (K1 in knn_packed.cu, K3 in
// knn_wide.cu): tile constants, the spatial gate and the float-input
// kernel that both compile in their own modes.
//
// The float kernel: one block owns TA = 64 rows of A of one pair, resident
// in shared memory as f32 for the whole sweep over B; B streams through
// shared memory in tiles of TB = 64 rows, 32 dims at a time. Each of the
// 256 threads accumulates a 4 x 4 register tile of dots with f32 FMAs on
// operands that were bf16-rounded (or f32) on the host side. For
// integer-valued descriptors (OpenCV SIFT's and the int8 store's) every
// product and partial sum is an integer below 2^24, so the dots are exact
// whatever the order of the sums. The epilogue is written with
// __fadd_rn/__fmul_rn so nvcc cannot contract it into FMAs: the plain
// PyTorch version rounds each operation on its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace knn {

constexpr int kDim = 128;
constexpr int kTA = 64;             // A rows per block
constexpr int kTB = 64;             // B rows per streamed tile
constexpr int kKC = 32;             // dims per streamed B chunk (float path)
constexpr int kThreads = 256;       // 16 x 16 threads, 4 x 4 elements each
constexpr int kKeyMax = 0x7FFFFFFF;
constexpr int kIdxMask = 0x1FFF;    // packed keys hold indices < 8192
constexpr int kGatedBits = kKeyMax & ~kIdxMask;
constexpr long long kWideMax = 0x7FFFFFFFFFFFFFFFLL;

enum Mode { kPacked = 0, kPackedGated = 1, kWide = 2 };

// dx*dx + dy*dy > radius2 with every operation rounded on its own: an FMA
// would move candidates that sit on the gate's boundary
__device__ __forceinline__ bool gated_out(float ax, float ay, float bx,
                                          float by, float radius2) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) > radius2;
}

// f32 bits → an int32 that orders like the float, negatives included
__device__ __forceinline__ int orderable(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

// (orderable value, index) as one signed 64-bit key: the minimum is the
// smallest value, and among equal values the lowest index
__device__ __forceinline__ long long wide_key(float d2, int idx) {
  return (long long)(((unsigned long long)(unsigned)orderable(d2) << 32) |
                     (unsigned)idx);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t h) {  // bf16 bits
  return __uint_as_float((unsigned)h << 16);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
knn_float_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const float* __restrict__ na2, const float* __restrict__ nb2,
                 const float* __restrict__ uv_a,
                 const float* __restrict__ pred_b, float radius2,
                 int* __restrict__ row_p, int* __restrict__ col_p,
                 long long* __restrict__ row_k, long long* __restrict__ col_k,
                 int n_a, int n_b) {
  constexpr int kLdsA = kDim + 1;   // padded rows: conflict-free reads
  constexpr int kLdsB = kKC + 1;
  __shared__ float sa[kTA * kLdsA];
  __shared__ float sb[kTB * kLdsB];
  __shared__ float sna[kTA];
  __shared__ float snb[kTB];
  __shared__ float sua[kTA * 2];
  __shared__ float spb[kTB * 2];
  __shared__ int colmin[kTB];
  __shared__ long long colmin_w[kTB];

  const int pair = blockIdx.y;
  const int a0 = blockIdx.x * kTA;
  const int tid = threadIdx.x;
  const int tx = tid & 15;          // column group: cols tx + 16 j
  const int ty = tid >> 4;          // row group: rows ty + 16 i
  const T* A = a + ((size_t)pair * n_a + a0) * kDim;
  const T* Bm = b + (size_t)pair * n_b * kDim;

  for (int w = tid; w < kTA * kDim; w += kThreads)
    sa[(w / kDim) * kLdsA + (w % kDim)] = to_f32(A[w]);
  if (tid < kTA) sna[tid] = na2[(size_t)pair * n_a + a0 + tid];
  if (MODE == kPackedGated && tid < kTA * 2)
    sua[tid] = uv_a[((size_t)pair * n_a + a0) * 2 + tid];

  int r1[4], r2[4];
  long long w1[4], w2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r1[i] = r2[i] = kKeyMax;
    w1[i] = w2[i] = kWideMax;
  }

  for (int b0 = 0; b0 < n_b; b0 += kTB) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const T* Bt = Bm + (size_t)b0 * kDim;
    for (int kc = 0; kc < kDim; kc += kKC) {
      __syncthreads();              // previous chunk fully consumed
      for (int w = tid; w < kTB * kKC; w += kThreads)
        sb[(w / kKC) * kLdsB + (w % kKC)] =
            to_f32(Bt[(size_t)(w / kKC) * kDim + kc + (w % kKC)]);
      if (kc == 0) {
        if (tid < kTB) {
          snb[tid] = nb2[(size_t)pair * n_b + b0 + tid];
          colmin[tid] = kKeyMax;
          colmin_w[tid] = kWideMax;
        }
        if (MODE == kPackedGated && tid < kTB * 2)
          spb[tid] = pred_b[((size_t)pair * n_b + b0) * 2 + tid];
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kKC; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = sa[(ty + 16 * i) * kLdsA + kc + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sb[(tx + 16 * j) * kLdsB + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    int ck[4] = {kKeyMax, kKeyMax, kKeyMax, kKeyMax};
    long long cw[4] = {kWideMax, kWideMax, kWideMax, kWideMax};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        // (|a|^2 + |b|^2) - 2 a.b, as the reference and the plain version
        float d2 = __fsub_rn(__fadd_rn(sna[row], snb[col]),
                             __fmul_rn(2.f, acc[i][j]));
        if (MODE == kWide) {
          d2 = __fadd_rn(d2, 0.f);  // -0 → +0: equal values tie on index
          const long long rk = wide_key(d2, b0 + col);
          if (rk < w1[i]) { w2[i] = w1[i]; w1[i] = rk; }
          else if (rk < w2[i]) { w2[i] = rk; }
          const long long k2 = wide_key(d2, a0 + row);
          cw[j] = k2 < cw[j] ? k2 : cw[j];
        } else {
          int bits = __float_as_int(fmaxf(d2, 0.f)) & ~kIdxMask;
          if (MODE == kPackedGated &&
              gated_out(sua[2 * row], sua[2 * row + 1], spb[2 * col],
                        spb[2 * col + 1], radius2))
            bits = kGatedBits;
          const int rk = bits | (b0 + col);
          if (rk < r1[i]) { r2[i] = r1[i]; r1[i] = rk; }
          else if (rk < r2[i]) { r2[i] = rk; }
          ck[j] = min(ck[j], bits | (a0 + row));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (MODE == kWide) atomicMin(&colmin_w[tx + 16 * j], cw[j]);
      else atomicMin(&colmin[tx + 16 * j], ck[j]);
    }
    __syncthreads();
    if (tid < kTB) {
      if (MODE == kWide)
        atomicMin(&col_k[(size_t)pair * n_b + b0 + tid], colmin_w[tid]);
      else
        atomicMin(&col_p[(size_t)pair * n_b + b0 + tid], colmin[tid]);
    }
  }

  // merge the 16 partial top-2 lists of each row (lanes 0-15 / 16-31)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      if (MODE == kWide) {
        const long long o1 = __shfl_xor_sync(0xffffffffu, w1[i], off);
        const long long o2 = __shfl_xor_sync(0xffffffffu, w2[i], off);
        const long long hi = w1[i] > o1 ? w1[i] : o1;
        const long long lo2 = w2[i] < o2 ? w2[i] : o2;
        w1[i] = w1[i] < o1 ? w1[i] : o1;
        w2[i] = hi < lo2 ? hi : lo2;
      } else {
        const int o1 = __shfl_xor_sync(0xffffffffu, r1[i], off);
        const int o2 = __shfl_xor_sync(0xffffffffu, r2[i], off);
        const int n2 = min(max(r1[i], o1), min(r2[i], o2));
        r1[i] = min(r1[i], o1);
        r2[i] = n2;
      }
    }
    if (tx == 0) {
      const size_t r = ((size_t)pair * n_a + a0 + ty + 16 * i) * 2;
      if (MODE == kWide) { row_k[r] = w1[i]; row_k[r + 1] = w2[i]; }
      else { row_p[r] = r1[i]; row_p[r + 1] = r2[i]; }
    }
  }
}

// shape checks shared by every entry point
inline bool bad_shape(int n_pairs, int n_a, int n_b, int max_rows) {
  return n_pairs <= 0 || n_a <= 0 || n_b <= 0 || n_a % kTA || n_b % kTB ||
         n_a > max_rows || n_b > max_rows || n_pairs > 65535;
}

}  // namespace knn
