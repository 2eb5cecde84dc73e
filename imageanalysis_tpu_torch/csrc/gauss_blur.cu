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
// What bounds it on the H100: it sits near the ridge. Each output pixel
// costs 2 * 2(2r+1) separately rounded f32 operations (84 at the pyramid's
// largest 21 taps, plus the recomputed halo rows of the row pass) against
// 8 bytes of compulsory traffic (one f32 read, one f32 write). Without
// FMA the card issues ~34 T f32 operations/s against 3.35 TB/s, about 10
// per byte, so both the traffic and the instruction count matter.
//
// Design: one block per (image, 64 x 32 output tile). The block reads the
// tile plus an r-pixel halo once into shared memory (reflected indices),
// runs the row pass over the halo rows into a second shared buffer, then
// the column pass to device memory, so the image is read once and written
// once and the reference's transposes and intermediate image disappear.
// A row pass of a reflected row is the reflected row of the row-blurred
// image, so the fused form means the same as the reference's two passes as
// long as one reflection suffices (r < H and r < W; the caller checks).

#include <cuda_runtime.h>
#include <cstring>

namespace {

constexpr int kTW = 64;             // output tile width
constexpr int kTH = 32;             // output tile height
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

__global__ void __launch_bounds__(kThreads)
gauss_blur_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int H, int W, int r, Taps taps) {
  extern __shared__ float smem[];
  const int sw = kTW + 2 * r;       // shared input tile: sh x sw
  const int sh = kTH + 2 * r;
  float* s_in = smem;
  float* s_mid = smem + sh * sw;    // row-blurred halo rows: sh x kTW
  const int n = 2 * r + 1;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const size_t plane = (size_t)H * W;
  const float* src = in + blockIdx.z * plane;
  float* dst = out + blockIdx.z * plane;

  for (int t = threadIdx.x; t < sh * sw; t += kThreads) {
    const int gy = reflect101(y0 - r + t / sw, H);
    const int gx = reflect101(x0 - r + t % sw, W);
    s_in[t] = src[(size_t)gy * W + gx];
  }
  __syncthreads();

  for (int t = threadIdx.x; t < sh * kTW; t += kThreads) {
    const float* p = s_in + (t / kTW) * sw + (t % kTW);
    float acc = __fmul_rn(p[0], taps.k[0]);
    for (int j = 1; j < n; ++j) acc = __fadd_rn(acc, __fmul_rn(p[j], taps.k[j]));
    s_mid[t] = acc;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < kTH * kTW; t += kThreads) {
    const int ly = t / kTW, lx = t % kTW;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const float* p = s_mid + ly * kTW + lx;
    float acc = __fmul_rn(p[0], taps.k[0]);
    for (int j = 1; j < n; ++j)
      acc = __fadd_rn(acc, __fmul_rn(p[j * kTW], taps.k[j]));
    dst[(size_t)gy * W + gx] = acc;
  }
}

}  // namespace

// in, out: (n_img, H, W) f32 contiguous device buffers; taps: HOST pointer
// to 2r+1 floats (passed to the kernel by value). 0 <= r <= 15, r < H,
// r < W. Returns the cudaError_t of the launch.
extern "C" int gauss_blur_f32(const void* in, void* out, const void* taps,
                              int n_img, int H, int W, int r, void* stream) {
  if (r < 0 || r > kRMax || r >= H || r >= W || n_img <= 0 ||
      n_img > 65535 || (H + kTH - 1) / kTH > 65535)
    return (int)cudaErrorInvalidValue;
  Taps t;
  std::memset(&t, 0, sizeof(t));
  std::memcpy(t.k, taps, sizeof(float) * (2 * r + 1));
  const size_t smem =
      sizeof(float) * (size_t)(kTH + 2 * r) * (2 * kTW + 2 * r);
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, n_img);
  gauss_blur_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, H, W, r, t);
  return (int)cudaGetLastError();
}
