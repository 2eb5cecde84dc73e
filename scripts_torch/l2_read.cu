// Read rate of the H100's L2 cache, for P5's feed bound (PERF.md): every
// thread of a grid that fills the card reads 16 bytes at a time with
// ld.global.cg (cached in L2, not in L1) over a buffer, `reps` times, and
// adds what it read into one float that it writes at the end, so that no
// load is dropped. A buffer well inside the 50 MB L2 is read from L2
// after the first pass; a buffer of gigabytes from device memory.
// scripts_torch/l2_read_rate.py builds this file with nvcc and times it.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(512)
read_kernel(const float4* __restrict__ buf, long long n, int reps,
            float* __restrict__ sink) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.f;
  for (int r = 0; r < reps; ++r) {
    long long i = first;
    for (; i + 3 * stride < n; i += 4 * stride) {
      const float4 v0 = __ldcg(buf + i), v1 = __ldcg(buf + i + stride);
      const float4 v2 = __ldcg(buf + i + 2 * stride);
      const float4 v3 = __ldcg(buf + i + 3 * stride);
      acc += (v0.x + v1.y) + (v2.z + v3.w);
    }
    for (; i < n; i += stride) acc += __ldcg(buf + i).x;
  }
  sink[first] = acc;
}

}  // namespace

// buf: n float4 (16-byte aligned); sink: blocks x 512 floats. Returns the
// cudaError_t of the launch.
extern "C" int l2_read(const void* buf, long long n, int reps, int blocks,
                       void* sink, void* stream) {
  if (n <= 0 || reps <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  read_kernel<<<blocks, 512, 0, (cudaStream_t)stream>>>(
      (const float4*)buf, n, reps, (float*)sink);
  return (int)cudaGetLastError();
}
