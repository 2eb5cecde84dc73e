// Designs of P1's one-hot gather that the kernel in
// imageanalysis_tpu_torch/csrc/mma_probe.cu (onehot_gather_kernel) was
// chosen over, kept to time against it (scripts_torch/gather_designs.py
// builds this file with nvcc and loads it by ctypes). Each computes
//   out[t, c] = sum_n [j[t] == n] bf16(vals[c, n])   j (T), vals (3, N) f32
// with mma.sync m16n8k16 bf16 one-hot products, as that kernel does:
//   0  one block of 32 warps a 16-row group, a warp 12 k-steps of N (192
//      columns) with one compare-and-select a one-hot fragment value: the
//      (T / 16) x (N / 16) products on T / 16 SMs (8 at T = 128);
//   1  a cluster of 8 blocks of 8 warps a row group, each block an eighth
//      of N, the one-hot fragment from one found k-step a run, the blocks'
//      sums meeting in rank 0's shared memory after cluster.sync() (a
//      GPU-scope fence and an L1 invalidation), twice;
//   2  an empty kernel of T / 16 x 8 blocks: the launch's own floor.
// Design 1 with st.async and an mbarrier in place of the two cluster.sync()
// is the kernel that mma_probe.cu ships.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "../imageanalysis_tpu_torch/csrc/mma_sync.cuh"

namespace cg = cooperative_groups;
using mma_sync::mma_bf16;

namespace {

__device__ __forceinline__ unsigned onehot2(int j, int k) {
  return (j == k ? 0x3F80u : 0u) | (j == k + 1 ? 0x3F800000u : 0u);
}

__device__ __forceinline__ unsigned bf16x2_rn(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__global__ void __launch_bounds__(1024)
block_a_group(const int* __restrict__ j, const float* __restrict__ vals,
              float* __restrict__ out, int N) {
  constexpr int W = 32, KS = 12;
  __shared__ float red[W][48];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * 16, g = lane >> 2, q = lane & 3;
  const int ja = j[row0 + g], jb = j[row0 + g + 8];
  const float* v = vals + (size_t)(g < 3 ? g : 0) * N + 4 * q;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k_run = warp * KS * 16; k_run < N; k_run += W * KS * 16) {
    float4 x[KS];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int k0 = k_run + 16 * s;
      x[s] = g < 3 && k0 < N ? *reinterpret_cast<const float4*>(v + k0)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int k = k_run + 16 * s + 4 * q;
      mma_bf16(c, onehot2(ja, k), onehot2(jb, k), onehot2(ja, k + 2),
               onehot2(jb, k + 2), bf16x2_rn(x[s].x, x[s].y),
               bf16x2_rn(x[s].z, x[s].w));
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (2 * q + e < 3) {
      red[warp][3 * g + 2 * q + e] = c[e];
      red[warp][3 * (g + 8) + 2 * q + e] = c[2 + e];
    }
  __syncthreads();
  if (threadIdx.x < 48) {
    float sum = 0.f;
    for (int w = 0; w < W; ++w) sum += red[w][threadIdx.x];
    out[(size_t)row0 * 3 + threadIdx.x] = sum;
  }
}

constexpr int kCluster = 8, kWarps = 8, kSteps = 6;

__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kWarps * 32, 1)
cluster_sync(const int* __restrict__ j, const float* __restrict__ vals,
             float* __restrict__ out, int N) {
  __shared__ float red[kWarps][48];
  __shared__ float part[48];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x / kCluster) * 16, g = lane >> 2, q = lane & 3;
  const int S = N / 16;
  const int s_end = (int)((long long)(rank + 1) * S / kCluster);
  const int ja = j[row0 + g], jb = j[row0 + g + 8];
  const float* v = vals + (size_t)(g < 3 ? g : 0) * N + 4 * q;
  float c[2][4] = {};
  for (int s0 = (int)((long long)rank * S / kCluster) + warp * kSteps;
       s0 < s_end; s0 += kWarps * kSteps) {
    int step[2];
    unsigned lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = (h ? jb : ja) - 16 * s0 - 4 * q, r = e & 15;
      const unsigned one = 0x3F80u << (16 * (r & 1));
      step[h] = e >= 0 && r < 4 ? e >> 4 : -1;
      lo[h] = r < 2 ? one : 0u;
      hi[h] = r >= 2 ? one : 0u;
    }
    float4 x[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      x[s] = g < 3 && s0 + s < s_end
                 ? *reinterpret_cast<const float4*>(v + 16 * (s0 + s))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      if (s0 + s < s_end)
        mma_bf16(c[s & 1], step[0] == s ? lo[0] : 0u,
                 step[1] == s ? lo[1] : 0u, step[0] == s ? hi[0] : 0u,
                 step[1] == s ? hi[1] : 0u, bf16x2_rn(x[s].x, x[s].y),
                 bf16x2_rn(x[s].z, x[s].w));
  }
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (2 * q + e < 3) {
      red[warp][3 * g + 2 * q + e] = c[0][e] + c[1][e];
      red[warp][3 * (g + 8) + 2 * q + e] = c[0][2 + e] + c[1][2 + e];
    }
  __syncthreads();
  if (threadIdx.x < 48) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[w][threadIdx.x];
    part[threadIdx.x] = sum;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x < 48) {
    float sum = 0.f;
    for (int r = 0; r < kCluster; ++r)
      sum += cluster.map_shared_rank(part, r)[threadIdx.x];
    out[(size_t)row0 * 3 + threadIdx.x] = sum;
  }
  cluster.sync();
}

__global__ void empty_kernel(float* out) {
  if (threadIdx.x < 48) out[blockIdx.x * 48 + threadIdx.x] = 0.f;
}

}  // namespace

// design 0, 1 or 2 above on j (T), vals (3, N) f32, out (T, 3); T and N
// multiples of 16. Returns the cudaError_t of the launch.
extern "C" int gather_design(int design, const void* j, const void* vals,
                             void* out, int T, int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T <= 0 || N <= 0 || T % 16 || N % 16) return (int)cudaErrorInvalidValue;
  if (design == 0)
    block_a_group<<<T / 16, 1024, 0, s>>>((const int*)j, (const float*)vals,
                                          (float*)out, N);
  else if (design == 1)
    cluster_sync<<<T / 16 * kCluster, kWarps * 32, 0, s>>>(
        (const int*)j, (const float*)vals, (float*)out, N);
  else if (design == 2)
    empty_kernel<<<T / 16 * kCluster, kWarps * 32, 0, s>>>((float*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
