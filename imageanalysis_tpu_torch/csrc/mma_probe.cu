// Tensor-core probes, for Hopper (sm_90a): mma.sync m16n8k16 bf16 -> f32
// through inline PTX (mma_sync.cuh, shared with K1/K3's bf16 body).
//
// mm_rowsum replaces scripts_dev/matmul_shape_probe.py:33 (mm_kernel, P5):
// the descriptor product's rate against K. For each matrix of a batch,
//   out[m] = sum_n sum_k a[m, k] b[n, k]       a (M, K), b (N, K) bf16
// with f32 accumulation: the product K1 and K3 compute, with the
// cheapest epilogue (a row sum) in place of their keys. Design: a block
// owns BM rows of A and sweeps a range of BN-row tiles of B; A and B come
// through shared memory 64 dims at a time (rows padded to 144 B, 16-byte
// aligned, so ldmatrix reads without bank conflicts); 8 warps each own a
// (BM / WM) x (BN / WN) tile of m16n8 accumulators fed by ldmatrix.x4. After
// each B tile a thread adds its accumulators into its rows' sums; the
// quads' lanes and then the warps of a row are summed in a fixed order,
// and a block stores its rows' sums, or adds them with atomicAdd where the
// B range is split over several blocks (n_split > 1, for a batch too small
// to fill the card). Integer-valued inputs whose sums stay below 2^24
// give exact sums in any order. What bounds it: the tensor cores (2 M N K
// flops a matrix) when the tiles stream from L2; this simple version
// loads synchronously, with no cp.async or TMA pipeline and no wgmma.
//
// onehot_gather replaces scripts_dev/epilogue_dot_probe.py:25 (kern, P1):
//   out[t, c] = sum_n [j[t] == n] vals[c, n]   j (T) int32, vals (3, N) bf16
// the one-hot gather the TPU's match epilogue ran on its matrix unit. The
// one-hot A fragments are built in registers from j and never stored; B
// is vals^T, its 3 columns padded to the mma's 8 with zeros. Each warp owns
// 16 rows of T and a 512-column range of N; the range's partial sums, one
// value and zeros, are added into out with atomicAdd, exact in any order.
// The products are exact (1.0 x a bf16 value), so out is vals[:, j]
// rounded to bf16 first: the question the TPU probe asked. What bounds it:
// launch latency (36 KB of inputs).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using mma_sync::ldmatrix_x4;
using mma_sync::mma_bf16;

constexpr int kThreads = 256;
constexpr int kKC = 64;             // dims per shared-memory chunk
constexpr int kLds = kKC + 8;       // padded row: 144 B

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
mm_rowsum_kernel(const uint16_t* __restrict__ a,
                 const uint16_t* __restrict__ b, float* __restrict__ out,
                 int M, int N, int K, int n_split) {
  constexpr int WM = BM / 32;       // warps along M: 32 rows each
  constexpr int WN = 8 / WM;        // warps along N
  constexpr int MT = 2;             // m16 tiles per warp
  constexpr int NT = BN / WN / 8;   // n8 tiles per warp
  static_assert(WM * WN == 8 && NT % 2 == 0, "8 warps, n8 tiles in pairs");
  __shared__ __align__(16) uint16_t sa[BM * kLds];
  __shared__ __align__(16) uint16_t sb[BN * kLds];
  __shared__ float red[WN][BM];

  const int mat = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = (warp % WM) * 32;  // the warp's rows within the block
  const int wn = (warp / WM) * (BN / WN);
  const uint16_t* A = a + ((size_t)mat * M + m0) * K;
  const uint16_t* Bm = b + (size_t)mat * N * K;
  const int n_tiles = N / BN;
  const int t_begin = (int)((long long)blockIdx.y * n_tiles / n_split);
  const int t_end = (int)((long long)(blockIdx.y + 1) * n_tiles / n_split);

  float rs[MT][2];                  // this thread's rows: g and g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) rs[mt][0] = rs[mt][1] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const uint16_t* Bt = Bm + (size_t)t * BN * K;
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    for (int kc = 0; kc < K; kc += kKC) {
      __syncthreads();              // previous chunk fully consumed
      for (int w = tid; w < BM * (kKC / 8); w += kThreads) {
        const int r = w / (kKC / 8), c = (w % (kKC / 8)) * 8;
        *reinterpret_cast<uint4*>(sa + r * kLds + c) =
            *reinterpret_cast<const uint4*>(A + (size_t)r * K + kc + c);
      }
      for (int w = tid; w < BN * (kKC / 8); w += kThreads) {
        const int r = w / (kKC / 8), c = (w % (kKC / 8)) * 8;
        *reinterpret_cast<uint4*>(sb + r * kLds + c) =
            *reinterpret_cast<const uint4*>(Bt + (size_t)r * K + kc + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        unsigned af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                      sa + (wm + mt * 16 + (lane & 15)) * kLds + kk +
                          (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          unsigned b0, b1, b2, b3;  // (nt, k 0-7), (nt, k 8-15), nt + 1
          ldmatrix_x4(b0, b1, b2, b3,
                      sb + (wn + nt * 8 + (lane >> 4) * 8 + (lane & 7)) *
                                   kLds +
                          kk + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][nt], af[mt][0], af[mt][1], af[mt][2],
                     af[mt][3], b0, b1);
            mma_bf16(acc[mt][nt + 1], af[mt][0], af[mt][1], af[mt][2],
                     af[mt][3], b2, b3);
          }
        }
      }
    }
    // the row sum: c0, c1 are row g = lane / 4, c2, c3 row g + 8
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        rs[mt][0] += acc[mt][nt][0] + acc[mt][nt][1];
        rs[mt][1] += acc[mt][nt][2] + acc[mt][nt][3];
      }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rs[mt][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0)
        red[warp / WM][wm + mt * 16 + h * 8 + (lane >> 2)] = v;
    }
  __syncthreads();
  if (tid < BM) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WN; ++w) s += red[w][tid];
    float* o = out + (size_t)mat * M + m0 + tid;
    if (n_split == 1) *o = s;
    else atomicAdd(o, s);
  }
}

template <int BM, int BN>
int launch_mm(const void* a, const void* b, void* out, int batch, int M,
              int N, int K, int n_split, cudaStream_t s) {
  if (M % BM || N % BN || n_split > N / BN)
    return (int)cudaErrorInvalidValue;
  dim3 grid(M / BM, n_split, batch);
  mm_rowsum_kernel<BM, BN><<<grid, kThreads, 0, s>>>(
      (const uint16_t*)a, (const uint16_t*)b, (float*)out, M, N, K, n_split);
  return (int)cudaGetLastError();
}

constexpr int kGatherCols = 512;    // N columns per warp
constexpr int kGatherWarps = 4;     // 16 rows each

__device__ __forceinline__ unsigned onehot2(int j, int k) {
  return (j == k ? 0x3F80u : 0u) | (j == k + 1 ? 0x3F800000u : 0u);
}

__global__ void __launch_bounds__(kGatherWarps * 32)
onehot_gather_kernel(const int* __restrict__ j,
                     const uint16_t* __restrict__ vals,
                     float* __restrict__ out, int T, int N) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kGatherWarps + warp) * 16;
  if (row0 >= T) return;
  const int g = lane >> 2;          // fragment row; B column
  const int q = (lane & 3) * 2;     // fragment column pair
  const int ja = j[row0 + g];
  const int jb = j[row0 + g + 8];
  const int k_begin = blockIdx.y * kGatherCols;
  const int k_end = min(N, k_begin + kGatherCols);
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = k_begin; k0 < k_end; k0 += 16) {
    const int k = k0 + q;
    // A (16 x 16): a0 row g, cols k, k+1; a1 row g+8; a2, a3 cols k+8, k+9
    const unsigned a0 = onehot2(ja, k), a1 = onehot2(jb, k);
    const unsigned a2 = onehot2(ja, k + 8), a3 = onehot2(jb, k + 8);
    // B (16 x 8) column g = vals row g: b0 rows k, k+1; b1 rows k+8, k+9
    unsigned b0 = 0u, b1 = 0u;
    if (g < 3) {
      b0 = *reinterpret_cast<const unsigned*>(vals + (size_t)g * N + k);
      b1 = *reinterpret_cast<const unsigned*>(vals + (size_t)g * N + k + 8);
    }
    mma_bf16(c, a0, a1, a2, a3, b0, b1);
  }
  // c0, c1: row g, columns q, q+1; c2, c3: row g + 8
  if (q < 3) {
    atomicAdd(out + (size_t)(row0 + g) * 3 + q, c[0]);
    atomicAdd(out + (size_t)(row0 + g + 8) * 3 + q, c[2]);
  }
  if (q + 1 < 3) {
    atomicAdd(out + (size_t)(row0 + g) * 3 + q + 1, c[1]);
    atomicAdd(out + (size_t)(row0 + g + 8) * 3 + q + 1, c[3]);
  }
}

}  // namespace

// a (batch, M, K), b (batch, N, K) bf16 bits, 16-byte aligned; out (batch,
// M) f32, zero-filled when n_split > 1. K a multiple of 64; (bm, bn) one of
// (64, 64), (64, 128), (128, 64), (128, 128) with M % bm = N % bn = 0;
// 1 <= n_split <= N / bn. Returns the cudaError_t of the launch.
extern "C" int mm_rowsum_bf16(const void* a, const void* b, void* out,
                              int batch, int M, int N, int K, int bm,
                              int bn, int n_split, void* stream) {
  if (batch <= 0 || batch > 65535 || M <= 0 || N <= 0 || K <= 0 ||
      K % kKC || n_split <= 0 || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 64 && bn == 64)
    return launch_mm<64, 64>(a, b, out, batch, M, N, K, n_split, s);
  if (bm == 64 && bn == 128)
    return launch_mm<64, 128>(a, b, out, batch, M, N, K, n_split, s);
  if (bm == 128 && bn == 64)
    return launch_mm<128, 64>(a, b, out, batch, M, N, K, n_split, s);
  if (bm == 128 && bn == 128)
    return launch_mm<128, 128>(a, b, out, batch, M, N, K, n_split, s);
  return (int)cudaErrorInvalidValue;
}

// j (T) int32 in [0, N); vals (3, N) bf16 bits; out (T, 3) f32,
// zero-filled. T a multiple of 16, N a multiple of 16.
extern "C" int onehot_gather_bf16(const void* j, const void* vals, void* out,
                                  int T, int N, void* stream) {
  if (T <= 0 || N <= 0 || T % 16 || N % 16) return (int)cudaErrorInvalidValue;
  const int rows_per_block = kGatherWarps * 16;
  dim3 grid((T + rows_per_block - 1) / rows_per_block,
            (N + kGatherCols - 1) / kGatherCols);
  onehot_gather_kernel<<<grid, kGatherWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)j, (const uint16_t*)vals, (float*)out, T, N);
  return (int)cudaGetLastError();
}
