// Probe of a single-launch K1 + K4, for Hopper (sm_90a).
//
// Replaces the TPU dev probe scripts_dev/fused_vmem_probe.py:26 (kern in
// make): the packed int8 2-NN of one pair and its match epilogue in one
// kernel, with parts switched off, at n = 6144, d = 128. Per pair p:
//   main (the __dp4a int8 body, knn_common.cuh): row_p, col_p equal to
//        K1's;
//        with do_pb, pb[p, i] = uv_b[p, j] for the row's best j, gathered
//        by the block that owns row i once its sweep over B is done
//   epi  (K4 at ratio 0.75, ratio2 = 0.5625 as the TPU probe hard-codes):
//        bj[p, i] = j, ok[p, i] = max(d1, 0) < 0.5625 * max(d2, 0) &&
//        col_p[p, j] & 0x1FFF == i (int32 0/1), run by the last block of
//        the pair to finish its main part.
// The TPU kernel ran the epilogue at grid step n / tile_a, after every A
// tile: its grid was sequential. Here blocks run in any order, and K4 is a
// second launch in the port because col_p is final only after K1's last A
// tile. So each block, after its main part, fences its writes
// (__threadfence), and one thread adds one to the pair's counter; the
// block that sees n / TA - 1 is the pair's last, reads row_p and col_p
// through L2 (__ldcg: another block's atomics and stores, never a stale L1
// line) and runs the epilogue, then sets the counter back to 0 for the
// next launch. No grid-wide barrier: 96 blocks x 64 pairs are more than
// can be resident at once, and a cooperative grid.sync() would deadlock.
//
// Variants (the TPU probe's cases): full (TA 128, epilogue on 256 threads),
// nopb, noepi, nomain, epi32 (the TPU's epilogue chunk of 32 rows against
// 64 maps to half the block: 128 threads), t64 (TA 64, K1's tile). noepi
// and nomain leave outputs unwritten (undefined, as on the TPU); they are
// timed only.
//
// What bounds it on the H100: K1's arithmetic; the epilogue is ~13 MB of
// bytes at bench's shape, run by 64 blocks (one per pair) at the tail.

#include "knn_common.cuh"

namespace {

using namespace knn;

constexpr float kRatio2 = 0.5625f;

template <int TA, bool MAIN, bool EPI, bool PB, int EPI_THREADS>
__global__ void __launch_bounds__(kThreads)
knn_fused_probe_kernel(const int* __restrict__ a, const int* __restrict__ b,
                       const float2* __restrict__ uv_b, int* row_p,
                       int* col_p, int* __restrict__ counter,
                       int* __restrict__ bj, int* __restrict__ ok,
                       float2* __restrict__ pb, int n) {
  const int pair = blockIdx.y;
  const int a0 = blockIdx.x * TA;
  const int tid = threadIdx.x;
  const size_t base = (size_t)pair * n;
  if (MAIN) {
    knn_i8_block<false, kFull, TA, kTB>(a, b, nullptr, nullptr, 0.f, row_p,
                                        col_p, n, n);
    if (PB) {
      __syncthreads();              // this block's row_p stores are visible
      if (tid < TA) {
        pb[base + a0 + tid] = uv_b[base + (row_p[(base + a0 + tid) * 2] &
                                           kIdxMask)];
      }
    }
  }
  if (!EPI) return;
  __shared__ bool last;
  __threadfence();                  // row_p, col_p, pb before the count
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counter[pair], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < EPI_THREADS) {
    const int2* rows = reinterpret_cast<const int2*>(row_p) + base;
    const int* cols = col_p + base;
    for (int i = tid; i < n; i += EPI_THREADS) {
      const int2 k = __ldcg(rows + i);
      const int j = k.x & kIdxMask;
      float d1 = __int_as_float(k.x & ~kIdxMask);
      float d2 = __int_as_float(k.y & ~kIdxMask);
      d1 = d1 < 0.0f ? 0.0f : d1;   // keeps a NaN, as K4
      d2 = d2 < 0.0f ? 0.0f : d2;
      bool good = d1 < __fmul_rn(kRatio2, d2);
      good = good && j < n && (__ldcg(cols + j) & kIdxMask) == i;
      bj[base + i] = j;
      ok[base + i] = good ? 1 : 0;
    }
  }
  if (tid == 0) counter[pair] = 0;  // ready for the next launch
}

template <int TA, bool MAIN, bool EPI, bool PB, int EPI_THREADS>
int launch(const void* a, const void* b, const void* uv_b, void* row_p,
           void* col_p, void* counter, void* bj, void* ok, void* pb,
           int n_pairs, int n, cudaStream_t s) {
  dim3 grid(n / TA, n_pairs);
  knn_fused_probe_kernel<TA, MAIN, EPI, PB, EPI_THREADS>
      <<<grid, kThreads, 0, s>>>((const int*)a, (const int*)b,
                                 (const float2*)uv_b, (int*)row_p,
                                 (int*)col_p, (int*)counter, (int*)bj,
                                 (int*)ok, (float2*)pb, n);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b (n_pairs, n, 128) int8; uv_b (n_pairs, n, 2) f32; scratch row_p
// (n_pairs, n, 2) int32 and col_p (n_pairs, n) int32 pre-filled with
// 0x7FFFFFFF; counter (n_pairs) int32, 0 before the first launch and left
// 0 by every launch that runs the epilogue; outputs bj, ok (n_pairs, n)
// int32 and pb (n_pairs, n, 2) f32. n a multiple of tile_a and 64, <= 8192.
// The variants: (tile_a, epi_threads, do_main, do_epi, do_pb) =
// (128, 256, 1, 1, 1) full, (128, 256, 1, 1, 0) nopb, (128, 256, 1, 0, 1)
// noepi, (128, 256, 0, 1, 1) nomain, (128, 128, 1, 1, 1) epi32,
// (64, 256, 1, 1, 1) t64; any other returns cudaErrorInvalidValue.
extern "C" int knn_fused_probe(const void* a, const void* b,
                               const void* uv_b, void* row_p, void* col_p,
                               void* counter, void* bj, void* ok, void* pb,
                               int n_pairs, int n, int tile_a,
                               int epi_threads, int do_main, int do_epi,
                               int do_pb, void* stream) {
  if (n_pairs <= 0 || n_pairs > 65535 || n <= 0 || n > kIdxMask + 1 ||
      tile_a <= 0 || n % tile_a || n % kTB)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int v = (do_main ? 1 : 0) | (do_epi ? 2 : 0) | (do_pb ? 4 : 0);
#define ARGS a, b, uv_b, row_p, col_p, counter, bj, ok, pb, n_pairs, n, s
  if (tile_a == 128 && epi_threads == 256) {
    if (v == 7) return launch<128, true, true, true, 256>(ARGS);
    if (v == 3) return launch<128, true, true, false, 256>(ARGS);
    if (v == 5) return launch<128, true, false, true, 256>(ARGS);
    if (v == 6) return launch<128, false, true, true, 256>(ARGS);
  }
  if (tile_a == 128 && epi_threads == 128 && v == 7)
    return launch<128, true, true, true, 128>(ARGS);
  if (tile_a == 64 && epi_threads == 256 && v == 7)
    return launch<64, true, true, true, 256>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
