// Probe of a single-launch K1 + K4, for Hopper (sm_90a).
//
// Replaces the TPU dev probe scripts_dev/fused_vmem_probe.py:26 (kern in
// make): the packed int8 2-NN of one pair and its match epilogue in one
// kernel, with parts switched off, at n = 6144, d = 128. Per pair p:
//   main (K1 int8): row_p, col_p equal to K1's; with do_pb, pb[p, i] =
//        uv_b[p, j] for the row's best j
//   epi  (K4 at ratio 0.75, ratio2 = 0.5625 as the TPU probe hard-codes):
//        bj[p, i] = j, ok[p, i] = max(d1, 0) < 0.5625 * max(d2, 0) &&
//        col_p[p, j] & 0x1FFF == i (int32 0/1), run by the last block of
//        the pair to finish its main part (knn_tc.cuh's
//        last_block_epilogue: a fence, a self-resetting per-pair counter,
//        __ldcg reads of row_p and col_p)
//
// Three bodies behind one entry:
// - body 2, the wgmma body K1 int8 runs (knn_wg.cuh, mode kFused: kPacked
//   with a tail, wgmma s8 fed by TMA), the default. Its squared norms come
//   from K1's pre-pass (launch_row_norms_i8, two launches, B's biased as
//   K1 int8 takes them; the TPU kernel takes them as inputs too), so a
//   call is three kernels where K1 then K4 is four. The thread that
//   stores row i's top-2 keys writes pb[i] from the best index it holds;
//   the tail (wg::fused_tail) meets the consumer warpgroups at a named
//   barrier, since the producer warpgroup has left the block. K1's tile:
//   384 A rows on three consumer warpgroups (512 threads, one block an
//   SM), 64-row B tiles in a TMA ring of two. Blocks are scheduled pair
//   after pair, so every pair's tail but the last runs under later pairs'
//   main parts.
// - body 1, the mma.sync body (knn_tc.cuh, mode kFused), the yardstick:
//   blocks of 128 A rows (t64: 64), B in 128-row tiles through a cp.async
//   ring of two, mma.sync s8 m16n8k32, two blocks an SM; the tail over the
//   block after __syncthreads.
// - body 0, the first body (the __dp4a int8 body, knn_common.cuh's
//   knn_i8_block, at TA 128 or 64 and TB 64), the first yardstick: it
//   gathers pb after a barrier from row_p as the block stored it.
//
// Variants (the TPU probe's cases): full, nopb, noepi, nomain, epi32 (the
// TPU's epilogue chunk of 32 rows against 64: the epilogue on half the
// threads that run it), t64 (the TPU's half A tile). On bodies 0 and 1:
// the epilogue on 256 threads (epi32: 128), 128 A rows a block (t64: 64).
// On body 2: the tail on the 384 consumer threads (epi32: 192), 384 A
// rows (t64: 192, each consumer warpgroup one m64 half). noepi and nomain
// leave outputs unwritten (undefined, as on the TPU); they are timed only.
//
// What bounds it on the H100: K1's product, 2 n^2 128 int8 operations a
// pair at the tensor cores' 1,979 TOP/s; the epilogue is ~13 MB of bytes
// at bench's shape, run by 64 blocks (one a pair).

#include "knn_common.cuh"

namespace {

using namespace knn;

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
  if (EPI)
    tc::last_block_epilogue<EPI_THREADS>(row_p + 2 * base, col_p + base,
                                         counter + pair, bj + base,
                                         ok + base, n);
}

template <int TA, bool MAIN, bool EPI, bool PB, int EPI_THREADS>
int launch_v0(const void* a, const void* b, const void* uv_b, void* row_p,
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

// the tensor-core body in mode MODE (kFused and its flags) at BM A rows a
// block, after the norm pre-pass unless MODE skips the main part; kFused's
// pointers ride in the arguments int8 kPacked leaves unused (knn_tc.cuh's
// fused_epilogue)
template <int MODE, int BM>
int launch_tc_fused(const void* a, const void* b, const void* uv_b,
                    void* row_p, void* col_p, void* counter, void* bj_ok,
                    void* pb, void* norms, int n_pairs, int n,
                    cudaStream_t s) {
  float* na2 = (float*)norms;
  float* nb2 = na2 + (size_t)n_pairs * n;
  if (!(MODE & kFusedNoMain)) {
    int e = launch_row_norms_i8(a, na2, (long long)n_pairs * n, s);
    if (e == 0) e = launch_row_norms_i8(b, nb2, (long long)n_pairs * n, s);
    if (e != 0) return e;
  }
  return tc::launch_tile<int8_t, MODE, BM>(a, b, na2, nb2, counter, uv_b,
                                           0.f, row_p, col_p, pb, bj_ok,
                                           n_pairs, n, n, s);
}

// the wgmma body in mode MODE (kFused and its flags) over T (P2_FULL: K1
// int8's own tile, 384 A rows on three consumer warpgroups; P2_T64: t64's
// 192, one m64 half each), after the norm pre-pass (B's biased as K1 int8
// takes them, wg::nb_bias) unless MODE skips the main part; the same
// pointers as launch_tc_fused
using P2_FULL = wg::Tile<int8_t, 384, 64, 2, 3>;
using P2_T64 = wg::Tile<int8_t, 192, 64, 2, 3>;
template <typename T, int MODE>
int launch_wg_fused(const void* a, const void* b, const void* uv_b,
                    void* row_p, void* col_p, void* counter, void* bj_ok,
                    void* pb, void* norms, int n_pairs, int n,
                    cudaStream_t s) {
  float* na2 = (float*)norms;
  float* nb2 = na2 + (size_t)n_pairs * n;
  if (!(MODE & kFusedNoMain)) {
    int e = launch_row_norms_i8(a, na2, (long long)n_pairs * n, s);
    if (e == 0)
      e = launch_row_norms_i8(b, nb2, (long long)n_pairs * n, s, kDim,
                              wg::nb_bias<int8_t>());
    if (e != 0) return e;
  }
  return wg::launch<T, MODE>(a, b, na2, nb2, counter, uv_b, 0.f, row_p,
                             col_p, pb, bj_ok, n_pairs, n, n, s);
}

}  // namespace

// a, b (n_pairs, n, 128) int8, 16-byte aligned; uv_b (n_pairs, n, 2) f32;
// scratch row_p (n_pairs, n, 2) int32 and col_p (n_pairs, n) int32
// pre-filled with 0x7FFFFFFF; counter (n_pairs) int32, 0 before the first
// launch and left 0 by every launch that runs the epilogue; outputs bj, ok
// (n_pairs, n) int32 and pb (n_pairs, n, 2) f32. n a multiple of tile_a
// and 64, <= 8192. body 2, the wgmma body, and body 1, the mma.sync body:
// bj and ok one (2, n_pairs, n) buffer (ok == bj + n_pairs * n), norms
// (2, n_pairs, n) f32 scratch for the squared norms of a and b (unused by
// nomain); body 0, the __dp4a body: norms unused. The variants: (tile_a,
// epi_threads, do_main, do_epi, do_pb) = (128, 256, 1, 1, 1) full, (128,
// 256, 1, 1, 0) nopb, (128, 256, 1, 0, 1) noepi, (128, 256, 0, 1, 1)
// nomain, (128, 128, 1, 1, 1) epi32, (64, 256, 1, 1, 1) t64; any other
// returns cudaErrorInvalidValue, as does any other body. tile_a and
// epi_threads name the TPU probe's case: on the wgmma body full is K1's
// tile (384 A rows) with the tail on every consumer thread (384), epi32
// the tail on half of them, t64 192 A rows.
extern "C" int knn_fused_probe(const void* a, const void* b,
                               const void* uv_b, void* row_p, void* col_p,
                               void* counter, void* bj, void* ok, void* pb,
                               void* norms, int n_pairs, int n, int tile_a,
                               int epi_threads, int do_main, int do_epi,
                               int do_pb, int body, void* stream) {
  if (n_pairs <= 0 || n_pairs > 65535 || n <= 0 || n > kIdxMask + 1 ||
      tile_a <= 0 || n % tile_a || n % kTB)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int v = (do_main ? 1 : 0) | (do_epi ? 2 : 0) | (do_pb ? 4 : 0);
  if ((body == 1 || body == 2) &&
      ((int*)ok != (int*)bj + (size_t)n_pairs * n || (do_main && !norms)))
    return (int)cudaErrorInvalidValue;
  if (body == 2) {
#define ARGS a, b, uv_b, row_p, col_p, counter, bj, pb, norms, n_pairs, n, s
    if (tile_a == 128 && epi_threads == 256) {
      if (v == 7) return launch_wg_fused<P2_FULL, kFused>(ARGS);
      if (v == 3)
        return launch_wg_fused<P2_FULL, kFused | kFusedNoPb>(ARGS);
      if (v == 5)
        return launch_wg_fused<P2_FULL, kFused | kFusedNoEpi>(ARGS);
      if (v == 6)
        return launch_wg_fused<P2_FULL, kFused | kFusedNoMain>(ARGS);
    }
    if (tile_a == 128 && epi_threads == 128 && v == 7)
      return launch_wg_fused<P2_FULL, kFused | kFusedEpiHalf>(ARGS);
    if (tile_a == 64 && epi_threads == 256 && v == 7)
      return launch_wg_fused<P2_T64, kFused>(ARGS);
#undef ARGS
    return (int)cudaErrorInvalidValue;
  }
  if (body == 1) {
#define ARGS a, b, uv_b, row_p, col_p, counter, bj, pb, norms, n_pairs, n, s
    if (tile_a == 128 && epi_threads == 256) {
      if (v == 7) return launch_tc_fused<kFused, 128>(ARGS);
      if (v == 3) return launch_tc_fused<kFused | kFusedNoPb, 128>(ARGS);
      if (v == 5) return launch_tc_fused<kFused | kFusedNoEpi, 128>(ARGS);
      if (v == 6) return launch_tc_fused<kFused | kFusedNoMain, 128>(ARGS);
    }
    if (tile_a == 128 && epi_threads == 128 && v == 7)
      return launch_tc_fused<kFused | kFusedEpiHalf, 128>(ARGS);
    if (tile_a == 64 && epi_threads == 256 && v == 7)
      return launch_tc_fused<kFused, 64>(ARGS);
#undef ARGS
    return (int)cudaErrorInvalidValue;
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
#define ARGS a, b, uv_b, row_p, col_p, counter, bj, ok, pb, n_pairs, n, s
  if (tile_a == 128 && epi_threads == 256) {
    if (v == 7) return launch_v0<128, true, true, true, 256>(ARGS);
    if (v == 3) return launch_v0<128, true, true, false, 256>(ARGS);
    if (v == 5) return launch_v0<128, true, false, true, 256>(ARGS);
    if (v == 6) return launch_v0<128, false, true, true, 256>(ARGS);
  }
  if (tile_a == 128 && epi_threads == 128 && v == 7)
    return launch_v0<128, true, true, true, 128>(ARGS);
  if (tile_a == 64 && epi_threads == 256 && v == 7)
    return launch_v0<64, true, true, true, 256>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

// Blocks of the full variant's kernel at tile_a (128, or 64 for t64) on
// body 2 (wgmma) or 1 (mma.sync) resident on one SM (the occupancy
// calculator's count, after the shared-memory opt-in); a negative
// cudaError_t on failure
extern "C" int knn_fused_probe_blocks(int tile_a, int body) {
  if (body == 2 && tile_a == 128)
    return wg::blocks_per_sm<P2_FULL, kFused>();
  if (body == 2 && tile_a == 64) return wg::blocks_per_sm<P2_T64, kFused>();
  if (body == 1 && tile_a == 128)
    return tc::tile_blocks_per_sm<int8_t, kFused, 128, 128, 2>();
  if (body == 1 && tile_a == 64)
    return tc::tile_blocks_per_sm<int8_t, kFused, 64, 128, 2>();
  return -(int)cudaErrorInvalidValue;
}
