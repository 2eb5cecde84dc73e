// K1's and K3's body for bf16 rows of 256 values (D256<uint16_t>: ORB's
// 256 bits as 0/1, or the int8 store's rows cast to bf16), for Hopper
// (sm_90a): warpgroup products (wgmma) fed by TMA, one warpgroup's key
// epilogue on the CUDA cores while the tensor cores run the other's
// products.
// Included by knn_tc.cuh, whose launch_tc sends D256<uint16_t> here in
// every mode: K1 plain (kPacked) and gated (kPackedGated), K3 (kWide), and
// the product-only stage (kProductRowSum, the probes' split). The
// mma.sync body it replaced at this type (knn_tc_kernel<D256<uint16_t>>)
// stays reachable from knn_probe.cu (knn_bf16_d256) as its yardstick.
//
// Replaces, for bf16 rows of 256 values:
//   imageanalysis_tpu/ops/knn.py:105 _knn_kernel_packed  (K1, every dot)
//   imageanalysis_tpu/ops/knn.py:407 _knn_kernel         (K3, every dot)
//
// What bounds it on the H100: the product, 2 n_a n_b 256 operations a
// pair at 989 TFLOP/s (64 x 6144^2: 1.251 ms; 64 x 10240^2: 3.474 ms);
// the per-element key epilogue on the CUDA cores (d2, key, row top-2,
// column minimum: ~10 instructions a candidate for K1, ~15 and 64-bit
// column keys for K3), which at 256 values costs about as much as the
// product for K1 and more for K3; and the L2 -> SM feed of B, which every
// block reads whole (64 x 6144 at BM = 256: 4.8 GB, 13.4 GB at 64 x
// 10240; the pipeline with no product and no epilogue streams it at ~5
// TB/s). The mma.sync body held 128 A rows and a ring of two 128-row B
// tiles of 528-byte rows, ~204 KB: one block an SM, whose product and
// epilogue took turns with nothing to fill the gaps (at 128 values two
// blocks shared an SM and overlapped them): K3 bf16 took 1.93x its
// 128-value time for 2x the product, K1 bf16 1.74x.
//
// Design (hopper.cuh's head has the layouts):
// - 384 threads: warpgroups 0 and 1 consume, warpgroup 2 produces (one
//   thread issues every copy); setmaxnreg moves the producer's registers
//   (40) to the consumers (232). One block an SM.
// - A resident: a block owns BM = 256 A rows of one pair, TMA-loaded once
//   as four 64-value chunks of 256 rows x 128 bytes (128 KB, 128-byte
//   swizzle); consumer warpgroup w owns rows 128 w .. 128 w + 127, as two
//   m64 halves. Rows beyond n_a (n_a not a multiple of 256) read as zeros
//   (the TMA map is 3-D over pairs, rows, values) and are left out of the
//   keys (the epilogue is compiled for one half and for two); a
//   warpgroup with no row in the pair skips its epilogue.
// - B streamed: tiles of BN = 64 rows, each four 64-value chunks of 64 rows
//   x 128 bytes (32 KB) in a ring of two stages with full and empty
//   mbarriers; each tile's f32 norms and gate positions go by bulk copy
//   into a ring of four slots, counted by the same full barrier (a slot is
//   rewritten only after both warpgroups' epilogues of the tile three back:
//   a stage is released as soon as its products are done, before the
//   epilogue that reads its slot). ~206 KB of shared memory.
// - Products: per tile and warpgroup, 16 k-steps x 2 halves of
//   wgmma.m64n64k16 (f32 accumulators, scale-d off at the tile's first
//   k-step: no zero fill), committed as one group and waited for at once.
//   Ping-pong: warpgroup 0 issues tile t's products once warpgroup 1 has
//   issued t - 1's, warpgroup 1 once 0 has issued t's (two named
//   barriers), so the tensor cores take the two in turns and each
//   warpgroup's key epilogue runs under the other's products. (Two
//   accumulator sets in one warpgroup, tile t + 1's products in flight
//   under tile t's epilogue, were the first design: ptxas serialized its
//   wgmma (C7518, a dependence in a divergent path) and spilled at the
//   setmaxnreg budget, 48-612 bytes. Without the two barriers the
//   warpgroups' products and epilogues fall into step, 2-10% slower. Each
//   B tile multicast by TMA to a cluster of two blocks along M halves the
//   L2 feed but couples the two blocks' rings: 15-21% slower.)
// - Epilogue: the accumulator layout is mma.sync's m16n8 C fragment
//   repeated along N, so knn_tc.cuh's arithmetic carries over: a thread
//   holds 4 rows (2 halves x rows g, g + 8 of its warp's 16) and 16
//   columns (2q, 2q + 1 of 8 n8 tiles) of a tile, in straight-line code
//   (compiled for each number of valid halves: a branch inside it would
//   cut the columns into blocks the compiler cannot interleave). Its
//   norms go into registers before the products are issued. Row top-2 in
//   registers for the whole sweep, merged over the quad at the end (each
//   row lies in one warp: no merge across warps). Each column's
//   minimum over the thread's rows, then over g by a transposed reduction
//   (column_minima), then the warpgroup's 4 warps' partials meet in shared
//   memory (a named barrier per warpgroup and tile, partials
//   double-buffered by tile parity) and leave by one global atomicMin per
//   column and warpgroup (as many as the mma.sync body's one per column
//   and 128-row block), under the next tile's products.
// - d2, keys and gate are knn_common.cuh's float body's, operation for
//   operation (__fadd_rn/__fmul_rn, no FMA contraction), in the same
//   order of columns and rows within a thread, so keys equal the plain
//   versions bit for bit on integer-valued rows (ORB's bits, the int8
//   store's -128..127: every product and partial sum an integer below
//   2^24).

#pragma once

#include "hopper.cuh"

namespace knn {
namespace wg {

constexpr int kThreads = 384;       // two consumer warpgroups, a producer
constexpr int kBM = 256;            // A rows a block, 128 a consumer
constexpr int kBN = 64;             // B rows a tile
constexpr int kChunks = 4;          // 64-value (128-byte) chunks of a row
constexpr int kStages = 2;          // B tiles in the ring
constexpr int kSlots = 4;           // norm and gate slots: tile t in t % 4
constexpr int kAChunk = kBM * 128;  // bytes of one A chunk
constexpr int kBChunk = kBN * 128;  // bytes of one B chunk
constexpr int kConsumerWarps = 8;

template <int MODE>
struct Smem {
  unsigned char a[kChunks][kAChunk];            // 1024-byte aligned
  unsigned char b[kStages][kChunks][kBChunk];
  float nb2[kSlots][kBN];
  float pb[kSlots][kBN * 2];        // the gate's predicted positions
  float ua[kBM * 2];                // the gate's A positions
  // column partials: [warpgroup][tile parity][warp][column]
  tc::Key<MODE> colpart[2][2][4][kBN];
  uint64_t full[kStages], empty[kStages], a_full;
};

template <int MODE>
constexpr int kSmem = (int)sizeof(Smem<MODE>) + 1024;   // + the alignment

// mbar_wait that traps (a launch failure the caller sees) where a phase
// never completes, instead of hanging the card: 2^28 polls are seconds,
// where a tile's copy takes microseconds
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = hopper::smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    if (n == (1u << 28)) __trap();
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// keeps the compiler from moving acc across wgmma's issue and wait
__device__ __forceinline__ void fence_acc(float (&acc)[2][32]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) hopper::reg_fence(acc[h][i]);
}

// one tile's products into acc (2 m64 halves x 64 columns): A's rows of
// the warpgroup at sa, the B stage at sb
__device__ __forceinline__ void issue(float (&acc)[2][32],
                                      const unsigned char* sa,
                                      const unsigned char* sb) {
  using namespace hopper;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_64(acc[h], desc_sw128(sa + c * kAChunk + h * 64 * 128 + kk * 32),
                 desc_sw128(sb + c * kBChunk + kk * 32), (c | kk) != 0);
  wgmma_commit();
}

// One exchange of column_minima: this thread keeps k[0..N) (up: k[N..2N))
// and sends the other half to the lane `off` away, whose kept half it is
template <int N, typename K>
__device__ __forceinline__ void keep_half(K (&k)[16], bool up, int off) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const K send = up ? k[i] : k[i + N];
    const K keep = up ? k[i + N] : k[i];
    k[i] = tc::kmin(keep, __shfl_xor_sync(0xffffffffu, send, off));
  }
}

// The column minima over a warp's 32 rows by a transposed reduction: k
// holds this thread's candidates for its 16 columns (j: column (j / 2) 8
// + 2q + j % 2); three exchanges with the lanes of its q (xor 4, 8, 16)
// each halve the columns a thread keeps, so that it ends with the minima
// of columns j0 and j0 + 1 in k[0], k[1], j0 = 8 b0 + 4 b1 + 2 b2 for the
// bits b of g; returns j0. 14 shuffles a thread where a butterfly over
// every column takes 48.
template <typename K>
__device__ __forceinline__ int column_minima(K (&k)[16], int g) {
  keep_half<8>(k, g & 1, 4);
  keep_half<4>(k, (g >> 1) & 1, 8);
  keep_half<2>(k, (g >> 2) & 1, 16);
  return (g & 1) * 8 + ((g >> 1) & 1) * 4 + ((g >> 2) & 1) * 2;
}

// One block: BM A rows (blockIdx.x) of one pair (blockIdx.y) against all
// n_b B rows. Outputs as knn_tc_kernel's: K1's row_p / col_p (col_p
// pre-filled with 0x7FFFFFFF), K3's row_k / col_k (pre-filled with
// INT64_MAX), or kProductRowSum's wrapping row sums in both slots of
// row_p. ta, tb: encode_pairs maps of a and b with boxes of BM and BN rows.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
knn_wg_kernel(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb,
              const float* __restrict__ na2, const float* __restrict__ nb2,
              const float* __restrict__ uv_a,
              const float* __restrict__ pred_b, float radius2,
              int* __restrict__ row_p, int* __restrict__ col_p,
              long long* __restrict__ row_k, long long* __restrict__ col_k,
              int n_a, int n_b) {
  using namespace hopper;
  using K = tc::Key<MODE>;
  constexpr bool kGated = MODE == kPackedGated;
  constexpr bool kSum = MODE == kProductRowSum;
  constexpr bool kNorms = normed(MODE);
  static_assert(MODE == kPacked || kGated || MODE == kWide || kSum,
                "K1, K3 or the product-only stage");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  Smem<MODE>& s = *reinterpret_cast<Smem<MODE>*>(
      smem_raw + (((base + 1023u) & ~1023u) - base));

  const int pair = blockIdx.y;
  const int a0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int n_tiles = n_b / kBN;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumerWarps);   // lane 0 of each
    }
    mbar_init(&s.a_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {                 // the producer warpgroup
    regs_dec<40>();
    if (tid != 256) return;
    tma_prefetch(&ta);
    tma_prefetch(&tb);
    const int rows_a = min(kBM, n_a - a0);
    mbar_expect_tx(&s.a_full,
                   kChunks * kAChunk + (kGated ? rows_a * 8 : 0));
    for (int c = 0; c < kChunks; ++c)
      tma_load_3d(s.a[c], &ta, &s.a_full, c * 64, a0, pair);
    if (kGated)
      bulk_load(s.ua, uv_a + ((size_t)pair * n_a + a0) * 2, rows_a * 8,
                &s.a_full);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t & 1;
      wait(&s.empty[st], ((t >> 1) & 1) ^ 1);
      mbar_expect_tx(&s.full[st], kChunks * kBChunk +
                                      (kNorms ? kBN * 4 : 0) +
                                      (kGated ? kBN * 8 : 0));
      for (int c = 0; c < kChunks; ++c)
        tma_load_3d(s.b[st][c], &tb, &s.full[st], c * 64, t * kBN, pair);
      const size_t j = (size_t)pair * n_b + t * kBN;
      if (kNorms) bulk_load(s.nb2[t & 3], nb2 + j, kBN * 4, &s.full[st]);
      if (kGated) bulk_load(s.pb[t & 3], pred_b + 2 * j, kBN * 8, &s.full[st]);
    }
    return;
  }

  regs_inc<232>();
  const int wg = tid >> 7;          // rows wg * 128 .. of the block
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int q = lane & 3;           // fragment column pair
  const int r0 = a0 + wg * 128 + warp * 16 + g;   // row of (half 0, g)
  // halves of the warpgroup with rows in the pair (warpgroup-uniform)
  const bool valid[2] = {a0 + wg * 128 < n_a, a0 + wg * 128 + 64 < n_a};

  // the row top-2 of this thread's columns: K1's packed keys; K3's values
  // and indices (v1 <= v2), made into 64-bit keys at the end; the row sum
  // (in r1) of kProductRowSum
  float na[2][2], ux[2][2], uy[2][2];
  int r1[2][2], r2[2][2];
  float v1[2][2], v2[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + h * 64 + hh * 8;
      na[h][hh] = kNorms && valid[h] ? na2[(size_t)pair * n_a + row] : 0.f;
      r1[h][hh] = r2[h][hh] = kSum ? 0 : MODE == kWide ? -1 : kKeyMax;
      v1[h][hh] = v2[h][hh] = __int_as_float(0x7F800000);
    }
  wait(&s.a_full, 0);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wg * 128 + h * 64 + warp * 16 + hh * 8 + g;
      ux[h][hh] = kGated ? s.ua[2 * r] : 0.f;
      uy[h][hh] = kGated ? s.ua[2 * r + 1] : 0.f;
    }
  const unsigned char* sa = s.a[0] + wg * 128 * 128;

  // tile t's key epilogue on acc (its products complete) over the
  // warpgroup's first H halves (those with rows in the pair): H a
  // compile-time constant, so that the unrolled columns are one block of
  // straight-line code the compiler can interleave
  auto epilogue = [&](float (&acc)[2][32], int t, auto halves,
                      const float (&nbr)[16]) {
    constexpr int H = decltype(halves)::value;
    const int b0 = t * kBN;
    const float* spb = s.pb[t & 3];
    // the thread's candidate for each of its 16 columns: K1's key, K3's
    // value and row
    int ck[16], ci[16];
    float cv[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      // d[i]: n8 tile i / 4, row g + 8 ((i / 2) % 2), column i % 2
      const int nt = j >> 1, e = j & 1;
      const int c = nt * 8 + 2 * q + e;
      const float nbv = nbr[j];
      const float px = kGated ? spb[2 * c] : 0.f;
      const float py = kGated ? spb[2 * c + 1] : 0.f;
      ck[j] = kKeyMax;
      cv[j] = __int_as_float(0x7F800000);
      ci[j] = -1;
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + h * 64 + hh * 8;
          const float dot = acc[h][nt * 4 + hh * 2 + e];
          if constexpr (kSum) {
            r1[h][hh] = tc::wrap_add(r1[h][hh], tc::dot_int(dot));
          } else if constexpr (MODE == kWide) {
            // (|a|^2 + |b|^2) - 2 a.b, as the reference and the plain
            // version; -0 → +0: equal values tie on index
            const float d2 = __fadd_rn(
                __fsub_rn(__fadd_rn(na[h][hh], nbv), __fmul_rn(2.f, dot)),
                0.f);
            // a thread meets its columns, and its rows, in increasing
            // index order, so a strict < on the value keeps the lowest
            // index among equal values: the 64-bit keys' order
            const bool p1 = d2 < v1[h][hh], p2 = d2 < v2[h][hh];
            v2[h][hh] = p1 ? v1[h][hh] : p2 ? d2 : v2[h][hh];
            r2[h][hh] = p1 ? r1[h][hh] : p2 ? b0 + c : r2[h][hh];
            v1[h][hh] = p1 ? d2 : v1[h][hh];
            r1[h][hh] = p1 ? b0 + c : r1[h][hh];
            const bool pc = d2 < cv[j];
            cv[j] = pc ? d2 : cv[j];
            ci[j] = pc ? row : ci[j];
          } else {
            const float d2 = __fsub_rn(__fadd_rn(na[h][hh], nbv),
                                       __fmul_rn(2.f, dot));
            int bits = __float_as_int(fmaxf(d2, 0.f)) & ~kIdxMask;
            if (kGated && gated_out(ux[h][hh], uy[h][hh], px, py, radius2))
              bits = kGatedBits;
            // insert2 on unique keys, as min/max
            const int rk = bits | (b0 + c);
            r2[h][hh] = min(r2[h][hh], max(r1[h][hh], rk));
            r1[h][hh] = min(r1[h][hh], rk);
            ck[j] = min(ck[j], bits | row);
          }
        }
    }
    if constexpr (!kSum) {
      // each column over the warp's 32 rows (the lanes of one q): every
      // lane ends with two adjacent columns' minima
      K k[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if constexpr (MODE == kWide)
          k[j] = wide_key(cv[j], ci[j]);
        else
          k[j] = ck[j];
      }
      const int j0 = column_minima(k, g);
      K* part = &s.colpart[wg][t & 1][warp][(j0 >> 1) * 8 + 2 * q];
      part[0] = k[0];
      part[1] = k[1];
      bar_sync(3 + wg, 128);        // the partials are in: flush(t)
    }
  };

  // tile t's column minima: the warpgroup's 4 warps' partials, then one
  // atomicMin a column
  auto flush = [&](int t) {
    const int c = tid & 127;
    if (kSum || !valid[0] || c >= kBN) return;
    const K* p = &s.colpart[wg][t & 1][0][c];
    const K m = tc::kmin(tc::kmin(p[0], p[kBN]),
                         tc::kmin(p[2 * kBN], p[3 * kBN]));
    const size_t j = (size_t)pair * n_b + t * kBN + c;
    if constexpr (MODE == kWide)
      atomicMin(&col_k[j], m);
    else if constexpr (!kSum)
      atomicMin(&col_p[j], m);
  };

  // ping-pong: warpgroup 0 issues tile t's products once warpgroup 1 has
  // issued tile t - 1's (named barrier 1), warpgroup 1 once warpgroup 0
  // has issued tile t's (barrier 2), so the tensor cores take the two in
  // turns while the other warpgroup runs its epilogue
  float acc[2][32];
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    wait(&s.full[st], (t >> 1) & 1);
    // the tile's norms of this thread's 16 columns, read before the
    // products (the gate's positions, in 32 more registers, cost more
    // there than they save)
    float nbr[16];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 nb = kNorms ? *reinterpret_cast<const float2*>(
                                     &s.nb2[t & 3][nt * 8 + 2 * q])
                               : make_float2(0.f, 0.f);
      nbr[2 * nt] = nb.x;
      nbr[2 * nt + 1] = nb.y;
    }
    if (wg == 1)
      bar_sync(2, 256);
    else if (t > 0)
      bar_sync(1, 256);
    issue(acc, sa, s.b[st][0]);
    if (wg == 0)
      bar_arrive(2, 256);
    else if (t + 1 < n_tiles)
      bar_arrive(1, 256);
    if (t > 0) flush(t - 1);        // under this tile's products
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&s.empty[st]);   // the stage is read
    if (valid[1])
      epilogue(acc, t, std::integral_constant<int, 2>(), nbr);
    else if (valid[0])
      epilogue(acc, t, std::integral_constant<int, 1>(), nbr);
  }
  flush(n_tiles - 1);

  // row top-2 as keys (or row sums), merged over the quad's lanes; a row
  // lies in one warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!valid[h]) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      K k1, k2;
      if constexpr (MODE == kWide) {  // -1: no candidate in this thread
        k1 = r1[h][hh] < 0 ? kWideMax : wide_key(v1[h][hh], r1[h][hh]);
        k2 = r2[h][hh] < 0 ? kWideMax : wide_key(v2[h][hh], r2[h][hh]);
      } else {
        k1 = r1[h][hh];
        k2 = r2[h][hh];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const K o1 = __shfl_xor_sync(0xffffffffu, k1, off);
        if constexpr (kSum) {
          k1 = tc::wrap_add(k1, o1);
        } else {
          const K o2 = __shfl_xor_sync(0xffffffffu, k2, off);
          tc::merge2(o1, o2, k1, k2);
        }
      }
      if (q == 0) {
        const size_t r = ((size_t)pair * n_a + r0 + h * 64 + hh * 8) * 2;
        if constexpr (MODE == kWide) {
          row_k[r] = k1;
          row_k[r + 1] = k2;
        } else {
          row_p[r] = k1;
          row_p[r + 1] = kSum ? k1 : k2;
        }
      }
    }
  }
}

// The body in MODE on a (n_pairs, n_a, 256) and b (n_pairs, n_b, 256) bf16
// bits, 16-byte aligned, n_a and n_b multiples of 64; other arguments as
// knn_tc_kernel's. Returns the cudaError_t of the launch (that of the TMA
// maps' encoding where it fails).
template <int MODE>
int launch(const void* a, const void* b, const void* na2, const void* nb2,
           const void* uv_a, const void* pred_b, float radius2, void* row_p,
           void* col_p, void* row_k, void* col_k, int n_pairs, int n_a,
           int n_b, cudaStream_t stream) {
  CUtensorMap ta, tb;
  int e = hopper::encode_pairs(&ta, a, n_pairs, n_a, 256, kBM);
  if (e == 0) e = hopper::encode_pairs(&tb, b, n_pairs, n_b, 256, kBN);
  if (e != 0) return e;
  e = (int)cudaFuncSetAttribute(knn_wg_kernel<MODE>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmem<MODE>);
  if (e != 0) return e;
  dim3 grid((n_a + kBM - 1) / kBM, n_pairs);
  knn_wg_kernel<MODE><<<grid, kThreads, kSmem<MODE>, stream>>>(
      ta, tb, (const float*)na2, (const float*)nb2, (const float*)uv_a,
      (const float*)pred_b, radius2, (int*)row_p, (int*)col_p,
      (long long*)row_k, (long long*)col_k, n_a, n_b);
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace knn
