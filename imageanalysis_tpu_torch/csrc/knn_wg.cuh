// K1's and K3's body for rows of 256 values, for Hopper (sm_90a):
// warpgroup products (wgmma) fed by TMA, one warpgroup's key epilogue on
// the CUDA cores while the tensor cores run the other's products. One
// kernel over the operand type T:
// - D256<uint16_t>, bf16 rows (ORB's 256 bits as 0/1, or the int8 store's
//   rows cast to bf16): the bf16 body;
// - D256<Bf16x3>, f32 rows as three bf16 planes (hi, mid, lo; knn_tc.cuh's
//   head): the f32 body.
// Included by knn_tc.cuh, whose launch_tc sends both types here in every
// mode: K1 plain (kPacked) and gated (kPackedGated), K3 (kWide), and the
// product-only stage (kProductRowSum, the probes' split). The mma.sync
// bodies they replaced at these types (knn_tc_kernel<D256<uint16_t>> and
// <D256<Bf16x3>>) stay reachable from knn_probe.cu (knn_bf16_d256,
// knn_f32_d256) as their yardsticks.
//
// Replaces, for bf16 and f32 rows of 256 values:
//   imageanalysis_tpu/ops/knn.py:105 _knn_kernel_packed  (K1, every dot)
//   imageanalysis_tpu/ops/knn.py:407 _knn_kernel         (K3, every dot)
//
// What bounds it on the H100: the product, 2 n_a n_b 256 operations a
// pair at 989 TFLOP/s, six times over for f32 (bf16 64 x 6144^2: 1.251
// ms; 64 x 10240^2: 3.474 ms; f32 256 x 4096^2: 13.341 ms, 64 x 10240^2:
// 20.845 ms); the per-element key epilogue on the CUDA cores (d2, key,
// row top-2, column minimum: ~10 instructions a candidate for K1, ~15 and
// 64-bit column keys for K3), which at 256 values costs about as much as
// the bf16 product for K1 and more for K3, a sixth of that against f32's;
// and the L2 -> SM feed of B, which every block reads whole (bf16 64 x
// 6144 at BM = 256: 4.8 GB, 13.4 GB at 64 x 10240; f32 at BM = 64: 103
// GB at 256 x 4096, 161 GB at 64 x 10240, streamed at 5.1-5.4 TB/s). The
// mma.sync bodies held one block an SM whose product and epilogue took
// turns with nothing to fill the gaps, bf16 at 128 A rows and two 128-row
// B tiles, f32 (1552-byte padded rows) at 64 A rows and a single 64-row B
// tile whose copy did not overlap the product before it.
//
// Design (hopper.cuh's head has the layouts):
// - 384 threads: warpgroups 0 and 1 consume, warpgroup 2 produces (one
//   thread issues every copy); setmaxnreg moves the producer's registers
//   (40) to the consumers (232). One block an SM.
// - A resident: a block owns BM A rows of one pair. bf16: BM = 256,
//   consumer warpgroup w rows 128 w .. as two m64 halves, TMA-loaded once
//   as four 64-value chunks of 256 rows x 128 bytes (128 KB, 128-byte
//   swizzle). f32: BM = 64, both warpgroups on all of them (one m64 half);
//   the hi plane in registers (each thread's m16n8k16 A fragments of its
//   warp's 16 rows, 16 k-steps x 4 registers, loaded once from the split
//   rows in global memory), the mid and lo planes in shared memory as
//   bf16's A (64 KB). bf16's rows beyond n_a (n_a not a multiple of 256)
//   read as zeros (the TMA map is 3-D over pairs, rows, values) and are
//   left out of the keys (the epilogue is compiled for one half and for
//   two); a warpgroup with no row in the pair skips its epilogue.
// - B streamed: 64-row tiles, stages of four 64-value chunks of 64 rows x
//   128 bytes (32 KB) in a ring with full and empty mbarriers. bf16: a
//   ring of two, a stage a tile, both warpgroups on every tile. f32: a
//   ring of four, a stage a plane, a tile's planes in the order lo, mid,
//   hi (value 256 p + 64 c of the split rows); warpgroup w takes tiles w,
//   w + 2, .. (its warps alone empty their stages). Each tile's f32 norms
//   and gate positions go by bulk copy into a ring of four slots, counted
//   by the full barrier of the tile's first stage (a slot is rewritten
//   only after the epilogues of the tile four back, f32's by the same
//   warpgroup, which a ring of three would not hold: a stage is released
//   as soon as its products are done, before the epilogue that reads its
//   slot). ~206 KB (bf16), ~205 KB (f32) of shared memory.
// - Products: wgmma.m64n64k16 with f32 accumulators, scale-d off at a
//   sum's first k-step (no zero fill), 16 k-steps a plane. bf16: per tile
//   and warpgroup, 16 k-steps x 2 halves committed as one group and
//   waited for at once; ping-pong: warpgroup 0 issues tile t's products
//   once warpgroup 1 has issued t - 1's, warpgroup 1 once 0 has issued
//   t's (two named barriers), so the tensor cores take the two in turns
//   and each warpgroup's key epilogue runs under the other's products.
//   (Two accumulator sets in one warpgroup, tile t + 1's products in
//   flight under tile t's epilogue, were bf16's first design: ptxas
//   serialized its wgmma (C7518, a dependence in a divergent path) and
//   spilled at the setmaxnreg budget, 48-612 bytes. Without the two
//   barriers the warpgroups' products and epilogues fall into step, 2-10%
//   slower. Each B tile multicast by TMA to a cluster of two blocks along
//   M halves the L2 feed but couples the two blocks' rings: 15-21%
//   slower.) f32: the six plane products of order >= 2^-16, hi.hi into
//   one accumulator and the five smaller into a second, added once a tile
//   (knn_tc.cuh's head), in the order the B planes arrive: B lo: hi.lo; B
//   mid: hi.mid, mid.mid; B hi: hi.hi (the first accumulator), mid.hi,
//   lo.hi. The products of A's hi plane take it from registers (wgmma's
//   register-A form), the others from shared memory. A plane's products
//   are one commit group; a stage is released once its group is done
//   (wgmma_wait<1> after the next plane's issue). The warpgroups need no
//   barrier between them: the ring's order staggers them, one's key
//   epilogue under the other's products. The designs it was chosen over
//   (scripts_torch/knn_versions.py, PERF.md): BM = 128, both warpgroups on
//   every tile (a ring of two single-plane stages, ping-pong stage by
//   stage) halves the L2 feed but stalls the tensor cores, ~15% slower;
//   the lo plane in registers in place of hi (five products of six read A
//   from shared memory, whose 128 bytes a clock an SS m64n64k16 uses
//   whole) slower still.
// - Epilogue: the accumulator layout is mma.sync's m16n8 C fragment
//   repeated along N, so knn_tc.cuh's arithmetic carries over: a thread
//   holds 2 rows a half (rows g, g + 8 of its warp's 16) and 16 columns
//   (2q, 2q + 1 of 8 n8 tiles) of a tile, in straight-line code
//   (compiled for each number of valid halves: a branch inside it would
//   cut the columns into blocks the compiler cannot interleave). Row
//   top-2 in registers for the whole sweep, merged over the quad at the
//   end (each row lies in one warp: no merge across warps; f32's two
//   warpgroups, each over its tiles, then meet in shared memory). Each
//   column's minimum over the thread's rows, then over g by a transposed
//   reduction (column_minima), then the warpgroup's 4 warps' partials meet
//   in shared memory (a named barrier per warpgroup and tile, partials
//   double-buffered by the warpgroup's tile parity) and leave by one
//   global atomicMin per column and warpgroup, under its next tile's
//   products.
// - d2, keys and gate are knn_common.cuh's float body's, operation for
//   operation (__fadd_rn/__fmul_rn, no FMA contraction), in the same
//   order of columns and rows within a thread, so keys equal the plain
//   versions bit for bit on integer-valued rows (ORB's bits, the int8
//   store's -128..127: every product and partial sum an integer below
//   2^24; f32's mid and lo planes are then 0).

#pragma once

#include "hopper.cuh"

namespace knn {
namespace wg {

constexpr int kThreads = 384;       // two consumer warpgroups, a producer
constexpr int kBN = 64;             // B rows a tile
constexpr int kChunks = 4;          // 64-value (128-byte) chunks of a plane
constexpr int kSlots = 4;           // norm and gate slots: tile t in t % 4
constexpr int kBChunk = kBN * 128;  // bytes of one B chunk
constexpr int kConsumerWarps = 8;

// What the operand type decides: A rows a block; m64 halves a consumer
// warpgroup (bf16: two, each warpgroup its own rows; f32: one, both
// warpgroups on the block's rows, alternate B tiles); bf16 planes a row;
// A planes in shared memory; B stages in the ring; arrivals that empty a
// stage (the consumer warps that read it)
template <typename T>
struct Body;
template <>
struct Body<D256<uint16_t>> {
  static constexpr int kRows = 256, kHalves = 2, kPlanes = 1, kAPlanes = 1;
  static constexpr int kRing = 2, kEmpty = 8;
};
template <>
struct Body<D256<Bf16x3>> {       // hi in registers; mid, lo in smem
  static constexpr int kRows = 64, kHalves = 1, kPlanes = 3, kAPlanes = 2;
  static constexpr int kRing = 4, kEmpty = 4;
};
template <typename T>
constexpr int kBM = Body<T>::kRows;
template <typename T>
constexpr int kAChunk = kBM<T> * 128;         // bytes of one A chunk

template <typename T, int MODE>
struct Smem {
  unsigned char a[Body<T>::kAPlanes][kChunks][kAChunk<T>];  // 1024-aligned
  unsigned char b[Body<T>::kRing][kChunks][kBChunk];
  float nb2[kSlots][kBN];
  float pb[kSlots][kBN * 2];        // the gate's predicted positions
  float ua[kBM<T> * 2];             // the gate's A positions
  // column partials: [warpgroup][tile parity][warp][column]
  tc::Key<MODE> colpart[2][2][4][kBN];
  tc::Key<MODE> rowpart[64][2];     // f32: warpgroup 1's row top-2
  uint64_t full[Body<T>::kRing], empty[Body<T>::kRing], a_full;
};

template <typename T, int MODE>
constexpr int kSmem = (int)sizeof(Smem<T, MODE>) + 1024;  // + the alignment

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

// keeps the compiler from moving accumulators across wgmma's issue and
// wait
template <int H>
__device__ __forceinline__ void fence_acc(float (&acc)[H][32]) {
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) hopper::reg_fence(acc[h][i]);
}

// bf16: one tile's products into acc (2 m64 halves x 64 columns): A's
// rows of the warpgroup at sa, the B stage at sb
__device__ __forceinline__ void issue(float (&acc)[2][32],
                                      const unsigned char* sa,
                                      const unsigned char* sb) {
  using namespace hopper;
  constexpr int kA = kAChunk<D256<uint16_t>>;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_64(acc[h], desc_sw128(sa + c * kA + h * 64 * 128 + kk * 32),
                 desc_sw128(sb + c * kBChunk + kk * 32), (c | kk) != 0);
  wgmma_commit();
}

// f32: one plane product of a k-step into d, A's plane A (0 hi, 1 mid, 2
// lo) times B's plane P, each sum's first k-step (s == 0 of hi.hi and of
// hi.lo, the first that the small sum takes) with scale-d off; hi from
// registers (ah[s]), mid and lo from shared memory: da the descriptor of
// the warpgroup's rows of mid, a_off the k-step's byte offset in a plane,
// db B's
template <int A, int P>
__device__ __forceinline__ void product(float (&d)[32],
                                        const uint32_t (&ah)[16][4],
                                        uint64_t da, int a_off, uint64_t db,
                                        int s) {
  constexpr int kPlane = kChunks * kAChunk<D256<Bf16x3>>;  // smem plane
  const int scale = A == 0 && P != 1 ? s != 0 : 1;
  if constexpr (A == 0)
    hopper::wgmma_64_rs(d, ah[s], db, scale);
  else                              // the address field counts 16 bytes
    hopper::wgmma_64(d, da + (((A - 1) * kPlane + a_off) >> 4), db, scale);
}

// f32: the products of the B plane at stream position I of its tile (0:
// lo, 1: mid, 2: hi), one commit group: every A plane of order >= 2^-16
// against it (hi with each, mid with mid and hi, lo with hi), hi first,
// hi.hi into acc and the others into sm; ah the warpgroup's fragments of
// A's hi plane, sa its rows of A's mid plane in shared memory, sb the B
// stage. Each k-step's descriptors are the bases' plus a constant, the
// bases opaque to the compiler: it would otherwise hoist all 48 out of
// the sweep over B and spill them.
template <int I>
__device__ __forceinline__ void issue_f32(float (&acc)[1][32],
                                          float (&sm)[1][32],
                                          const uint32_t (&ah)[16][4],
                                          const unsigned char* sa,
                                          const unsigned char* sb) {
  using namespace hopper;
  constexpr int P = 2 - I;
  constexpr int kA = kAChunk<D256<Bf16x3>>;
  uint64_t da = desc_sw128(sa), db0 = desc_sw128(sb);
  asm volatile("" : "+l"(da), "+l"(db0));
  fence_acc(acc);
  fence_acc(sm);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int s = 4 * c + kk;
      const uint64_t db = db0 + ((c * kBChunk + kk * 32) >> 4);
      const int off = c * kA + kk * 32;
      if constexpr (P == 0)
        product<0, P>(acc[0], ah, da, off, db, s);
      else
        product<0, P>(sm[0], ah, da, off, db, s);
      if constexpr (P <= 1) product<1, P>(sm[0], ah, da, off, db, s);
      if constexpr (P == 0) product<2, P>(sm[0], ah, da, off, db, s);
    }
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
// row_p. ta, tb: encode_pairs maps of a and b with boxes of BM and BN
// rows; a32: f32's split A rows (n_pairs, n_a, 3, 256) bf16 as pairs of
// values, for its hi fragments (unused by bf16).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
knn_wg_kernel(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb,
              const uint32_t* __restrict__ a32,
              const float* __restrict__ na2, const float* __restrict__ nb2,
              const float* __restrict__ uv_a,
              const float* __restrict__ pred_b, float radius2,
              int* __restrict__ row_p, int* __restrict__ col_p,
              long long* __restrict__ row_k, long long* __restrict__ col_k,
              int n_a, int n_b) {
  using namespace hopper;
  using K = tc::Key<MODE>;
  constexpr bool kF32 = Body<T>::kPlanes == 3;
  constexpr int kHalves = Body<T>::kHalves;
  constexpr int kBMT = kBM<T>;
  constexpr int kAC = kAChunk<T>;
  constexpr bool kGated = MODE == kPackedGated;
  constexpr bool kSum = MODE == kProductRowSum;
  constexpr bool kNorms = normed(MODE);
  static_assert(MODE == kPacked || kGated || MODE == kWide || kSum,
                "K1, K3 or the product-only stage");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  Smem<T, MODE>& s = *reinterpret_cast<Smem<T, MODE>*>(
      smem_raw + (((base + 1023u) & ~1023u) - base));

  const int pair = blockIdx.y;
  const int a0 = blockIdx.x * kBMT;
  const int tid = threadIdx.x;
  const int n_tiles = n_b / kBN;
  constexpr int kRing = Body<T>::kRing;
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], Body<T>::kEmpty);   // lane 0 of each
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
    const int rows_a = min(kBMT, n_a - a0);
    mbar_expect_tx(&s.a_full, Body<T>::kAPlanes * kChunks * kAC +
                                  (kGated ? rows_a * 8 : 0));
    // bf16: its one plane; f32: mid and lo (planes 1 and 2)
#pragma unroll
    for (int p = 0; p < Body<T>::kAPlanes; ++p)
      for (int c = 0; c < kChunks; ++c)
        tma_load_3d(s.a[p][c], &ta, &s.a_full,
                    (kF32 ? 256 * (p + 1) : 0) + c * 64, a0, pair);
    if (kGated)
      bulk_load(s.ua, uv_a + ((size_t)pair * n_a + a0) * 2, rows_a * 8,
                &s.a_full);
    // stage u: tile u / P, its plane 2 - u % P for f32 (lo, mid, hi)
    const int n_stages = n_tiles * Body<T>::kPlanes;
    for (int u = 0, t = 0, i = 0; u < n_stages; ++u) {
      const int st = u % kRing;
      const bool first = i == 0;    // the tile's norms and gate travel here
      wait(&s.empty[st], ((u / kRing) & 1) ^ 1);
      mbar_expect_tx(&s.full[st],
                     kChunks * kBChunk +
                         (first ? (kNorms ? kBN * 4 : 0) +
                                      (kGated ? kBN * 8 : 0)
                                : 0));
      const int v0 = kF32 ? 256 * (2 - i) : 0;
      for (int c = 0; c < kChunks; ++c)
        tma_load_3d(s.b[st][c], &tb, &s.full[st], v0 + c * 64, t * kBN,
                    pair);
      if (first) {
        const size_t j = (size_t)pair * n_b + t * kBN;
        if (kNorms) bulk_load(s.nb2[t & 3], nb2 + j, kBN * 4, &s.full[st]);
        if (kGated)
          bulk_load(s.pb[t & 3], pred_b + 2 * j, kBN * 8, &s.full[st]);
      }
      if (++i == Body<T>::kPlanes) {
        i = 0;
        ++t;
      }
    }
    return;
  }

  regs_inc<232>();
  // bf16: rows wg * BM / 2 .. of the block; f32: tiles wg, wg + 2, ..
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int q = lane & 3;           // fragment column pair
  // the warpgroup's first row in the block: f32's two on the same rows
  constexpr int kWgRows = kF32 ? 0 : 64 * kHalves;
  const int r0 = a0 + wg * kWgRows + warp * 16 + g;   // (half 0, g)
  // halves of the warpgroup with rows in the pair (warpgroup-uniform;
  // f32 has one)
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    valid[h] = h < kHalves && a0 + wg * kWgRows + 64 * h < n_a;

  // the row top-2 of this thread's columns: K1's packed keys; K3's values
  // and indices (v1 <= v2), made into 64-bit keys at the end; the row sum
  // (in r1) of kProductRowSum
  float na[2][2], ux[2][2], uy[2][2];
  int r1[2][2], r2[2][2];
  float v1[2][2], v2[2][2];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + h * 64 + hh * 8;
      na[h][hh] = kNorms && valid[h] ? na2[(size_t)pair * n_a + row] : 0.f;
      r1[h][hh] = r2[h][hh] = kSum ? 0 : MODE == kWide ? -1 : kKeyMax;
      v1[h][hh] = v2[h][hh] = __int_as_float(0x7F800000);
    }
  // f32: the A fragments of the hi plane of rows r0, r0 + 8 (in the pair:
  // n_a is a multiple of BM = 64), k-step s at values 16 s + 2q, + 8
  uint32_t ah[16][4];
  if constexpr (kF32) {
    const uint32_t* p = a32 + ((size_t)pair * n_a + r0) * 384;
#pragma unroll
    for (int st = 0; st < 16; ++st)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        ah[st][r] = __ldg(p + (r & 1) * 8 * 384 + 8 * st + q + (r >> 1) * 4);
  }
  wait(&s.a_full, 0);
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wg * kWgRows + h * 64 + warp * 16 + hh * 8 + g;
      ux[h][hh] = kGated ? s.ua[2 * r] : 0.f;
      uy[h][hh] = kGated ? s.ua[2 * r + 1] : 0.f;
    }
  const unsigned char* sa = s.a[0][0] + wg * kWgRows * 128;

  // tile t's key epilogue on acc (its products complete) over the
  // warpgroup's first H halves (those with rows in the pair): H a
  // compile-time constant, so that the unrolled columns are one block of
  // straight-line code the compiler can interleave
  auto epilogue = [&](auto& acc, int t, auto halves,
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
      // each column over the warp's rows (the lanes of one q): every lane
      // ends with two adjacent columns' minima
      K k[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if constexpr (MODE == kWide)
          k[j] = wide_key(cv[j], ci[j]);
        else
          k[j] = ck[j];
      }
      const int j0 = column_minima(k, g);
      K* part = &s.colpart[wg][(kF32 ? t >> 1 : t) & 1][warp]
                           [(j0 >> 1) * 8 + 2 * q];
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
    const K* p = &s.colpart[wg][(kF32 ? t >> 1 : t) & 1][0][c];
    const K m = tc::kmin(tc::kmin(p[0], p[kBN]),
                         tc::kmin(p[2 * kBN], p[3 * kBN]));
    const size_t j = (size_t)pair * n_b + t * kBN + c;
    if constexpr (MODE == kWide)
      atomicMin(&col_k[j], m);
    else if constexpr (!kSum)
      atomicMin(&col_p[j], m);
  };

  // the tile's norms of this thread's 16 columns: bf16 reads them before
  // the products (the gate's positions, in 32 more registers, cost more
  // there than they save), f32 after them (its registers hold A's plane)
  auto norms = [&](float (&nbr)[16], int t) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 nb = kNorms ? *reinterpret_cast<const float2*>(
                                     &s.nb2[t & 3][nt * 8 + 2 * q])
                               : make_float2(0.f, 0.f);
      nbr[2 * nt] = nb.x;
      nbr[2 * nt + 1] = nb.y;
    }
  };

  // stage u is read: lane 0 of each consumer warp that read it
  auto release = [&](int u) {
    if (lane == 0) mbar_arrive(&s.empty[u % kRing]);
  };

  if constexpr (!kF32) {
    // ping-pong: warpgroup 0 issues tile t's products once warpgroup 1
    // has issued tile t - 1's (named barrier 1), warpgroup 1 once
    // warpgroup 0 has issued tile t's (barrier 2), so the tensor cores
    // take the two in turns while the other warpgroup runs its epilogue
    float acc[2][32];
    for (int t = 0; t < n_tiles; ++t) {
      wait(&s.full[t & 1], (t >> 1) & 1);
      float nbr[16];
      norms(nbr, t);
      if (wg == 1)
        bar_sync(2, 256);
      else if (t > 0)
        bar_sync(1, 256);
      issue(acc, sa, s.b[t & 1][0]);
      if (wg == 0)
        bar_arrive(2, 256);
      else if (t + 1 < n_tiles)
        bar_arrive(1, 256);
      if (t > 0) flush(t - 1);      // under this tile's products
      wgmma_wait<0>();
      fence_acc(acc);
      release(t);
      if (valid[1])
        epilogue(acc, t, std::integral_constant<int, 2>(), nbr);
      else if (valid[0])
        epilogue(acc, t, std::integral_constant<int, 1>(), nbr);
    }
  } else {
    // each warpgroup its own tiles, each tile's planes through the ring;
    // the stages' order staggers the two, so that one's key epilogue runs
    // under the other's products
    float acc[1][32], sm[1][32];
    for (int t = wg; t < n_tiles; t += 2) {
      float nbr[16];
      // stage u = 3t + I: tile t's B plane lo (I 0), mid (1), hi (2)
      auto plane = [&](auto pos) {
        constexpr int I = decltype(pos)::value;
        const int u = 3 * t + I;
        wait(&s.full[u % kRing], (u / kRing) & 1);
        issue_f32<I>(acc, sm, ah, sa, s.b[u % kRing][0]);
        if (I == 0 && t > 1) flush(t - 2);   // under this tile's products
        if (I > 0) {                // the stage before is read
          wgmma_wait<1>();
          release(u - 1);
        }
      };
      plane(std::integral_constant<int, 0>());
      plane(std::integral_constant<int, 1>());
      plane(std::integral_constant<int, 2>());
      wgmma_wait<0>();
      fence_acc(acc);
      fence_acc(sm);
      release(3 * t + 2);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[0][i] = __fadd_rn(acc[0][i], sm[0][i]);
      norms(nbr, t);
      epilogue(acc, t, std::integral_constant<int, 1>(), nbr);
    }
  }
  if constexpr (kF32) {             // the warpgroup's last tile's columns
    const int last = n_tiles - 1 - ((n_tiles - 1 - wg) & 1);
    if (last >= 0) flush(last);
  } else {
    flush(n_tiles - 1);
  }

  // row top-2 as keys (or row sums), merged over the quad's lanes; a row
  // lies in one warp
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
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
      if constexpr (kF32) {         // warpgroup 1 hands its keys over
        const int rr = warp * 16 + hh * 8 + g;
        if (wg == 1 && q == 0) {
          s.rowpart[rr][0] = k1;
          s.rowpart[rr][1] = k2;
        }
        bar_sync(5, 256);
        if (wg == 1) continue;
        if constexpr (kSum)
          k1 = tc::wrap_add(k1, s.rowpart[rr][0]);
        else
          tc::merge2(s.rowpart[rr][0], s.rowpart[rr][1], k1, k2);
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

// The body over T in MODE on a (n_pairs, n_a, 256) and b (n_pairs, n_b,
// 256) rows of T (bf16 bits; f32: the split pre-pass's (n_pairs, n, 3,
// 256) bf16 planes), 16-byte aligned, n_a and n_b multiples of 64; other
// arguments as knn_tc_kernel's. Returns the cudaError_t of the launch
// (that of the TMA maps' encoding where it fails).
template <typename T, int MODE>
int launch(const void* a, const void* b, const void* na2, const void* nb2,
           const void* uv_a, const void* pred_b, float radius2, void* row_p,
           void* col_p, void* row_k, void* col_k, int n_pairs, int n_a,
           int n_b, cudaStream_t stream) {
  constexpr int kK = 256 * Body<T>::kPlanes;   // bf16 values a row
  CUtensorMap ta, tb;
  int e = hopper::encode_pairs(&ta, a, n_pairs, n_a, kK, kBM<T>);
  if (e == 0) e = hopper::encode_pairs(&tb, b, n_pairs, n_b, kK, kBN);
  if (e != 0) return e;
  e = (int)cudaFuncSetAttribute(knn_wg_kernel<T, MODE>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmem<T, MODE>);
  if (e != 0) return e;
  dim3 grid((n_a + kBM<T> - 1) / kBM<T>, n_pairs);
  knn_wg_kernel<T, MODE><<<grid, kThreads, kSmem<T, MODE>, stream>>>(
      ta, tb, Body<T>::kPlanes == 3 ? (const uint32_t*)a : nullptr,
      (const float*)na2, (const float*)nb2, (const float*)uv_a,
      (const float*)pred_b, radius2, (int*)row_p, (int*)col_p,
      (long long*)row_k, (long long*)col_k, n_a, n_b);
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace knn
