// K1's and K3's body on the tensor cores for Hopper (sm_90a): warpgroup
// products (wgmma) fed by TMA, one warpgroup's key epilogue on the CUDA
// cores while the tensor cores run another's products. One kernel over
// the operand type T:
// - uint16_t and int8_t, bf16 and int8 rows of 128 values (SIFT's: the
//   int8 store's -128..127, bf16 for the store's uint8 and float32 modes,
//   the chunked float path and every store beyond 8192 rows): K1, and K3
//   in bf16;
// - Bf16x3, f32 rows of 128 as three bf16 planes (hi, mid, lo;
//   knn_tc.cuh's head): K1 and K3;
// - D256<uint16_t>, bf16 rows of 256 values (ORB's 256 bits as 0/1, or
//   the int8 store's rows cast to bf16): the bf16 body;
// - D256<int8_t>, int8 rows of 256 (ORB's bits as the int8 store holds
//   them, -128/-127, or any -128..127): the bf16 body's layout at half the
//   bytes, wgmma s8 with exact s32 sums (K1 only);
// - D256<Bf16x3>, f32 rows of 256 as three bf16 planes: the f32 body.
// Included by knn_tc.cuh, whose launch_tc sends these types here: K1 plain
// (kPacked) and gated (kPackedGated), K3 (kWide; bf16 and f32), and the
// product-only stage (kProductRowSum, the probes' split): every 2-NN row.
// - Tile<T, ROWS, BN, RING, CONSUMERS>, bf16 or int8 rows of 128 at a
//   probe's tile: P6's product + row minimum (kProductRowMin) over B tiles
//   of 64, 128 or 256 rows (knn_probe.cu's knn_wg_row_min), and P2's K1 +
//   K4 in one launch (kFused and its flags, int8, knn_fused_probe.cu):
//   K1 int8's body with the pb gather where a row's keys leave the block
//   and K4's epilogue on the pair's last block (fused_tail).
// The mma.sync bodies replaced here (knn_tc_kernel<uint16_t>, <int8_t>,
// <Bf16x3>, <D256<uint16_t>>, <D256<int8_t>> and <D256<Bf16x3>>) stay
// reachable from knn_probe.cu (knn_bf16_d128, knn_i8_d128, knn_f32_d128,
// knn_bf16_d256, knn_i8_d256, knn_f32_d256) as their yardsticks.
//
// Replaces, for bf16, int8 and f32 rows of 128 and of 256 values:
//   imageanalysis_tpu/ops/knn.py:105 _knn_kernel_packed  (K1, every dot)
//   imageanalysis_tpu/ops/knn.py:407 _knn_kernel         (K3)
// and on its probe tiles:
//   scripts_dev/knn_overhead_sweep.py:36 kernel          (P6, row min)
//   scripts_dev/fused_vmem_probe.py:26 kern              (P2, K1 + K4)
//
// What bounds it on the H100: the product, 2 n_a n_b D operations a pair
// at 989 TFLOP/s (bf16; 1,979 TOP/s int8; six times over for f32: bf16
// 64 x 6144^2 at 256 values 1.251 ms, at 128 0.625 ms; int8 at 128 0.313
// ms); the per-element key epilogue on the CUDA cores (d2, key, row top-2,
// column minimum: ~9 instructions a candidate for K1, ~15 and 64-bit
// column keys for K3), which does the same work at either width: at 64 x
// 6144 its 2.42e9 candidates take 0.72 ms at the full issue rate, more
// than twice int8's product at 128, and its integer-pipe operations (16
// lanes a scheduler) bound it before the issue rate does; and the L2 -> SM
// feed of B, which every block reads whole (bf16 64 x 6144 at BM = 256:
// 4.8 GB at 256 values, 13.4 GB at 64 x 10240; f32 at BM = 64: 103 GB at
// 256 x 4096, 161 GB at 64 x 10240, streamed at 5.1-5.4 TB/s; at 128
// values and 64 x 10240 80.5 GB at BM = 64, 40 GB at BM = 128). The
// mma.sync bodies held one or two blocks an SM whose product and epilogue
// took turns with nothing to fill the gaps. K3's epilogue (value and index
// of the row's top-2 and of the column's minimum, ~9 compares and selects
// a candidate, the 64-bit column keys' exchanges besides) takes the
// integer pipe's 16 lanes a scheduler: at 128 values it, not the product,
// bounds K3 bf16.
//
// Design (hopper.cuh's head has the layouts):
// - Consumer warpgroups (two; int8 at 128: three) and a producer
//   warpgroup (one thread issues every copy); setmaxnreg moves the
//   producer's registers (40) to the consumers (232; three: 152). One block
//   an SM.
// - A resident: a block owns BM A rows of one pair, TMA-loaded once in
//   64-value chunks of BM rows x 128 bytes (boxes of up to 256 rows;
//   128-byte swizzle). bf16 and int8: BM = 128 a consumer warpgroup (two
//   m64 halves each): bf16 256 rows (at 256 values four chunks, 128 KB; at
//   128 two, 64 KB), int8 at 256 256 rows as two 128-value chunks (64 KB),
//   int8 at 128 384 rows as one (48 KB). f32 (one m64 half a warpgroup):
//   at 256 values, and at 128 in K1's modes, BM = 64, both warpgroups on
//   all of them; K3 and the product-only stage at 128 BM = 128, each
//   warpgroup its own 64 (Body<Bf16x3, MODE>). The hi plane in registers (each
//   thread's m16n8k16 A fragments of its warp's 16 rows, 16 k-steps x 4
//   registers at 256 values, 8 at 128, loaded once from the split rows in
//   global memory), the mid and lo planes in shared memory as bf16's A (64
//   KB). Rows beyond n_a (n_a not a multiple of BM) read as zeros (the TMA
//   map is 3-D over pairs, rows, values) and are left out of the keys (the
//   epilogue is compiled for one half and for two); a warpgroup with no
//   row in the pair skips its epilogue.
// - B streamed: 64-row tiles, stages of 64-value chunks of 64 rows x 128
//   bytes (bf16 32 KB at 256 values, 16 KB at 128; int8 16 KB at 256, 8
//   KB at 128) in a ring with full and empty mbarriers. bf16 and int8: a
//   ring of two, a stage a tile, every consumer warpgroup on every tile.
//   f32: a stage a plane, a tile's planes in the order lo, mid, hi (value
//   dim p + 64 c of the split rows); at BM = 64 a ring of four,
//   warpgroup w takes tiles w, w + 2, .. (its warps alone empty their
//   stages); at BM = 128 a ring of six, both on every tile. Each tile's
//   f32 norms and gate positions go by bulk copy into a ring of slots,
//   counted by the full barrier of the tile's first stage (kSlots: a slot
//   is rewritten only after the epilogues of the tile four back, f32's by
//   the same warpgroup, which a ring of three would not hold: a stage is
//   released as soon as its products are done, before the epilogue that
//   reads its slot; bf16 and int8 rewrite tile t's slot for tile t + 4,
//   once every warpgroup has released tile t + 2, after its epilogue of
//   t; f32 at BM = 128 likewise, tile t + 2's lo plane being stage 3 t +
//   6, which each warpgroup releases after its epilogue of t + 1; the
//   gate's positions share the norms' slot and barrier).
//   ~206 KB (bf16 at 256), ~106 KB (int8 at 256), ~205 KB (f32 at 256),
//   ~100 KB (bf16 at 128; K3 ~108), ~70 KB (int8 at 128), ~174 KB (f32 at
//   128, BM = 128), ~109 KB (K1 f32 at 128, BM = 64) of shared memory.
// - Products: wgmma.m64n64k16 with f32 accumulators (int8: m64n64k32 with
//   s32 accumulators in the same layout), scale-d off at a sum's first
//   k-step (no zero fill), 16 k-steps a plane at 256 values (int8: 8), 8
//   at 128 (int8: 4). bf16 and int8: per tile and warpgroup, its k-steps x
//   2 halves committed as one group and waited for at once; ping-pong:
//   warpgroup 0 issues tile t's products once the last warpgroup has
//   issued t - 1's, warpgroup w > 0 once w - 1 has issued t's (a named
//   barrier each), so the tensor cores take the warpgroups in turns and
//   each one's key epilogue runs under the others' products. (Two
//   accumulator sets in one warpgroup, tile t + 1's products in flight
//   under tile t's epilogue, were bf16's first design: ptxas serialized its
//   wgmma (C7518, a dependence in a divergent path) and spilled at the
//   setmaxnreg budget, 48-612 bytes. Without the barriers the warpgroups'
//   products and epilogues fall into step, 2-10% slower. Each B tile
//   multicast by TMA to a cluster of two blocks along M halves the L2 feed
//   but couples the two blocks' rings: 15-21% slower.) f32: the six plane
//   products of order >= 2^-16, hi.hi into one accumulator and the five
//   smaller into a second, added once a tile (knn_tc.cuh's head), in the
//   order the B planes arrive: B lo: hi.lo; B mid: hi.mid, mid.mid; B hi:
//   hi.hi (the first accumulator), mid.hi, lo.hi. The products of A's hi
//   plane take it from registers (wgmma's register-A form), the others
//   from shared memory. A plane's products are one commit group; a stage
//   is released once its group is done (wgmma_wait<1> after the next
//   plane's issue). At 256 values the warpgroups need no barrier between
//   them: the ring's order staggers them, one's key epilogue under the
//   other's products. The designs it was chosen over there
//   (scripts_torch/knn_versions.py, PERF.md): BM = 128, both warpgroups on
//   every tile (a ring of two single-plane stages, ping-pong stage by
//   stage) halves the L2 feed but stalls the tensor cores, ~15% slower;
//   the lo plane in registers in place of hi (five products of six read A
//   from shared memory, whose 128 bytes a clock an SS m64n64k16 uses
//   whole) slower still. At 128 values (half the hi registers, half the
//   k-steps) the faster structure depends on the mode, in turns: K3 (n_b
//   beyond 8192) at BM = 128 with a ring of six, the warpgroups in
//   ping-pong as bf16's, each issuing a tile's three planes in turn, 2-3%
//   faster than the 256 structure (the L2 feed does not bound it at 128);
//   K1 (n_b at most 8192, 64 tiles a block at 4096) the other way, the
//   256 structure faster (PERF.md: plain 1-2%, gated ~5%; the gate's
//   longer epilogue runs freely beside the other warpgroup's products
//   where the ping-pong's barriers hold it), and three consumer
//   warpgroups of 64 rows (192 A rows, 152 registers) spill in the gated
//   mode and are slower still.
// - Epilogue: the accumulator layout is mma.sync's m16n8 C fragment
//   repeated along N, so knn_tc.cuh's arithmetic carries over: a thread
//   holds 2 rows a half (rows g, g + 8 of its warp's 16) and 16 columns
//   (2q, 2q + 1 of 8 n8 tiles) of a tile, in straight-line code (compiled
//   for each number of valid halves: a branch inside it would cut the
//   columns into blocks the compiler cannot interleave). Row top-2 in
//   registers for the whole sweep, K1's as two partial top-2s over
//   alternate n8 tiles (the min/max chain of the top-2 is the epilogue's
//   longest dependence), merged over the quad at the end (each row lies in
//   one warp: no merge across warps; f32's two warpgroups, each over its
//   tiles, then meet in shared memory). Each column's minimum over the
//   thread's rows, then over g by a transposed reduction (column_minima),
//   then the warpgroup's 4 warps' partials meet in shared memory (a named
//   barrier per warpgroup and tile, partials double-buffered by the
//   warpgroup's tile parity) and leave by one global atomicMin per column
//   and warpgroup, under its next tile's products. K3 keeps f32 values and
//   int indices, d2 by one FFMA (2 a.b exact), a strict < keeping the
//   lowest index (a thread meets its candidates in index order), and makes
//   64-bit keys only for the exchanges; bf16's K3 takes a thread's 16
//   columns in two passes of 8 (the same exchanges, fewer live keys).
// - Keys are the plain versions' bit for bit on integer-valued rows (ORB's
//   bits, the int8 store's -128..127: every product and partial sum an
//   integer below 2^24; f32's mid and lo planes are then 0). The float
//   types' d2 is knn_common.cuh's float body's, (na + nb) - 2 dot rounded
//   once (2 dot is exact, so one FFMA), and its gate operation for
//   operation (__fadd_rn/__fmul_rn, no FMA contraction). int8 at 256 is
//   knn_tc.cuh's int8 arithmetic: the s32 dot (|dot| <= 256 x 128^2 =
//   2^22) made f32 by the 1.5 x 2^23 trick, then (na - 2 dot) + nb, each
//   step an integer below 2^24, exact. int8 at 128 takes two operations
//   (kD2Mad): each value's a^2 - 2ab lies in [-2^14, 48896], so 2^21 + na -
//   2 dot lies in [0, 8355840], below 2^23; one IMAD writes it into the
//   mantissa of 2^23 (the f32 2^23 + 2^21 + na - 2 dot, exactly) and one
//   FADD adds nb - 2^23 - 2^21, which the norm pre-pass wrote (kNbBias):
//   the exact d2 <= 128 x 255^2 < 2^23, an f32. A candidate's two keys come
//   from one mask by two IMADs ((bits & ~mask) + index, with a multiplier 1
//   ptxas cannot see), which run on the FMA pipe where LOP3s would take
//   the integer pipe's slots, which the top-2's and the column's min/max
//   already fill.
//
// The key epilogue bounds the body wherever the product is small (int8 at
// either width, bf16 at 128): it does the same work at either width. The
// designs it was chosen over (scripts_torch/knn_versions.py --i8-d256 and
// --d128, in turns; PERF.md): at 256, int8 on bf16's structure as it was
// (13-15% slower), with a ring of four B stages (the same), without the
// ping-pong barriers (slower still), with four partial top-2s a row (5%
// slower than two); the keys as one LOP3 each, (bits & ~mask) | index
// (int8 3-8% slower; bf16, with its d2's separate FMUL, 8-13%). At 128:
// the 256 body's epilogue as it was (int8 4-16% slower, bf16 11-18%);
// the keys by LOP3 (int8 the same, bf16 10-23% slower); a ring of four
// (the same);
// int8 with two consumer warpgroups of 256 rows (12-23% slower than
// three: at 128 values a tile's products are short, and three give each
// scheduler three warps to issue from); bf16 with three (within the
// spread); BM = 128 with two blocks an SM (a launch failure, left
// undiagnosed: the two blocks' setmaxnreg hand-over is the suspect).
// K3 at 128 (scripts_torch/knn_variants.py, knn_versions.py --k3-d128, in
// turns; PERF.md): the 256 epilogue as it was (d2 by FADD, FMUL, FSUB and
// a -0 fix-up, one pass) 5-6% slower for bf16, 3% for f32; the row's and
// column's moves as predicated FFMAs and IMADs (ptxas turns them back
// into FSEL and SEL), K1's two partial top-2 chains and one pass over
// the columns no faster; each (value, index) as one 64-bit key compared as a
// double (DSETP, but its 64-bit selects become FSEL pairs) 17-22% slower;
// three consumer warpgroups (152 registers) spill: bf16 no faster, f32 24%
// slower.

#pragma once

#include "hopper.cuh"

namespace knn {
namespace wg {

constexpr int kBN = 64;             // B rows a tile (a Tile: its BN)
constexpr int kSlots = 4;           // norm and gate slots: tile t in t % 4

// A probe's tile of the body at 128 values a row (P6's sweep, WG_TILES;
// P2's t64): bf16 (uint16_t) or int8 rows, ROWS A rows a block on
// CONSUMERS consumer warpgroups, ROWS / 64 / CONSUMERS m64 halves each
// (one or two), B tiles of BN rows (64, 128 or 256: wgmma m64nBN) in a
// ring of RING stages. Its own operand type, so that no production
// instantiation changes its name or its code.
template <typename T, int ROWS, int BN, int RING, int CONSUMERS>
struct Tile {};
// the row type of an operand type: T of a Tile
template <typename T>
struct Operand {
  using type = T;
};
template <typename T, int R, int N, int G, int C>
struct Operand<Tile<T, R, N, G, C>> {
  using type = T;
};

// What the operand type (f32 at 128 values: and the mode) decides: the
// accumulator type; A rows a block; m64 halves a consumer warpgroup (bf16
// and int8: two, each warpgroup its own rows; f32: one); planes a row;
// 128-byte chunks of a plane's row (bf16: 64 values; int8: 128); A planes
// in shared memory; B stages in the ring; arrivals that empty a stage (the
// consumer warps that read it); consumer warpgroups
template <typename T, int MODE>
struct Body;
template <int MODE>
struct Body<uint16_t, MODE> {       // bf16 at 128 values a row
  using Acc = float;
  static constexpr int kRows = 256, kHalves = 2, kPlanes = 1, kAPlanes = 1;
  static constexpr int kChunks = 2, kRing = 2, kEmpty = 8, kConsumers = 2;
};
template <int MODE>
struct Body<int8_t, MODE> {         // int8 at 128: one 128-byte chunk,
  using Acc = int;                  // three consumer warpgroups
  static constexpr int kRows = 384, kHalves = 2, kPlanes = 1, kAPlanes = 1;
  static constexpr int kChunks = 1, kRing = 2, kEmpty = 12, kConsumers = 3;
};
template <int MODE>
struct Body<D256<uint16_t>, MODE> {
  using Acc = float;
  static constexpr int kRows = 256, kHalves = 2, kPlanes = 1, kAPlanes = 1;
  static constexpr int kChunks = 4, kRing = 2, kEmpty = 8, kConsumers = 2;
};
template <int MODE>
struct Body<D256<int8_t>, MODE> {
  using Acc = int;
  static constexpr int kRows = 256, kHalves = 2, kPlanes = 1, kAPlanes = 1;
  static constexpr int kChunks = 2, kRing = 2, kEmpty = 8, kConsumers = 2;
};
template <int MODE>
struct Body<D256<Bf16x3>, MODE> {   // hi in registers; mid, lo in smem
  using Acc = float;
  static constexpr int kRows = 64, kHalves = 1, kPlanes = 3, kAPlanes = 2;
  static constexpr int kChunks = 4, kRing = 4, kEmpty = 4, kConsumers = 2;
};
// f32 at 128 values a row: K1's modes (kPacked, kPackedGated; n_b <= 8192)
// on the 256 body's structure, 64 A rows a block, the warpgroups on
// alternate B tiles; K3 (kWide; n_b beyond 8192) and the product-only
// stage on 128 A rows, each warpgroup its own 64, in ping-pong (the head:
// each the faster at its mode's shapes)
struct F32Rows64 {
  using Acc = float;
  static constexpr int kRows = 64, kHalves = 1, kPlanes = 3, kAPlanes = 2;
  static constexpr int kChunks = 2, kRing = 4, kEmpty = 4, kConsumers = 2;
};
struct F32Rows128 {
  using Acc = float;
  static constexpr int kRows = 128, kHalves = 1, kPlanes = 3, kAPlanes = 2;
  static constexpr int kChunks = 2, kRing = 6, kEmpty = 8, kConsumers = 2;
};
template <int MODE>
struct Body<Bf16x3, MODE>
    : std::conditional_t<MODE == kPacked || MODE == kPackedGated, F32Rows64,
                         F32Rows128> {};
template <typename T, int ROWS, int BN, int RING, int C, int MODE>
struct Body<Tile<T, ROWS, BN, RING, C>, MODE> {
  static constexpr bool kI8 = std::is_same<T, int8_t>::value;
  using Acc = std::conditional_t<kI8, int, float>;
  static constexpr int kRows = ROWS, kHalves = ROWS / 64 / C, kPlanes = 1;
  static constexpr int kAPlanes = 1, kChunks = kI8 ? 1 : 2, kRing = RING;
  static constexpr int kEmpty = 4 * C, kConsumers = C, kN = BN;
  static_assert((kI8 || std::is_same<T, uint16_t>::value) &&
                    (kHalves == 1 || kHalves == 2) &&
                    ROWS == 64 * kHalves * C && (C == 2 || C == 3) &&
                    (BN == 64 || BN == 128 || BN == 256),
                "bf16 or int8, one or two m64 halves a warpgroup, B tiles "
                "of 64, 128 or 256 rows");
};
// B rows a tile of a Body: kBN, or a Tile's BN
template <typename B, typename = void>
struct TileN {
  static constexpr int value = kBN;
};
template <typename B>
struct TileN<B, std::void_t<decltype(B::kN)>> {
  static constexpr int value = B::kN;
};
template <typename B>
constexpr int kBChunk = TileN<B>::value * 128;   // bytes of one B chunk
// f32 with 64 A rows a block: both warpgroups on the block's rows, each
// on alternate B tiles (at 128 A rows, each its own 64 rows, both on
// every tile); B below is a Body
template <typename B>
constexpr bool kAltTiles = B::kPlanes == 3 && B::kRows == 64;
// K3's key epilogue (kWide): bf16's 16 columns a thread in kWidePasses
// passes of 16 / kWidePasses (the head: 2-3% faster than one pass)
constexpr int kWidePasses = 2;
// int8 at 128 values a row takes d2 in two operations, an IMAD and an
// FADD, from B norms that the pre-pass writes less kNbBias (the head)
template <typename T>
constexpr bool kD2Mad =
    std::is_same<typename Operand<T>::type, int8_t>::value;
constexpr float kNbBias = -10485760.f;    // -(2^23 + 2^21)
// what K1's int8 pre-pass adds to the B norms for the body over T
template <typename T>
constexpr float nb_bias() { return kD2Mad<T> ? kNbBias : 0.f; }
template <typename B>
constexpr int kBM = B::kRows;
// threads a block: the consumer warpgroups and a producer warpgroup
template <typename B>
constexpr int kThreads = 128 * (B::kConsumers + 1);
// A rows a TMA box (at most 256), the box loaded kBM / kABox times
template <typename B>
constexpr int kABox = kBM<B> <= 256 ? kBM<B> : 128;
// a consumer thread's registers after setmaxnreg: the SM's 65,536 less
// the producer warpgroup's 40 a thread, over the consumers, in multiples
// of 8 (two consumer warpgroups: 232; three: 152)
template <typename B>
constexpr int kConsumerRegs =
    (65536 - 40 * 128) / (128 * B::kConsumers) / 8 * 8;
template <typename B>
constexpr int kAChunk = kBM<B> * 128;         // bytes of one A chunk

template <typename T, int MODE>
struct Smem {
  using B = Body<T, MODE>;
  static_assert(kAltTiles<B> ? B::kRing == 4 : B::kRing <= B::kPlanes * 3,
                "four norm slots hold the ring (the head)");
  static constexpr int kC = B::kChunks;
  static constexpr int kN = TileN<B>::value;
  unsigned char a[B::kAPlanes][kC][kAChunk<B>];  // 1024-aligned
  unsigned char b[B::kRing][kC][kBChunk<B>];
  float nb2[kSlots][kN];
  float pb[kSlots][kN * 2];         // the gate's predicted positions
  float ua[kBM<B> * 2];             // the gate's A positions
  // column partials: [warpgroup][tile parity][warp][column]
  tc::Key<MODE> colpart[B::kConsumers][2][4][kN];
  tc::Key<MODE> rowpart[64][2];     // f32: warpgroup 1's row top-2
  uint64_t full[B::kRing], empty[B::kRing], a_full;
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
template <typename A, int H, int N>
__device__ __forceinline__ void fence_acc(A (&acc)[H][N]) {
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < N; ++i) hopper::reg_fence(acc[h][i]);
}

// one 32-byte k-step of the operand type: bf16 m64nNk16 into f32, int8
// m64nNk32 into s32, N 64 (a Tile's B: also 128 and 256)
__device__ __forceinline__ void product64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  hopper::wgmma_64(d, da, db, scale_d);
}
__device__ __forceinline__ void product64(int (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  hopper::wgmma_64_s8(d, da, db, scale_d);
}
__device__ __forceinline__ void product64(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  hopper::wgmma_128(d, da, db, scale_d);
}
__device__ __forceinline__ void product64(int (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  hopper::wgmma_128_s8(d, da, db, scale_d);
}
__device__ __forceinline__ void product64(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  hopper::wgmma_256(d, da, db, scale_d);
}
__device__ __forceinline__ void product64(int (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  hopper::wgmma_256_s8(d, da, db, scale_d);
}

// bf16 and int8: one tile's products into acc (kHalves m64 halves x BN
// columns): A's rows of the warpgroup at sa, the B stage at sb; four
// 32-byte k-steps a 128-byte chunk
template <typename B>
__device__ __forceinline__ void issue(
    typename B::Acc (&acc)[B::kHalves][TileN<B>::value / 2],
    const unsigned char* sa, const unsigned char* sb) {
  using namespace hopper;
  constexpr int kA = kAChunk<B>;
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < B::kChunks; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < B::kHalves; ++h)
        product64(acc[h], desc_sw128(sa + c * kA + h * 64 * 128 + kk * 32),
                  desc_sw128(sb + c * kBChunk<B> + kk * 32),
                  (c | kk) != 0);
  wgmma_commit();
}

// f32: one plane product of a k-step into d, A's plane A (0 hi, 1 mid, 2
// lo) times B's plane P, each sum's first k-step (s == 0 of hi.hi and of
// hi.lo, the first that the small sum takes) with scale-d off; hi from
// registers (ah[s]), mid and lo from shared memory: da the descriptor of
// the warpgroup's rows of mid, a_off the k-step's byte offset in a plane,
// db B's
template <typename B, int A, int P>
__device__ __forceinline__ void product(float (&d)[32],
                                        const uint32_t (&ah)[16][4],
                                        uint64_t da, int a_off, uint64_t db,
                                        int s) {
  constexpr int kPlane = B::kChunks * kAChunk<B>;  // bytes in smem
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
// bases opaque to the compiler: it would otherwise hoist all 48 (at 128
// values: 24) out of the sweep over B and spill them.
template <typename B, int I>
__device__ __forceinline__ void issue_f32(float (&acc)[1][32],
                                          float (&sm)[1][32],
                                          const uint32_t (&ah)[16][4],
                                          const unsigned char* sa,
                                          const unsigned char* sb) {
  using namespace hopper;
  constexpr int P = 2 - I;
  constexpr int kA = kAChunk<B>;
  constexpr int kChunks = B::kChunks;
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
      const uint64_t db = db0 + ((c * kBChunk<B> + kk * 32) >> 4);
      const int off = c * kA + kk * 32;
      if constexpr (P == 0)
        product<B, 0, P>(acc[0], ah, da, off, db, s);
      else
        product<B, 0, P>(sm[0], ah, da, off, db, s);
      if constexpr (P <= 1) product<B, 1, P>(sm[0], ah, da, off, db, s);
      if constexpr (P == 0) product<B, 2, P>(sm[0], ah, da, off, db, s);
    }
  wgmma_commit();
}

// a * b + c, an IMAD (the FMA pipe) that ptxas cannot turn into an add
// on the integer pipe where b is opaque (the keys' b, 1, is read from
// %nctaid.z; launch holds the grid's z dimension at 1)
__device__ __forceinline__ int mad_s32(int a, int b, int c) {
  int d;
  asm("mad.lo.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
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
// holds this thread's candidates for N of its columns (N 16: j is column
// (j / 2) 8 + 2q + j % 2; N 8 likewise, half of them); three exchanges
// with the lanes of its q (xor 4, 8, 16) each halve the columns a thread
// keeps, so that it ends with the minima of columns j0 .. j0 + N / 8 - 1
// in k[0 ..], j0 = N / 2 b0 + N / 4 b1 + N / 8 b2 for the bits b of g;
// returns j0. 14 shuffles a thread (N 16) where a butterfly over every
// column takes 48.
template <int N, typename K>
__device__ __forceinline__ int column_minima(K (&k)[16], int g) {
  keep_half<N / 2>(k, g & 1, 4);
  keep_half<N / 4>(k, (g >> 1) & 1, 8);
  keep_half<N / 8>(k, (g >> 2) & 1, 16);
  return (g & 1) * (N / 2) + ((g >> 1) & 1) * (N / 4) +
         ((g >> 2) & 1) * (N / 8);
}

// P2's tail (kFused, int8): K4's epilogue by the pair's last block to
// finish, as knn_tc.cuh's last_block_epilogue, on the THREADS consumer
// threads (the producer warpgroup has left: no __syncthreads after the
// role split), met at named barrier kTailBar: every thread fences its row
// keys, pb stores and column atomicMins, one thread counts the block in
// the pair's counter, and the pair's last block reads row_p and col_p
// through L2 (__ldcg), runs K4 on EPI_THREADS of its threads and sets the
// counter back to 0. Pointers as knn_tc.cuh's fused_epilogue: the
// counters in uv_a, bj then ok in col_k.
constexpr int kTailBar = 7;         // the body's: 1 .. 2 kConsumers, 5
template <int THREADS, int EPI_THREADS>
__device__ __forceinline__ void fused_tail(const int* row_p, const int* col_p,
                                           const float* uv_a,
                                           long long* col_k, int n) {
  __shared__ int last;
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.y * n;
  int* counter =
      const_cast<int*>(reinterpret_cast<const int*>(uv_a)) + blockIdx.y;
  __threadfence();                  // row_p, col_p, pb before the count
  hopper::bar_sync(kTailBar, THREADS);
  if (tid == 0) last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  hopper::bar_sync(kTailBar, THREADS);
  if (!last) return;
  __threadfence();
  int* bj = reinterpret_cast<int*>(col_k) + base;
  if (tid < EPI_THREADS)
    tc::k4_rows<EPI_THREADS>(row_p + 2 * base, col_p + base, bj,
                             bj + (size_t)gridDim.y * n, n);
  if (tid == 0) *counter = 0;       // ready for the next launch
}

// One block: BM A rows (blockIdx.x) of one pair (blockIdx.y) against all
// n_b B rows. Outputs as knn_tc_kernel's: K1's row_p / col_p (col_p
// pre-filled with 0x7FFFFFFF), K3's row_k / col_k (pre-filled with
// INT64_MAX), kProductRowSum's wrapping row sums or kProductRowMin's row
// minima of the dots (P6) in both slots of row_p, or kFused's K1 and then
// (flags off) pb and K4's bj and ok through fused_tail's pointers (P2:
// pb in row_k, uv_b in pred_b). ta, tb: encode_pairs maps of a and b with
// boxes of BM and BN rows; a32: f32's split A rows (n_pairs, n_a, 3, 128
// or 256) bf16 as pairs of values, for its hi fragments (unused by bf16
// and int8).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads<Body<T, MODE>>, 1)
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
  using B = Body<T, MODE>;
  using Acc = typename B::Acc;
  constexpr bool kF32 = B::kPlanes == 3;
  constexpr bool kInt8 = std::is_same<Acc, int>::value;
  constexpr int kChunks = B::kChunks;
  constexpr int kHalves = B::kHalves;
  constexpr int kBMT = kBM<B>;
  constexpr int kAC = kAChunk<B>;
  constexpr int kDim = 64 * kChunks;     // bf16 values of a plane's row
  constexpr bool kGated = MODE == kPackedGated;
  constexpr bool kSum = MODE == kProductRowSum;
  constexpr bool kMin = MODE == kProductRowMin;
  constexpr bool kFusedM = fused(MODE);
  constexpr bool kNorms = normed(MODE);
  constexpr int kBN = TileN<B>::value;
  constexpr int kC = B::kConsumers;
  static_assert(MODE == kPacked || kGated || MODE == kWide || kSum ||
                    kMin || kFusedM,
                "K1, K3, the product-only stage or P6's and P2's modes");
  static_assert(MODE != kWide || !kInt8, "K3 takes bf16 or f32");
  static_assert(kBN == 64 || kMin, "the key epilogue takes 64-row B tiles");
  static_assert(!kFusedM || (kInt8 && !kF32 && kD2Mad<T>), "P2 takes int8");
  if constexpr (kFusedM && (MODE & kFusedNoMain)) {    // P2's nomain
    if (threadIdx.x < 128 * kC)
      fused_tail<128 * kC, MODE & kFusedEpiHalf ? 64 * kC : 128 * kC>(
          row_p, col_p, uv_a, col_k, n_b);
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  Smem<T, MODE>& s = *reinterpret_cast<Smem<T, MODE>*>(
      smem_raw + (((base + 1023u) & ~1023u) - base));

  const int pair = blockIdx.y;
  const int a0 = blockIdx.x * kBMT;
  const int tid = threadIdx.x;
  const int n_tiles = n_b / kBN;
  constexpr int kRing = B::kRing;
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], B::kEmpty);   // lane 0 of each
    }
    mbar_init(&s.a_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * kC) {            // the producer warpgroup
    regs_dec<40>();                 // consumers: kConsumerRegs
    if (tid != 128 * kC) return;
    tma_prefetch(&ta);
    tma_prefetch(&tb);
    const int rows_a = min(kBMT, n_a - a0);
    mbar_expect_tx(&s.a_full, B::kAPlanes * kChunks * kAC +
                                  (kGated ? rows_a * 8 : 0));
    // bf16: its one plane; f32: mid and lo (planes 1 and 2)
#pragma unroll
    for (int p = 0; p < B::kAPlanes; ++p)
      for (int c = 0; c < kChunks; ++c)
        for (int r = 0; r < kBMT; r += kABox<B>)
          tma_load_3d(s.a[p][c] + r * 128, &ta, &s.a_full,
                      (kF32 ? kDim * (p + 1) : 0) + c * 64, a0 + r, pair);
    if (kGated)
      bulk_load(s.ua, uv_a + ((size_t)pair * n_a + a0) * 2, rows_a * 8,
                &s.a_full);
    // stage u: tile u / P, its plane 2 - u % P for f32 (lo, mid, hi)
    const int n_stages = n_tiles * B::kPlanes;
    for (int u = 0, t = 0, i = 0; u < n_stages; ++u) {
      const int st = u % kRing;
      const bool first = i == 0;    // the tile's norms and gate travel here
      wait(&s.empty[st], ((u / kRing) & 1) ^ 1);
      mbar_expect_tx(&s.full[st],
                     kChunks * kBChunk<B> +
                         (first ? (kNorms ? kBN * 4 : 0) +
                                      (kGated ? kBN * 8 : 0)
                                : 0));
      const int v0 = kF32 ? kDim * (2 - i) : 0;
      for (int c = 0; c < kChunks; ++c)
        tma_load_3d(s.b[st][c], &tb, &s.full[st], v0 + c * 64, t * kBN,
                    pair);
      if (first) {
        const size_t j = (size_t)pair * n_b + t * kBN;
        if (kNorms) bulk_load(s.nb2[t & 3], nb2 + j, kBN * 4, &s.full[st]);
        if (kGated)
          bulk_load(s.pb[t & 3], pred_b + 2 * j, kBN * 8, &s.full[st]);
      }
      if (++i == B::kPlanes) {
        i = 0;
        ++t;
      }
    }
    return;
  }

  regs_inc<kConsumerRegs<B>>();
  // bf16 and int8: rows 128 wg .. of the block; f32 at 128 A rows: rows
  // 64 wg ..; f32 at 64: tiles wg, wg + 2, ..
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int q = lane & 3;           // fragment column pair
  // the warpgroup's first row in the block: both on the same rows where
  // they take alternate tiles
  constexpr int kWgRows = kAltTiles<B> ? 0 : 64 * kHalves;
  const int r0 = a0 + wg * kWgRows + warp * 16 + g;   // (half 0, g)
  // halves of the warpgroup with rows in the pair (warpgroup-uniform;
  // f32 has one)
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    valid[h] = h < kHalves && a0 + wg * kWgRows + 64 * h < n_a;

  // the row top-2 of this thread's columns: K1's packed keys; K3's values
  // and indices (v1 <= v2), made into 64-bit keys at the end; the row sum
  // (in r1) of kProductRowSum. K1 keeps a row's top-2 as kChains partial
  // top-2s (chain c over the n8 tiles nt with nt % kChains == c), merged
  // at the end: its epilogue is short of independent work while the
  // other warpgroup waits on its products, and the min/max chain of a
  // row's top-2 is the longest dependence in it. kProductRowMin keeps its
  // row minima (in r1) as two chains alike.
  constexpr int kChains =
      MODE == kPacked || kGated || kFusedM || kMin ? 2 : 1;
  float na[2][2], ux[2][2], uy[2][2];
  int nak[2][2];                    // kD2Mad: 2^21 + na as f32 bits of 2^23
  int r1[2][2][2], r2[2][2][2];
  float v1[2][2], v2[2][2];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + h * 64 + hh * 8;
      na[h][hh] = kNorms && valid[h] ? na2[(size_t)pair * n_a + row] : 0.f;
      nak[h][hh] = 0x4B000000 + (1 << 21) + __float2int_rn(na[h][hh]);
#pragma unroll
      for (int ch = 0; ch < kChains; ++ch)
        r1[h][hh][ch] = r2[h][hh][ch] =
            kSum ? 0 : MODE == kWide ? -1 : kKeyMax;
      v1[h][hh] = v2[h][hh] = __int_as_float(0x7F800000);
    }
  // f32: the A fragments of the hi plane of rows r0, r0 + 8 (where the
  // warpgroup has rows: n_a is a multiple of 64), k-step s at values 16 s
  // + 2q, + 8; a split row is 3 kDim bf16 values, kW words (the bounds
  // stay literal: 16 k-steps at 256 values, 8 at 128)
  uint32_t ah[16][4];
  if constexpr (kF32) {
    constexpr int kW = 3 * kDim / 2;
    const uint32_t* p = a32 + ((size_t)pair * n_a + r0) * kW;
#pragma unroll
    for (int st = 0; st < 4 * kChunks; ++st)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        ah[st][r] = valid[0] ? __ldg(p + (r & 1) * 8 * kW + 8 * st + q +
                                     (r >> 1) * 4)
                             : 0u;
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
  int one;                          // 1, opaque to ptxas (mad_s32)
  asm volatile("mov.u32 %0, %%nctaid.z;" : "=r"(one));
  (void)one;
  (void)nak;

  // tile t's key epilogue on acc (its products complete) over the
  // warpgroup's first H halves (those with rows in the pair): H a
  // compile-time constant, so that the unrolled columns are one block of
  // straight-line code the compiler can interleave. bf16's K3 takes the
  // thread's 16 columns in passes (kWidePasses), each pass's column
  // minima reduced before the next: the same exchanges, half the keys
  // live.
  auto epilogue = [&](auto& acc, int t, auto halves,
                      const float (&nbr)[16]) {
    constexpr int H = decltype(halves)::value;
    constexpr int kPasses =
        MODE == kWide && kHalves == 2 ? kWidePasses : 1;
    constexpr int kCols = 16 / kPasses;   // columns a pass
    const int b0 = t * kBN;
    const float* spb = s.pb[t & 3];
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      // the thread's candidate for each of the pass's columns: K1's key,
      // K3's value and row
      int ck[16], ci[16];
      float cv[16];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        // d[i]: n8 tile i / 4, row g + 8 ((i / 2) % 2), column i % 2
        const int j = pass * kCols + jj;
        const int nt = j >> 1, e = j & 1;
        const int c = nt * 8 + 2 * q + e;
        const float nbv = nbr[j];
        const float px = kGated ? spb[2 * c] : 0.f;
        const float py = kGated ? spb[2 * c + 1] : 0.f;
        ck[jj] = kKeyMax;
        cv[jj] = __int_as_float(0x7F800000);
        ci[jj] = -1;
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r0 + h * 64 + hh * 8;
            const Acc dot = acc[h][nt * 4 + hh * 2 + e];
            if constexpr (kSum) {
              r1[h][hh][0] = tc::wrap_add(r1[h][hh][0], tc::dot_int(dot));
            } else if constexpr (MODE == kWide) {
              // (|a|^2 + |b|^2) - 2 a.b rounded once, as the reference
              // and the plain version (2 a.b is exact: one FFMA)
              const float d2 =
                  __fmaf_rn(-2.f, dot, __fadd_rn(na[h][hh], nbv));
              // a thread meets its columns, and its rows, in increasing
              // index order, so a strict < on the value keeps the lowest
              // index among equal values: the 64-bit keys' order
              float& u1 = v1[h][hh];
              float& u2 = v2[h][hh];
              int& i1 = r1[h][hh][0];
              int& i2 = r2[h][hh][0];
              const bool p1 = d2 < u1, p2 = d2 < u2;
              u2 = p1 ? u1 : p2 ? d2 : u2;
              i2 = p1 ? i1 : p2 ? b0 + c : i2;
              u1 = p1 ? d2 : u1;
              i1 = p1 ? b0 + c : i1;
              const bool pc = d2 < cv[jj];
              cv[jj] = pc ? d2 : cv[jj];
              ci[jj] = pc ? row : ci[jj];
            } else {
              int bits;               // masked below
              if constexpr (kInt8 && kD2Mad<T>) {
                // 128 values: each value's a^2 - 2ab lies in [-2^14,
                // 48896], so 2^21 + na - 2 dot lies in [0, 8355840], below
                // 2^23: as the mantissa of 2^23 (nak) it is the f32 2^23 +
                // 2^21 + na - 2 dot, exactly; adding nb - 2^23 - 2^21
                // (nbv, the pre-pass's biased norm) rounds the exact d2 <
                // 2^23, an f32
                bits = __float_as_int(__fadd_rn(
                    __int_as_float(mad_s32(dot, -2, nak[h][hh])), nbv));
              } else if constexpr (kInt8) {
                // the f32 with the bits of 1.5 x 2^23 + dot, less 1.5 x
                // 2^23, is float(dot) exactly (|dot| <= 2^22); na - 2 dot
                // and d2 are integers below 2^24 (knn_tc.cuh's int8 d2)
                const float dotf = __fsub_rn(
                    __int_as_float(0x4B400000 + dot), 12582912.f);
                bits = __float_as_int(
                    __fadd_rn(__fmaf_rn(-2.f, dotf, na[h][hh]), nbv));
              } else {
                // 2 dot is exact, so one rounding of (na + nb) - 2 dot is
                // the plain version's
                const float d2 =
                    __fmaf_rn(-2.f, dot, __fadd_rn(na[h][hh], nbv));
                bits = __float_as_int(fmaxf(d2, 0.f));
              }
              if (kGated &&
                  gated_out(ux[h][hh], uy[h][hh], px, py, radius2))
                bits = kGatedBits;
              // the row's and the column's key from one mask, by IMADs on
              // the FMA pipe (LOP3s would take the integer pipe's slots)
              const int m = bits & ~kIdxMask;
              const int rk = mad_s32(m, one, b0 + c);
              const int ek = mad_s32(m, one, row);
              // insert2 on unique keys, as min/max
              const int ch = nt % kChains;
              r2[h][hh][ch] = min(r2[h][hh][ch], max(r1[h][hh][ch], rk));
              r1[h][hh][ch] = min(r1[h][hh][ch], rk);
              ck[jj] = min(ck[jj], ek);
            }
          }
      }
      if constexpr (!kSum) {
        // each column over the warp's rows (the lanes of one q): every
        // lane ends with the minima of kCols / 8 adjacent columns
        K k[16];
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          if constexpr (MODE == kWide)
            k[jj] = wide_key(cv[jj], ci[jj]);
          else
            k[jj] = ck[jj];
        }
        const int j0 = pass * kCols + column_minima<kCols>(k, g);
        K* part = &s.colpart[wg][(kAltTiles<B> ? t >> 1 : t) & 1][warp]
                             [(j0 >> 1) * 8 + 2 * q + (j0 & 1)];
#pragma unroll
        for (int i = 0; i < kCols / 8; ++i) part[i] = k[i];
      }
    }
    if constexpr (!kSum)
      bar_sync(kC + 1 + wg, 128);   // the partials are in: flush(t)
  };

  // kProductRowMin (P6): the row minima of a tile's dots over the
  // warpgroup's first H halves, all kBN columns, in two chains (over
  // alternate n8 tiles)
  auto row_min = [&](auto& acc, auto halves) {
    constexpr int H = decltype(halves)::value;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i)
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int hh = (i >> 1) & 1, ch = (i >> 2) % kChains;
        r1[h][hh][ch] = min(r1[h][hh][ch], tc::dot_int(acc[h][i]));
      }
  };

  // tile t's column minima: the warpgroup's 4 warps' partials, then one
  // atomicMin a column
  auto flush = [&](int t) {
    const int c = tid & 127;
    if (kSum || kMin || !valid[0] || c >= kBN) return;
    const K* p = &s.colpart[wg][(kAltTiles<B> ? t >> 1 : t) & 1][0][c];
    const K m = tc::kmin(tc::kmin(p[0], p[kBN]),
                         tc::kmin(p[2 * kBN], p[3 * kBN]));
    const size_t j = (size_t)pair * n_b + t * kBN + c;
    if constexpr (MODE == kWide)
      atomicMin(&col_k[j], m);
    else if constexpr (!kSum)
      atomicMin(&col_p[j], m);
  };

  // the tile's norms of this thread's 16 columns: bf16 and int8 read them
  // before the products (the gate's positions, in 32 more registers, cost
  // more there than they save), f32 after them (its registers hold A's
  // plane)
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
    // ping-pong: warpgroup 0 issues tile t's products once the last
    // warpgroup has issued tile t - 1's (named barrier 1), warpgroup w > 0
    // once warpgroup w - 1 has issued tile t's (barrier 1 + w), so the
    // tensor cores take them in turns while the others run their epilogue
    Acc acc[kHalves][kBN / 2];
    for (int t = 0; t < n_tiles; ++t) {
      wait(&s.full[t % kRing], (t / kRing) & 1);
      float nbr[16];
      norms(nbr, t);
      if (wg > 0)
        bar_sync(1 + wg, 256);
      else if (t > 0)
        bar_sync(1, 256);
      issue<B>(acc, sa, s.b[t % kRing][0]);
      if (wg + 1 < kC)
        bar_arrive(2 + wg, 256);
      else if (t + 1 < n_tiles)
        bar_arrive(1, 256);
      if (t > 0) flush(t - 1);      // under this tile's products
      wgmma_wait<0>();
      fence_acc(acc);
      release(t);
      if constexpr (kMin) {
        if (valid[1])
          row_min(acc, std::integral_constant<int, kHalves>());
        else if (valid[0])
          row_min(acc, std::integral_constant<int, 1>());
      } else if (valid[1]) {
        epilogue(acc, t, std::integral_constant<int, kHalves>(), nbr);
      } else if (valid[0]) {
        epilogue(acc, t, std::integral_constant<int, 1>(), nbr);
      }
    }
  } else {
    // each tile's planes through the ring: stage u = 3t + I, tile t's B
    // plane lo (I 0), mid (1), hi (2)
    float acc[1][32], sm[1][32];
    constexpr int kStep = kAltTiles<B> ? 2 : 1;   // a warpgroup's tiles
    auto plane = [&](int t, auto pos) {
      constexpr int I = decltype(pos)::value;
      const int u = 3 * t + I;
      wait(&s.full[u % kRing], (u / kRing) & 1);
      issue_f32<B, I>(acc, sm, ah, sa, s.b[u % kRing][0]);
      if (I == 0 && t >= kStep) flush(t - kStep);   // under its products
      if (I > 0) {                  // the stage before is read
        wgmma_wait<1>();
        release(u - 1);
      }
    };
    auto planes = [&](int t) {
      plane(t, std::integral_constant<int, 0>());
      plane(t, std::integral_constant<int, 1>());
      plane(t, std::integral_constant<int, 2>());
    };
    auto finish = [&](int t) {
      wgmma_wait<0>();
      fence_acc(acc);
      fence_acc(sm);
      release(3 * t + 2);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[0][i] = __fadd_rn(acc[0][i], sm[0][i]);
      float nbr[16];
      norms(nbr, t);
      if (valid[0]) epilogue(acc, t, std::integral_constant<int, 1>(), nbr);
    };
    if constexpr (kAltTiles<B>) {
      // each warpgroup its own tiles; the stages' order staggers the two,
      // so that one's key epilogue runs under the other's products
      for (int t = wg; t < n_tiles; t += 2) {
        planes(t);
        finish(t);
      }
    } else {
      // both on every tile, each on its own rows, in ping-pong as bf16's
      // (the barriers around a tile's three planes)
      for (int t = 0; t < n_tiles; ++t) {
        if (wg > 0)
          bar_sync(1 + wg, 256);
        else if (t > 0)
          bar_sync(1, 256);
        planes(t);
        if (wg + 1 < kC)
          bar_arrive(2 + wg, 256);
        else if (t + 1 < n_tiles)
          bar_arrive(1, 256);
        finish(t);
      }
    }
  }
  if constexpr (kAltTiles<B>) {     // the warpgroup's last tile's columns
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
        k1 = r1[h][hh][0] < 0 ? kWideMax
                              : wide_key(v1[h][hh], r1[h][hh][0]);
        k2 = r2[h][hh][0] < 0 ? kWideMax
                              : wide_key(v2[h][hh], r2[h][hh][0]);
      } else {
        k1 = r1[h][hh][0];
        k2 = r2[h][hh][0];
#pragma unroll
        for (int ch = 1; ch < kChains; ++ch) {
          if constexpr (kMin)
            k1 = min(k1, r1[h][hh][ch]);
          else
            tc::merge2(r1[h][hh][ch], r2[h][hh][ch], k1, k2);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const K o1 = __shfl_xor_sync(0xffffffffu, k1, off);
        if constexpr (kSum) {
          k1 = tc::wrap_add(k1, o1);
        } else if constexpr (kMin) {
          k1 = min(k1, o1);
        } else {
          const K o2 = __shfl_xor_sync(0xffffffffu, k2, off);
          tc::merge2(o1, o2, k1, k2);
        }
      }
      if constexpr (kAltTiles<B>) {  // warpgroup 1 hands its keys over
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
          row_p[r + 1] = kSum || kMin ? k1 : k2;
        }
        // P2's pb from the best index this thread holds, not re-read from
        // row_p (int offsets: below 65535 x 8192)
        if constexpr (kFusedM && !(MODE & kFusedNoPb)) {
          const int p = tc::ctaid_y();
          reinterpret_cast<float2*>(row_k)[p * n_a + r0 + h * 64 + hh * 8] =
              reinterpret_cast<const float2*>(
                  pred_b)[p * n_b + (k1 & kIdxMask)];
        }
      }
    }
  }
  if constexpr (kFusedM && !(MODE & kFusedNoEpi))
    fused_tail<128 * kC, MODE & kFusedEpiHalf ? 64 * kC : 128 * kC>(
        row_p, col_p, uv_a, col_k, n_b);
}

// The body over T in MODE on a (n_pairs, n_a, dim) and b (n_pairs, n_b,
// dim) rows of T, dim 128 or 256 (bf16 bits; int8 with K1's norm
// pre-pass's f32 norms; f32: the split pre-pass's (n_pairs, n, 3, dim)
// bf16 planes), 16-byte
// aligned, n_a and n_b multiples of 64; other arguments as
// knn_tc_kernel's. Returns the cudaError_t of the launch (that of the TMA
// maps' encoding where it fails).
template <typename T, int MODE>
int launch(const void* a, const void* b, const void* na2, const void* nb2,
           const void* uv_a, const void* pred_b, float radius2, void* row_p,
           void* col_p, void* row_k, void* col_k, int n_pairs, int n_a,
           int n_b, cudaStream_t stream) {
  using B = Body<T, MODE>;
  // bf16 values a row (TMA moves bytes: int8's 256 bytes as 128)
  constexpr int kK = 64 * B::kChunks * B::kPlanes;
  CUtensorMap ta, tb;
  int e = hopper::encode_pairs(&ta, a, n_pairs, n_a, kK, kABox<B>);
  if (e == 0)
    e = hopper::encode_pairs(&tb, b, n_pairs, n_b, kK, TileN<B>::value);
  if (e != 0) return e;
  e = (int)cudaFuncSetAttribute(knn_wg_kernel<T, MODE>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmem<T, MODE>);
  if (e != 0) return e;
  dim3 grid((n_a + kBM<B> - 1) / kBM<B>, n_pairs);
  // the kernel reads its keys' multiplier 1 from %nctaid.z (mad_s32): a
  // grid with a z dimension would scale every K1 key
  if (grid.z != 1) return (int)cudaErrorInvalidConfiguration;
  knn_wg_kernel<T, MODE><<<grid, kThreads<B>, kSmem<T, MODE>, stream>>>(
      ta, tb, B::kPlanes == 3 ? (const uint32_t*)a : nullptr,
      (const float*)na2, (const float*)nb2, (const float*)uv_a,
      (const float*)pred_b, radius2, (int*)row_p, (int*)col_p,
      (long long*)row_k, (long long*)col_k, n_a, n_b);
  return (int)cudaGetLastError();
}

// Blocks of the body over T in MODE resident on one SM at once (the
// occupancy calculator's count after the shared-memory opt-in); a
// negative cudaError_t where a call fails
template <typename T, int MODE>
int blocks_per_sm() {
  cudaError_t e = cudaFuncSetAttribute(
      knn_wg_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem<T, MODE>);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, knn_wg_kernel<T, MODE>, kThreads<Body<T, MODE>>, kSmem<T, MODE>);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace wg
}  // namespace knn
