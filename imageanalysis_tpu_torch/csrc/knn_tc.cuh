// K1's and K3's mma.sync body on the tensor cores, for Hopper (sm_90a),
// over the operand type T: bf16 bits (uint16_t), int8 (int8_t) or f32
// split into three bf16 planes (Bf16x3). Included at the end of
// knn_common.cuh, whose constants, gate and keys it uses. What still runs
// it: the probes. Every 2-NN row, K1 (every type, plain and gated) and K3
// at 128 and 256 values a row, runs the wgmma body (knn_wg.cuh, launch_tc
// at the end); the mma.sync instantiations they replaced stay as
// knn_probe.cu's yardsticks (knn_bf16_d128, knn_i8_d128, knn_f32_d128,
// knn_*_d256), and P3's and P4's stages run here whole, K1 at their full
// stage included. The probes' modes
// (knn_probe.cu) cut its epilogue down: kProductRowSum, a wrapping row sum
// in place of the keys (the product-only stage); kProductRowMin, the row
// minimum of the dots (P6's kernel, swept over tiles); and K1's packed d2
// and keys with the row top-1 only (kProductTop1), the row top-2 of the
// last B tile (kProductTop2Tile: restarted at every tile) or the running
// row top-2 (kProductTop2), each without the column minimum: with
// kProductRowMin and kPacked, P3's five stages on this body. P2's single
// launch of K1 + K4 (knn_fused_probe.cu) is kPacked on int8 with a tail
// (kFused, below): where a row's keys leave the block, the thread that
// stores them writes pb from the best index it holds, and the pair's last
// block to finish runs K4's epilogue on every row of the pair.
//
// Replaces, for bf16, int8 and f32 descriptors:
//   imageanalysis_tpu/ops/knn.py:105 _knn_kernel_packed  (K1, every dot)
//   imageanalysis_tpu/ops/knn.py:407 _knn_kernel         (K3, every dot)
//   scripts_dev/knn_overhead_sweep.py:36 kernel          (P6, row min)
//   scripts_dev/knn_culprit_bisect.py:42 kernel          (P3, K1 built up)
//   scripts_dev/fused_vmem_probe.py:26 kern              (P2, K1 + K4)
//
// What bounds it on the H100: the product, 2 n_a n_b 128 operations a
// pair, at the tensor cores' rate (989 TFLOP/s bf16, 1,979 TOP/s int8;
// f32 takes six bf16 products), and the per-element key epilogue (d2,
// pack or 64-bit key, gate, row top-2, column minimum) on the CUDA cores,
// which costs about as many issue slots as the mma.sync instructions. The
// bodies it replaced spent 93% (FFMA on bf16, 26.8 TFLOP/s) and 86%
// (__dp4a on int8, 100 TOP/s) of their time in the product; the FFMA f32
// body ran at 39% of the CUDA cores' 67 TFLOP/s.
//
// What the type decides:
//                  bf16            int8              f32 (Bf16x3)
//   row pitch      272 B           144 B             784 B (3 planes of
//                  (17 x 16 B)     (9 x 16 B)        256 B, 49 x 16 B)
//   B tile         128 rows        128 rows          64 rows
//   mma.sync       m16n8k16,       m16n8k32,         m16n8k16, 8 k-steps
//                  8 k-steps       4 k-steps         x 6 plane products
//   accumulator    f32             s32 (exact)       f32
//   norms          f32, caller's   f32, K1's         f32, caller's
//                                  pre-pass (exact)
//   d2             (na + nb) - 2 acc in f32 with     as bf16
//                  __fadd_rn/__fmul_rn, clamped at
//                  0 (int8: (na - 2 acc) + nb, acc
//                  made f32 by the 1.5 x 2^23 trick,
//                  every step an integer below 2^24)
// All are 32-byte k-steps with the same fragment bytes (mma_sync.cuh), so
// one ldmatrix.x4 addressing, in bytes, feeds them all.
//
// f32 on the tensor cores. The TPU kernel's f32 dot runs at
// Precision.HIGHEST, a multi-pass bf16 product on the MXU; this is its
// counterpart. A pre-pass (knn_packed.cu's split_bf16x3_kernel) writes each f32 value x as
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each
// difference exact in f32, so x == hi + mid + lo for every finite f32 of
// descriptor range; a row becomes its three planes side by side. The
// product takes the six plane products of order >= 2^-16 and drops mid.lo,
// lo.mid and lo.lo (order 2^-24 of |a||b|). hi.hi goes into one f32
// accumulator, the five smaller ones (lo.hi, hi.lo, mid.mid, mid.hi,
// hi.mid) into a second, added to the first once a B tile: mma.sync's f32
// sums may truncate each step to the larger addend's precision (they are
// not specified to round to nearest), and in one accumulator every step of
// the small products would cost up to an ulp of the whole dot, 48 steps a
// dot where hi.hi alone takes 8; in their own accumulator they cost 2^-8
// of that. Integer-valued descriptors below 2^8 have mid = lo = 0 and
// every partial sum is an integer below 2^24, so the dots, and the keys,
// are exact.
// Three planes at BM = 128 with 128-row B tiles would not fit the 227 KB of
// a block; 64-row B tiles do (~199 KB at BM = 128, ~150 KB at 64: one block
// an SM), and keep as many mma.sync per ldmatrix as the bf16 body. K1 and
// K3 take the same f32 body; K3's keys are 64-bit (kWide).
//
// Rows of 256 values (ORB's 256 bits as 0/1, the int8 store's -128/-127):
// the operand type D256<T> is T at twice the row. Exactness holds as at
// 128: int8 |dot| <= 256 x 128^2 = 2^22 (the 1.5 x 2^23 trick still lands
// in [2^23, 2^24]) and d2 <= 256 x 255^2 < 2^24; integer-valued floats
// keep every partial sum below 2^24. All three types at 256 run their own
// body, wgmma fed by TMA (knn_wg.cuh): here int8's 272-byte rows held the
// 128-row tiles of 128 (~108 KB, two blocks an SM, twice the k-steps),
// bf16's 528-byte rows 128 A rows and two 128-row B tiles (~204 KB) and
// f32's 1552-byte rows 64 A rows and one 64-row B tile (~196 KB, STAGES =
// 1: the copy of a tile did not overlap the product of the one before);
// those instantiations stay only as knn_probe.cu's yardsticks, as do every
// type's at 128 in K1's and K3's modes (tc::launch_mma).
//
// Design:
// - A block owns BM = 128 A rows of one pair (64 where n_a is an odd
//   multiple of 64), resident in shared memory for the whole sweep over
//   B; B streams through a ring of STAGES (2) tiles of BN rows (the
//   type's kBN), each filled by cp.async.cg (16 B a thread) while the
//   tile before it is multiplied: the copy of tile t + 1 overlaps the
//   mma.sync of tile t.
//   BM, BN and STAGES are template parameters whose defaults are K1's and
//   K3's tiles; P6 sweeps others (BM 64-256, BN 64 or 128, 2 or 3 stages)
//   in kProductRowMin. Blocks an SM (the launch bounds) follow from the
//   tile: two where two fit the SM's shared memory and a warp's
//   accumulators stay at 32 x 64 (at most 128 registers), else one.
//   Rows are padded to an odd number of 16-byte units, so ldmatrix.x4
//   reads them without bank conflicts. ~107 KB (bf16) or ~60 KB (int8) of
//   dynamic shared memory: two blocks share an SM (__launch_bounds__(256,
//   2), at most 128 registers), so one block's epilogue overlaps the
//   other's products; f32 (~199 KB) holds one block an SM, whose two
//   accumulators may take up to 255 registers.
// - 8 warps, each a 32 x (BN / WN) tile of mma.sync accumulators
//   (mma_sync.cuh), no widening of the operands.
// - The epilogue runs on the accumulator fragment: a thread holds rows g
//   and g + 8 (g = lane / 4) of each m16 tile and columns 2q, 2q + 1
//   (q = lane % 4) of each n8 tile. Row top-2 keys stay in registers for
//   the whole sweep and are merged at the end over the quad (shfl_xor 1,
//   2) and then over the warps that share a row (shared memory, in warp
//   order). Each tile's column minimum is taken over the thread's rows,
//   over g (shfl_xor 4, 8, 16), over the warps along M (shared atomicMin)
//   and leaves the block by one global atomicMin per column. K1's top-2
//   is two min/max a candidate. K3 keeps f32 values and int indices and
//   builds its 64-bit keys only for the shuffles: a thread meets its
//   columns and rows in increasing index order, so a strict < on the
//   value already keeps the lowest index among equal values.
// - bf16 and f32: d2, the packing and the gate are knn_common.cuh's
//   float body's, operation for operation (__fadd_rn/__fmul_rn: no FMA
//   contraction). int8: the __dp4a body's integer d2, as the plain version computes it.
//   Every key is unique (its index is in it), so for integer-valued
//   descriptors (bf16 products of integers <= 255 are exact and 128 x
//   255^2 < 2^24 keeps every f32 partial sum exact; int8 sums are exact
//   in int32) the result equals the plain versions bit for bit, whatever
//   the order of the reductions.
// - A last B tile of 64 rows (n_b an odd multiple of 64, 128-row tiles)
//   skips the n8 tiles beyond n_b in its epilogue, warp by warp; their
//   products read stale shared memory and are never used.

#pragma once

#include <type_traits>

#include "mma_sync.cuh"

namespace knn {

// f32 descriptors as three bf16 planes (hi, mid, lo) of 128 values a row
struct Bf16x3 {};
// T's rows at 256 values in place of 128 (the head of this file)
template <typename T>
struct D256 {};
// the element type of an operand type: T of D256<T>
template <typename T>
struct Elem {
  using type = T;
};
template <typename T>
struct Elem<D256<T>> {
  using type = T;
};

namespace tc {

constexpr int kStages = 2;          // B tiles in the ring (the default)

// What the operand type decides: the accumulator type, the bytes of a row
// (its planes side by side) and the B rows of a streamed tile (the
// default BN)
template <typename T>
struct Op;
template <>
struct Op<uint16_t> {               // bf16 bits
  using Acc = float;
  static constexpr int kPlanes = 1;
  static constexpr int kRowBytes = kDim * 2;
  static constexpr int kBN = 128;
};
template <>
struct Op<int8_t> {
  using Acc = int;
  static constexpr int kPlanes = 1;
  static constexpr int kRowBytes = kDim;
  static constexpr int kBN = 128;
};
template <>
struct Op<Bf16x3> {
  using Acc = float;
  static constexpr int kPlanes = 3;
  static constexpr int kRowBytes = 3 * kDim * 2;
  static constexpr int kBN = 64;
};
template <typename T>
struct Op<D256<T>> : Op<T> {
  static constexpr int kRowBytes = 2 * Op<T>::kRowBytes;
};
// a padded shared row: 272 B (bf16), 144 B (int8) or 784 B (f32), an odd
// number of 16-byte units (at 256 values: 528, 272 and 1552 B)
template <typename T>
constexpr int kPitch = Op<T>::kRowBytes + 16;
template <typename T>
constexpr int kChunks = Op<T>::kRowBytes / 16;   // 16-byte chunks per row

template <typename T, int BM, int BN, int STAGES>
struct Smem {
  unsigned char a[BM * kPitch<T>];             // the block's A rows
  unsigned char b[STAGES][BN * kPitch<T>];     // the ring of B tiles
  float nb2[STAGES][BN];
  float pb[STAGES][BN * 2];         // the gate's predicted positions
  float ua[BM * 2];                 // the gate's A positions
  long long colmin_w[BN];           // the tile's column minimum (K3)
  int colmin[BN];                   // (K1)
};

// Blocks an SM for a tile (its launch bounds): two where two fit the SM's
// 228 KB of shared memory (1 KB of it reserved a block) and a warp's
// accumulators are at most 32 x 64 (K1's bf16 and int8 tiles: 128
// registers), else one (up to 255 registers; f32's ~199 KB)
template <typename T, int BM, int BN, int STAGES>
constexpr int kBlocksPerSm =
    2 * ((int)sizeof(Smem<T, BM, BN, STAGES>) + 1024) <= 233472 &&
            BN / (8 / (BM / 32)) <= 64
        ? 2
        : 1;

template <int MODE>
using Key = typename std::conditional<MODE == kWide, long long, int>::type;

template <typename K>
__device__ __forceinline__ K kmin(K x, K y) { return y < x ? y : x; }
template <typename K>
__device__ __forceinline__ K kmax(K x, K y) { return y > x ? y : x; }

// merge the ordered pair (o1 <= o2) into (k1 <= k2)
template <typename K>
__device__ __forceinline__ void merge2(K o1, K o2, K& k1, K& k2) {
  const K n2 = kmin(kmax(k1, o1), kmin(k2, o2));
  k1 = kmin(k1, o1);
  k2 = n2;
}

__device__ __forceinline__ int wrap_add(int x, int y) {
  return (int)((unsigned)x + (unsigned)y);
}

// a dot as an int: f32 dots of integer-valued bf16 are integers below 2^24
__device__ __forceinline__ int dot_int(float x) { return __float2int_rz(x); }
__device__ __forceinline__ int dot_int(int x) { return x; }

// cp.async of B rows b0 .. b0 + rows - 1 of one pair (and their norms and
// gate positions) into ring stage `stage`
template <typename T, int MODE, int BM, int BN, int STAGES>
__device__ __forceinline__ void load_b(Smem<T, BM, BN, STAGES>& s,
                                       int stage,
                                       const unsigned char* Bm,
                                       const float* nbp,
                                       const float* pbp, int b0, int rows,
                                       int tid) {
  constexpr int kRow = Op<T>::kRowBytes;
  const unsigned char* Bt = Bm + (size_t)b0 * kRow;
  for (int w = tid; w < rows * kChunks<T>; w += kThreads) {
    const int r = w / kChunks<T>, c = (w % kChunks<T>) * 16;
    mma_sync::cp_async16(&s.b[stage][r * kPitch<T> + c],
                         Bt + (size_t)r * kRow + c);
  }
  if (normed(MODE) && tid < rows / 4)
    mma_sync::cp_async16(&s.nb2[stage][4 * tid], nbp + b0 + 4 * tid);
  if constexpr (MODE == kPackedGated) {
    if (tid < rows / 2)
      mma_sync::cp_async16(&s.pb[stage][4 * tid],
                           pbp + (size_t)2 * b0 + 4 * tid);
  }
}

// The six plane products of Bf16x3 (planes 0 hi, 1 mid, 2 lo), smallest
// first: lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi
__host__ __device__ constexpr int split_plane_a(int x) {
  return x == 0 ? 2 : x == 2 || x == 3 ? 1 : 0;
}
__host__ __device__ constexpr int split_plane_b(int x) {
  return x == 1 ? 2 : x == 2 || x == 4 ? 1 : 0;
}

// c += a . b for one 32-byte k-step of the operand type
__device__ __forceinline__ void mma(float* c, const unsigned* a, unsigned b0,
                                    unsigned b1) {
  mma_sync::mma_bf16(c, a[0], a[1], a[2], a[3], b0, b1);
}
__device__ __forceinline__ void mma(int* c, const unsigned* a, unsigned b0,
                                    unsigned b1) {
  mma_sync::mma_s8(c, a[0], a[1], a[2], a[3], b0, b1);
}

// blockIdx.y, read where it is used: pair-derived addresses that the
// compiler would otherwise compute before the sweep over B and hold through
// it spill at the 128-register bound (P2's pb gather: 8 bytes)
__device__ __forceinline__ int ctaid_y() {
  int y;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(y));
  return y;
}

// K4's epilogue over one pair's n rows at ratio 0.75 (ratio2 = 0.5625,
// as the TPU probe hard-codes), by the last block of the pair to finish:
// bj[i] = j, ok[i] = max(d1, 0) < 0.5625 * max(d2, 0) && j < n &&
// col_p[j] & 0x1FFF == i (int32 0/1). row_p, col_p, bj and ok start at
// the pair, counter is the pair's. The TPU ran the epilogue at grid step
// n / tile_a, after every A tile: its grid was sequential. Here blocks run
// in any order, and col_p is final only after the pair's last block. So
// every block fences its writes (__threadfence), and one thread adds one
// to the pair's counter; the block that sees gridDim.x - 1 is the pair's
// last, reads row_p and col_p through L2 (__ldcg: another block's atomics
// and stores, never a stale L1 line), runs the epilogue on EPI_THREADS
// threads, then sets the counter back to 0 for the next launch. No
// grid-wide barrier: 48 blocks x 64 pairs are more than can be resident
// at once, and a cooperative grid.sync() would deadlock.
template <int EPI_THREADS>
__device__ __forceinline__ void last_block_epilogue(const int* row_p,
                                                    const int* col_p,
                                                    int* counter, int* bj,
                                                    int* ok, int n) {
  constexpr float kRatio2 = 0.5625f;
  const int tid = threadIdx.x;
  __shared__ bool last;
  __threadfence();                  // row_p, col_p, pb before the count
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < EPI_THREADS) {
    const int2* rows = reinterpret_cast<const int2*>(row_p);
    for (int i = tid; i < n; i += EPI_THREADS) {
      const int2 k = __ldcg(rows + i);
      const int j = k.x & kIdxMask;
      float d1 = __int_as_float(k.x & ~kIdxMask);
      float d2 = __int_as_float(k.y & ~kIdxMask);
      d1 = d1 < 0.0f ? 0.0f : d1;   // keeps a NaN, as K4
      d2 = d2 < 0.0f ? 0.0f : d2;
      bool good = d1 < __fmul_rn(kRatio2, d2);
      good = good && j < n && (__ldcg(col_p + j) & kIdxMask) == i;
      bj[i] = j;
      ok[i] = good ? 1 : 0;
    }
  }
  if (tid == 0) *counter = 0;       // ready for the next launch
}

// kFused's epilogue from the kernel's arguments: kFused carries its extra
// pointers in those that int8 kPacked leaves unused, so that adding it
// changes no other instantiation (their parameters, names and code stay):
// the pairs' counters in uv_a, uv_b (n_pairs, n, 2) f32 in pred_b, pb
// (n_pairs, n, 2) f32 in row_k, and bj then ok, one (2, n_pairs, n) int32
// buffer, in col_k.
template <int MODE>
__device__ __forceinline__ void fused_epilogue(const int* row_p,
                                               const int* col_p,
                                               const float* uv_a,
                                               long long* col_k, int n) {
  const size_t base = (size_t)blockIdx.y * n;
  int* bj = reinterpret_cast<int*>(col_k) + base;
  last_block_epilogue<MODE & kFusedEpiHalf ? kThreads / 2 : kThreads>(
      row_p + 2 * base, col_p + base,
      const_cast<int*>(reinterpret_cast<const int*>(uv_a)) + blockIdx.y, bj,
      bj + (size_t)gridDim.y * n, n);
}

// One block: BM A rows (blockIdx.x) of one pair (blockIdx.y) against all
// n_b B rows. Outputs as knn_float_kernel's full stage: K1's row_p /
// col_p (col_p pre-filled with 0x7FFFFFFF) or K3's row_k / col_k
// (pre-filled with INT64_MAX); kProductRowSum writes each row's wrapping
// sum of its dots, kProductRowMin its minimum dot (as an int) and
// kProductTop1 its smallest key into both slots of row_p, kProductTop2Tile
// and kProductTop2 their two smallest keys; the probes' modes leave col_p
// alone. kFused (n_a == n_b) writes K1's row_p and col_p, then (flags
// off) pb and K4's bj and ok, through fused_epilogue's pointers.
template <typename T, int MODE, int BM, int BN = Op<T>::kBN,
          int STAGES = kStages>
__global__ void __launch_bounds__(kThreads,
                                  kBlocksPerSm<T, BM, BN, STAGES>)
knn_tc_kernel(const T* __restrict__ a, const T* __restrict__ b,
              const float* __restrict__ na2,
              const float* __restrict__ nb2,
              const float* __restrict__ uv_a,
              const float* __restrict__ pred_b, float radius2,
              int* __restrict__ row_p, int* __restrict__ col_p,
              long long* __restrict__ row_k, long long* __restrict__ col_k,
              int n_a, int n_b) {
  using Acc = typename Op<T>::Acc;
  using K = Key<MODE>;
  constexpr bool kInt8 = std::is_same<typename Elem<T>::type, int8_t>::value;
  constexpr bool kSplit = std::is_same<typename Elem<T>::type, Bf16x3>::value;
  constexpr bool kGated = MODE == kPackedGated;
  constexpr bool kSum = MODE == kProductRowSum;
  constexpr bool kMin = MODE == kProductRowMin;
  constexpr bool kKeys = keyed(MODE);
  constexpr bool kNorms = normed(MODE);
  constexpr bool kFirst = MODE == kProductTop1;       // the key top-1 only
  constexpr bool kRestart = MODE == kProductTop2Tile; // top-2 a B tile
  constexpr bool kOneKey = kMin || kFirst;    // one value a row, by min
  constexpr bool kTwoKeys = (kKeys || row_keyed(MODE)) && !kFirst;
  constexpr int kRow = Op<T>::kRowBytes;
  constexpr int kLd = kPitch<T>;
  constexpr int kPlane = kRow / Op<T>::kPlanes;   // bytes of one plane
  constexpr int kBN = BN;
  constexpr int WM = BM / 32;       // warps along M: 32 rows each
  constexpr int WN = 8 / WM;        // warps along N
  constexpr int WCOLS = kBN / WN;   // B rows (output columns) per warp
  constexpr int MT = 2;             // m16 tiles per warp
  constexpr int NT = WCOLS / 8;     // n8 tiles per warp
  static_assert(BM == 64 || BM == 128 || BM == 256,
                "A tiles of 64, 128 or 256 rows");
  static_assert(kThreads == 256 && NT % 2 == 0, "8 warps, n8 tiles in pairs");
  static_assert(BN % 64 == 0 && STAGES >= 1, "B tiles of 64-row multiples");
  static_assert(MODE != kWide || !kInt8, "K3 takes bf16 or f32");
  static_assert(!fused(MODE) || kInt8, "P2 takes int8");
  if constexpr (fused(MODE) && (MODE & kFusedNoMain)) {
    fused_epilogue<MODE>(row_p, col_p, uv_a, col_k, n_b);   // P2's nomain
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, BM, BN, STAGES>& s =
      *reinterpret_cast<Smem<T, BM, BN, STAGES>*>(smem_raw);

  const int pair = blockIdx.y;
  const int a0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int q = lane & 3;           // fragment column pair
  const int wm = (warp % WM) * 32;  // the warp's rows within the block
  const int wn = (warp / WM) * WCOLS;
  const unsigned char* A = reinterpret_cast<const unsigned char*>(a) +
                           ((size_t)pair * n_a + a0) * kRow;
  const unsigned char* Bm = reinterpret_cast<const unsigned char*>(b) +
                            (size_t)pair * n_b * kRow;
  const float* nbp = kNorms ? nb2 + (size_t)pair * n_b : nullptr;
  const float* pbp = kGated ? pred_b + (size_t)pair * n_b * 2 : nullptr;
  const int n_tiles = (n_b + kBN - 1) / kBN;

  // the A tile travels with the first B tiles' copy group
  for (int w = tid; w < BM * kChunks<T>; w += kThreads) {
    const int r = w / kChunks<T>, c = (w % kChunks<T>) * 16;
    mma_sync::cp_async16(&s.a[r * kLd + c], A + (size_t)r * kRow + c);
  }
  if (kGated && tid < BM / 2)
    mma_sync::cp_async16(&s.ua[4 * tid],
                         uv_a + ((size_t)pair * n_a + a0) * 2 + 4 * tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles)
      load_b<T, MODE>(s, st, Bm, nbp, pbp, st * kBN,
                      min(kBN, n_b - st * kBN), tid);
    mma_sync::cp_async_commit();
  }

  // the row top-2 of this thread's columns: K1's packed keys; K3's values
  // and indices (v1 <= v2), made into 64-bit keys at the end; the row sum
  // or minimum (in r1) of the probes' modes
  float na[MT][2];
  int r1[MT][2], r2[MT][2];
  float v1[MT][2], v2[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = (size_t)pair * n_a + a0 + wm + mt * 16 + h * 8 + g;
      na[mt][h] = kNorms ? na2[row] : 0.f;
      r1[mt][h] = r2[mt][h] = kSum ? 0 : MODE == kWide ? -1 : kKeyMax;
      v1[mt][h] = v2[mt][h] = __int_as_float(0x7F800000);
    }
  if (tid < kBN) {
    s.colmin[tid] = kKeyMax;
    s.colmin_w[tid] = kWideMax;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int next = t + STAGES - 1;
    if (next < n_tiles)             // its stage was consumed at t - 1
      load_b<T, MODE>(s, next % STAGES, Bm, nbp, pbp, next * kBN,
                      min(kBN, n_b - next * kBN), tid);
    mma_sync::cp_async_commit();
    mma_sync::cp_async_wait<STAGES - 1>();   // tile t (and A) arrived
    __syncthreads();
    const int st = t % STAGES;
    const int b0 = t * kBN;
    const int n_valid = min(kBN, n_b - b0);
    const unsigned char* sb = s.b[st];

    // f32: hi.hi into acc, the five smaller products into acc_lo, added
    // once a tile (see the head of this file)
    Acc acc[MT][NT][4];
    float acc_lo[kSplit ? MT : 1][kSplit ? NT : 1][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mt][nt][e] = Acc(0);
          if constexpr (kSplit) acc_lo[mt][nt][e] = 0.f;
        }
    // 32-byte k-steps: 16 bf16 or 32 int8 values each, in every plane
#pragma unroll
    for (int kb = 0; kb < kPlane; kb += 32) {
      constexpr int P = Op<T>::kPlanes;
      unsigned af[MT][P][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int p = 0; p < P; ++p)
          mma_sync::ldmatrix_x4(af[mt][p][0], af[mt][p][1], af[mt][p][2],
                                af[mt][p][3],
                                s.a + (wm + mt * 16 + (lane & 15)) * kLd +
                                    p * kPlane + kb + (lane >> 4) * 16);
      // per n8 pair and plane: (nt, bytes 0-15), (nt, 16-31), then nt + 1's
      auto load_bf = [&](unsigned* r, int nt, int p) {
        mma_sync::ldmatrix_x4(
            r[0], r[1], r[2], r[3],
            sb + (wn + nt * 8 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                p * kPlane + kb + ((lane >> 3) & 1) * 16);
      };
      if constexpr (kSplit) {
        // all of the k-step's B fragments first, so that each of the six
        // products has MT x NT independent accumulators to interleave
        unsigned bf[NT / 2][P][4];
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2)
#pragma unroll
          for (int p = 0; p < P; ++p) load_bf(bf[nt / 2][p], nt, p);
#pragma unroll
        for (int x = 0; x < 6; ++x)
#pragma unroll
          for (int nt = 0; nt < NT; nt += 2)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const unsigned* fa = af[mt][split_plane_a(x)];
              const unsigned* fb = bf[nt / 2][split_plane_b(x)];
              float* c0 = x < 5 ? acc_lo[mt][nt] : acc[mt][nt];
              float* c1 = x < 5 ? acc_lo[mt][nt + 1] : acc[mt][nt + 1];
              mma(c0, fa, fb[0], fb[1]);
              mma(c1, fa, fb[2], fb[3]);
            }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          unsigned bf[4];
          load_bf(bf, nt, 0);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma(acc[mt][nt], af[mt][0], bf[0], bf[1]);
            mma(acc[mt][nt + 1], af[mt][0], bf[2], bf[3]);
          }
        }
      }
    }

    if constexpr (kSplit) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], acc_lo[mt][nt][e]);
    }

    const float* snb = s.nb2[st];
    const float* spb = s.pb[st];
    // the gate's A positions, read here and not held through the product
    float ux[MT][2], uy[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mt * 16 + h * 8 + g;
        ux[mt][h] = kGated ? s.ua[2 * r] : 0.f;
        uy[mt][h] = kGated ? s.ua[2 * r + 1] : 0.f;
        if (kRestart) r1[mt][h] = r2[mt][h] = kKeyMax;
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (wn + nt * 8 >= n_valid) continue;   // beyond n_b: warp-uniform
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = wn + nt * 8 + 2 * q + e;
        const float nbv = kNorms ? snb[c] : 0.f;
        const float px = kGated ? spb[2 * c] : 0.f;
        const float py = kGated ? spb[2 * c + 1] : 0.f;
        int ck = kKeyMax;           // K1: the column's key
        float cv = __int_as_float(0x7F800000);   // K3: its value, index
        int ci = -1;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = a0 + wm + mt * 16 + h * 8 + g;
            // c0, c1 are row g, c2, c3 row g + 8
            const Acc dot = acc[mt][nt][2 * h + e];
            if constexpr (kSum) {
              r1[mt][h] = wrap_add(r1[mt][h], dot_int(dot));
            } else if constexpr (kMin) {
              // truncation is monotone: the minimum of the truncated dots
              // is the truncated minimum (the FFMA body's kRowMin)
              r1[mt][h] = min(r1[mt][h], dot_int(dot));
            } else if constexpr (MODE == kWide) {
              // (|a|^2 + |b|^2) - 2 a.b, as the reference and the plain
              // version; -0 → +0: equal values tie on index
              const float d2 = __fadd_rn(
                  __fsub_rn(__fadd_rn(na[mt][h], nbv), __fmul_rn(2.f, dot)),
                  0.f);
              // a thread meets its columns, and its rows, in increasing
              // index order, so a strict < on the value keeps the lowest
              // index among equal values: the 64-bit keys' order
              if (d2 < v1[mt][h]) {
                v2[mt][h] = v1[mt][h];
                r2[mt][h] = r1[mt][h];
                v1[mt][h] = d2;
                r1[mt][h] = b0 + c;
              } else if (d2 < v2[mt][h]) {
                v2[mt][h] = d2;
                r2[mt][h] = b0 + c;
              }
              if (d2 < cv) {
                cv = d2;
                ci = row;
              }
            } else {
              int bits;
              if constexpr (kInt8) {
                // |dot| <= 2^21 (2^22 at 256 values), so the f32 with the
                // bits of 1.5 x 2^23 + dot, less 1.5 x 2^23, is float(dot)
                // exactly (two
                // full-rate operations where I2F issues at a quarter of
                // the rate); na - 2 dot and d2 are integers below 2^24,
                // exact in f32 in any order
                const float dotf = __fsub_rn(
                    __int_as_float(0x4B400000 + dot), 12582912.f);
                const float d2 = __fadd_rn(
                    __fmaf_rn(-2.f, dotf, na[mt][h]), nbv);
                bits = __float_as_int(d2) & ~kIdxMask;
              } else {
                const float d2 = __fsub_rn(__fadd_rn(na[mt][h], nbv),
                                           __fmul_rn(2.f, dot));
                bits = __float_as_int(fmaxf(d2, 0.f)) & ~kIdxMask;
              }
              if (kGated &&
                  gated_out(ux[mt][h], uy[mt][h], px, py, radius2))
                bits = kGatedBits;
              // insert2 on unique keys, as min/max
              const int rk = bits | (b0 + c);
              if (!kFirst) r2[mt][h] = min(r2[mt][h], max(r1[mt][h], rk));
              r1[mt][h] = min(r1[mt][h], rk);
              if (kKeys) ck = min(ck, bits | row);
            }
          }
        // the column over the warp's 32 rows: the lanes of one q
        if constexpr (MODE == kWide) {
          long long cw = wide_key(cv, ci);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            cw = kmin(cw, __shfl_xor_sync(0xffffffffu, cw, off));
          if (g == 0) atomicMin(&s.colmin_w[c], cw);
        } else if constexpr (kKeys) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            ck = min(ck, __shfl_xor_sync(0xffffffffu, ck, off));
          if (g == 0) atomicMin(&s.colmin[c], ck);
        }
      }
    }
    __syncthreads();                // tile t consumed; its columns complete
    if (kKeys && tid < n_valid) {
      const size_t j = (size_t)pair * n_b + b0 + tid;
      if constexpr (MODE == kWide) {
        atomicMin(&col_k[j], s.colmin_w[tid]);
        s.colmin_w[tid] = kWideMax;
      } else {
        atomicMin(&col_p[j], s.colmin[tid]);
        s.colmin[tid] = kKeyMax;
      }
    }
  }
  mma_sync::cp_async_wait<0>();     // only empty groups remain

  // row top-2 as keys (or row sums or minima), merged over the quad's
  // lanes, then over the WN warps of a row in warp order through the (now
  // free) ring
  K k1[MT][2], k2[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (MODE == kWide) {  // -1: no candidate in this thread
        k1[mt][h] = r1[mt][h] < 0 ? kWideMax : wide_key(v1[mt][h], r1[mt][h]);
        k2[mt][h] = r2[mt][h] < 0 ? kWideMax : wide_key(v2[mt][h], r2[mt][h]);
      } else {
        k1[mt][h] = r1[mt][h];
        k2[mt][h] = r2[mt][h];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const K o1 = __shfl_xor_sync(0xffffffffu, k1[mt][h], off);
        if constexpr (kSum) {
          k1[mt][h] = wrap_add(k1[mt][h], o1);
        } else if constexpr (kOneKey) {
          k1[mt][h] = min(k1[mt][h], o1);
        } else {
          const K o2 = __shfl_xor_sync(0xffffffffu, k2[mt][h], off);
          merge2(o1, o2, k1[mt][h], k2[mt][h]);
        }
      }
    }
  K* red = reinterpret_cast<K*>(s.b[0]);    // [WN][BM][2]
  if (q == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ((warp / WM) * BM + wm + mt * 16 + h * 8 + g) * 2;
        red[r] = k1[mt][h];
        red[r + 1] = k2[mt][h];
      }
  }
  __syncthreads();
  if (tid < BM) {
    K k1 = red[2 * tid], k2 = red[2 * tid + 1];
#pragma unroll
    for (int w = 1; w < WN; ++w) {
      if constexpr (kSum)
        k1 = wrap_add(k1, red[2 * (w * BM + tid)]);
      else if constexpr (kOneKey)
        k1 = min(k1, red[2 * (w * BM + tid)]);
      else
        merge2(red[2 * (w * BM + tid)], red[2 * (w * BM + tid) + 1], k1, k2);
    }
    const size_t r = ((size_t)pair * n_a + a0 + tid) * 2;
    if constexpr (MODE == kWide) {
      row_k[r] = k1;
      row_k[r + 1] = k2;
    } else {
      row_p[r] = k1;
      row_p[r + 1] = kTwoKeys ? k2 : k1;
      // P2's pb from the best index this thread holds, not re-read from
      // row_p: uv_b in pred_b, pb in row_k (fused_epilogue); int offsets,
      // below 65535 x 8192
      if constexpr (fused(MODE) && !(MODE & kFusedNoPb)) {
        const int p = ctaid_y();
        reinterpret_cast<float2*>(row_k)[p * n_a + a0 + tid] =
            reinterpret_cast<const float2*>(pred_b)[p * n_b + (k1 & kIdxMask)];
      }
    }
  }
  if constexpr (fused(MODE) && !(MODE & kFusedNoEpi))
    fused_epilogue<MODE>(row_p, col_p, uv_a, col_k, n_b);
}

// The kernel's dynamic shared memory: above 48 KB only after this opt-in
template <typename T, int MODE, int BM, int BN, int STAGES>
cudaError_t opt_in_smem() {
  return cudaFuncSetAttribute(knn_tc_kernel<T, MODE, BM, BN, STAGES>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(Smem<T, BM, BN, STAGES>));
}

template <typename T, int MODE, int BM, int BN = Op<T>::kBN,
          int STAGES = kStages>
int launch_tile(const void* a, const void* b, const void* na2,
                const void* nb2, const void* uv_a, const void* pred_b,
                float radius2, void* row_p, void* col_p, void* row_k,
                void* col_k, int n_pairs, int n_a, int n_b,
                cudaStream_t stream) {
  constexpr int kSmem = (int)sizeof(Smem<T, BM, BN, STAGES>);
  // a refusal is returned, never lost
  const cudaError_t e = opt_in_smem<T, MODE, BM, BN, STAGES>();
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_a / BM, n_pairs);
  knn_tc_kernel<T, MODE, BM, BN, STAGES><<<grid, kThreads, kSmem, stream>>>(
      (const T*)a, (const T*)b, (const float*)na2, (const float*)nb2,
      (const float*)uv_a, (const float*)pred_b, radius2, (int*)row_p,
      (int*)col_p, (long long*)row_k, (long long*)col_k, n_a, n_b);
  return (int)cudaGetLastError();
}

// Blocks of the tile that can be resident on one SM at once, as the
// occupancy calculator counts them after the shared-memory opt-in; a
// negative cudaError_t where a call fails
template <typename T, int MODE, int BM, int BN, int STAGES>
int tile_blocks_per_sm() {
  cudaError_t e = opt_in_smem<T, MODE, BM, BN, STAGES>();
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, knn_tc_kernel<T, MODE, BM, BN, STAGES>, kThreads,
        (int)sizeof(Smem<T, BM, BN, STAGES>));
  return e == cudaSuccess ? n : -(int)e;
}

// The mma.sync body in MODE over T as launch_tc sent it there before the
// wgmma body (now knn_probe.cu's yardsticks): f32 at 256 64 A rows and one
// 64-row B tile; else 128 A rows a block where n_a allows, else 64, the
// type's B tiles in a ring of two. Returns the cudaError_t of the launch.
template <typename T, int MODE>
int launch_mma(const void* a, const void* b, const void* na2,
               const void* nb2, const void* uv_a, const void* pred_b,
               float radius2, void* row_p, void* col_p, void* row_k,
               void* col_k, int n_pairs, int n_a, int n_b,
               cudaStream_t stream) {
  if constexpr (std::is_same<T, D256<Bf16x3>>::value) {
    return launch_tile<T, MODE, 64, 64, 1>(a, b, na2, nb2, uv_a, pred_b,
                                           radius2, row_p, col_p, row_k,
                                           col_k, n_pairs, n_a, n_b, stream);
  } else {
    if (n_a % 128 == 0)
      return launch_tile<T, MODE, 128>(a, b, na2, nb2, uv_a, pred_b,
                                       radius2, row_p, col_p, row_k, col_k,
                                       n_pairs, n_a, n_b, stream);
    return launch_tile<T, MODE, 64>(a, b, na2, nb2, uv_a, pred_b, radius2,
                                    row_p, col_p, row_k, col_k, n_pairs, n_a,
                                    n_b, stream);
  }
}

}  // namespace tc
}  // namespace knn

// the wgmma body (launch_tc below), which uses tc's keys and merges
#include "knn_wg.cuh"

namespace knn {

// f32 rows → their three bf16 planes (the split pre-pass, knn_packed.cu):
// x (rows, dim) f32, 16-byte aligned → out (rows, 3, dim) bf16 bits; dim
// 128 or 256. Returns the cudaError_t of the launch.
int launch_split(const void* x, void* out, long long rows,
                 cudaStream_t stream, int dim = kDim);

// Squared norms of int8 rows (K1 int8's pre-pass, knn_packed.cu): x (rows,
// dim) int8, 16-byte aligned → out (rows) f32, exact, plus bias (an
// integer: the sum stays exact; wg::nb_bias); dim 128 or 256. Returns the
// cudaError_t of the launch.
int launch_row_norms_i8(const void* x, void* out, long long rows,
                        cudaStream_t stream, int dim = kDim,
                        float bias = 0.f);

// The tensor-core body in MODE over T (uint16_t: bf16 bits, int8_t, Bf16x3:
// the split rows of launch_split; D256<T>: T at 256 values a row): the
// wgmma body (knn_wg.cuh) for every type at either width, in K1's modes
// (kPacked, kPackedGated), K3's (kWide; bf16 and f32) and the product-only
// stage (kProductRowSum). a, b (n_pairs, n, 128 or 256) T; na2, nb2 the
// f32 squared norms (unused by kProductRowSum; int8's B norms biased by
// wg::nb_bias); uv_a, pred_b f32 for kPackedGated; n_a and n_b multiples
// of 64 (the caller checks the shapes). The mma.sync body it replaced is
// tc::launch_mma, which only knn_probe.cu's yardsticks call. Returns the
// cudaError_t of the launch.
template <typename T, int MODE>
int launch_tc(const void* a, const void* b, const void* na2,
              const void* nb2, const void* uv_a, const void* pred_b,
              float radius2, void* row_p, void* col_p, void* row_k,
              void* col_k, int n_pairs, int n_a, int n_b,
              cudaStream_t stream) {
  return wg::launch<T, MODE>(a, b, na2, nb2, uv_a, pred_b, radius2, row_p,
                             col_p, row_k, col_k, n_pairs, n_a, n_b, stream);
}

}  // namespace knn
