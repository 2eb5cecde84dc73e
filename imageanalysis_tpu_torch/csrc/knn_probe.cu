// Probes of K1's anatomy, for Hopper (sm_90a): K1 cut down stage by stage
// and swept over block tiles, on the bodies K1 ran before its tensor-core
// body (knn_common.cuh) and, for P3's stages and P6's sweep, on the
// tensor-core body itself (knn_tc.cuh).
//
// Replaces the TPU dev probes
//   scripts_dev/knn_stage_cost.py:31      kernel       (P4: K1 by stage)
//   scripts_dev/knn_culprit_bisect.py:42  kernel       (P3: K1 built up)
//   scripts_dev/knn_overhead_sweep.py:36  kernel       (P6: product + row
//                                                       min over tiles)
// Each computed K1's 2-NN of a 64-pair batch of 6144 x 128 descriptors with
// parts of the kernel switched off, to see where its time goes. Here the
// parts are the Stage values of knn_common.cuh, compiled into its int8
// body (__dp4a) and its float body (f32 FMAs on bf16 operands): product +
// row sum, product + row min, + d2/pack/top-1, + top-2 restarted at every
// B tile, + the running top-2, + the column atomicMin. knn_probe runs them
// on the bodies K1 ran before its tensor-core body (knn_tc.cuh), so each
// dtype's anatomy there is one body's; knn_tc_stage runs P3's five (row
// min on) on the mma.sync body, at its K1 tile (its modes kProductRowMin,
// kProductTop1, kProductTop2Tile, kProductTop2 and kPacked, its K1: K1
// itself now runs the wgmma body), the old bodies' anatomy kept as its
// yardstick. The full stages equal K1's result bit for bit.
// knn_bf16_d256, knn_i8_d256 and knn_f32_d256 run bf16, int8 and f32
// rows of 256 values, knn_bf16_d128, knn_i8_d128 and knn_f32_d128 bf16,
// int8 and f32 rows of 128, on the mma.sync body (what K1 and K3 launched
// there before knn_wg.cuh's wgmma body, kept as its yardstick) or on the
// wgmma body, in K1's and K3's modes (int8: K1's only) and the
// product-only stage (the product / key-epilogue split).
// knn_dp4a_i8 (K1's int8 modes, plain and gated), knn_ffma_bf16 (K1's and
// K3's bf16 modes: plain, gated, wide) and knn_ffma_f32 (K1's and K3's f32
// modes: plain, gated, wide) launch the old bodies as the tensor-core
// body's yardsticks. On the tensor-core body:
// knn_tc_row_sum, the mma.sync body's product-only stage (product +
// wrapping row sum, kRowSum's result) in any of its types, and
// knn_tc_row_min, P6's product
// + row min (kRowMin's result) at each tile of P6's sweep.
//
// What bounds it on the H100: arithmetic, as K1 (2 x 6144^2 x 128 x 64 =
// 618.5 G multiply-adds at bench's shape). The stages differ only in the
// per-element epilogue after the dots, which is what they measure. On the
// tensor-core body the product is cheap (a third of int8 K1), so the
// stages split the key epilogue itself: d2 + pack + top-1, the second
// key, the running merge, the column. A stage computes only what it writes
// (nvcc drops the rest), so each is a cut of K1's work, not K1 with
// outputs switched off.
//
// Tiles of the old bodies: TA A rows per block x TB B rows per streamed
// shared-memory tile, 256 threads. int8 at (32, 32), (32, 64), (64, 32),
// (64, 64) = K1, (128, 64), (64, 128), (128, 128); bf16 at (16, 64), (32,
// 32), (32, 64), (64, 32), (64, 64) = the FFMA K1's, (16, 128), (32, 128)
// (the float body keeps A as f32 in shared memory: TA x TB beyond that
// passes the 48 KB of static shared memory). Every stage at (64, 64), the
// row-min stage at every tile; any other combination returns
// cudaErrorInvalidValue. Tiles of the tensor-core body, (BM, BN, ring
// stages), int8 and bf16 alike: (64, 64, 2), (128, 64, 2), (64, 128, 2),
// (128, 128, 2) = K1, (128, 128, 3), (256, 64, 2), (256, 128, 2).

#include "knn_common.cuh"

namespace {

using namespace knn;

struct Args {
  const void* a;
  const void* b;
  const void* na2;
  const void* nb2;
  void* row_p;
  void* col_p;
  int n_pairs, n_a, n_b;
  cudaStream_t stream;
};

template <int STAGE, int TA, int TB>
int launch_i8(const Args& x) {
  dim3 grid(x.n_a / TA, x.n_pairs);
  knn_i8_kernel<false, STAGE, TA, TB><<<grid, kThreads, 0, x.stream>>>(
      (const int*)x.a, (const int*)x.b, nullptr, nullptr, 0.f,
      (int*)x.row_p, (int*)x.col_p, x.n_a, x.n_b);
  return (int)cudaGetLastError();
}

template <int STAGE, int TA, int TB>
int launch_bf16(const Args& x) {
  dim3 grid(x.n_a / TA, x.n_pairs);
  knn_float_kernel<uint16_t, kPacked, STAGE, TA, TB>
      <<<grid, kThreads, 0, x.stream>>>(
          (const uint16_t*)x.a, (const uint16_t*)x.b, (const float*)x.na2,
          (const float*)x.nb2, nullptr, nullptr, 0.f, (int*)x.row_p,
          (int*)x.col_p, nullptr, nullptr, x.n_a, x.n_b);
  return (int)cudaGetLastError();
}

template <int STAGE>
int stage_at_k1_tile(const Args& x, bool bf16) {
  return bf16 ? launch_bf16<STAGE, 64, 64>(x) : launch_i8<STAGE, 64, 64>(x);
}

int row_min_i8(const Args& x, int ta, int tb) {
  if (ta == 32 && tb == 32) return launch_i8<kRowMin, 32, 32>(x);
  if (ta == 32 && tb == 64) return launch_i8<kRowMin, 32, 64>(x);
  if (ta == 64 && tb == 32) return launch_i8<kRowMin, 64, 32>(x);
  if (ta == 64 && tb == 64) return launch_i8<kRowMin, 64, 64>(x);
  if (ta == 128 && tb == 64) return launch_i8<kRowMin, 128, 64>(x);
  if (ta == 64 && tb == 128) return launch_i8<kRowMin, 64, 128>(x);
  if (ta == 128 && tb == 128) return launch_i8<kRowMin, 128, 128>(x);
  return (int)cudaErrorInvalidValue;
}

int row_min_bf16(const Args& x, int ta, int tb) {
  if (ta == 16 && tb == 64) return launch_bf16<kRowMin, 16, 64>(x);
  if (ta == 32 && tb == 32) return launch_bf16<kRowMin, 32, 32>(x);
  if (ta == 32 && tb == 64) return launch_bf16<kRowMin, 32, 64>(x);
  if (ta == 64 && tb == 32) return launch_bf16<kRowMin, 64, 32>(x);
  if (ta == 64 && tb == 64) return launch_bf16<kRowMin, 64, 64>(x);
  if (ta == 16 && tb == 128) return launch_bf16<kRowMin, 16, 128>(x);
  if (ta == 32 && tb == 128) return launch_bf16<kRowMin, 32, 128>(x);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a, b (n_pairs, n_a | n_b, 128): int8 (bf16 == 0) or bf16 bits (bf16 !=
// 0, integer-valued; na2, nb2 (n_pairs, n) f32 squared norms, read from
// kTop1 on); row_p (n_pairs, n_a, 2) int32; col_p (n_pairs, n_b) int32
// pre-filled with 0x7FFFFFFF, written by the full stage only. n_a a
// multiple of ta, n_b of tb, both <= 8192. Returns the cudaError_t of the
// launch.
extern "C" int knn_probe(const void* a, const void* b, const void* na2,
                         const void* nb2, void* row_p, void* col_p,
                         int n_pairs, int n_a, int n_b, int bf16, int stage,
                         int ta, int tb, void* stream) {
  if (n_pairs <= 0 || n_pairs > 65535 || n_a <= 0 || n_b <= 0 ||
      n_a > kIdxMask + 1 || n_b > kIdxMask + 1 || ta <= 0 || tb <= 0 ||
      n_a % ta || n_b % tb)
    return (int)cudaErrorInvalidValue;
  const Args x{a, b, na2, nb2, row_p, col_p, n_pairs, n_a, n_b,
               (cudaStream_t)stream};
  const bool k1_tile = ta == kTA && tb == kTB;
  if (stage == kRowMin)
    return bf16 ? row_min_bf16(x, ta, tb) : row_min_i8(x, ta, tb);
  if (!k1_tile) return (int)cudaErrorInvalidValue;
  switch (stage) {
    case kRowSum: return stage_at_k1_tile<kRowSum>(x, bf16);
    case kTop1: return stage_at_k1_tile<kTop1>(x, bf16);
    case kTop2Tile: return stage_at_k1_tile<kTop2Tile>(x, bf16);
    case kTop2: return stage_at_k1_tile<kTop2>(x, bf16);
    case kFull: return stage_at_k1_tile<kFull>(x, bf16);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The FFMA float body (knn_float_kernel) on bf16 bits in K1's modes (wide
// == 0: packed keys into row_p / col_p, gated when uv_a != NULL) or K3's
// (wide != 0: 64-bit keys into row_k / col_k): what K1 and K3 launched for
// bf16 before the tensor-core body. Arguments as knn_packed_float and
// knn_wide. Returns the cudaError_t of the launch.
extern "C" int knn_ffma_bf16(const void* a, const void* b, const void* na2,
                             const void* nb2, const void* uv_a,
                             const void* pred_b, float radius2, void* row_p,
                             void* col_p, void* row_k, void* col_k,
                             int n_pairs, int n_a, int n_b, int wide,
                             void* stream) {
  if (bad_shape(n_pairs, n_a, n_b, wide ? 1 << 30 : kIdxMask + 1))
    return (int)cudaErrorInvalidValue;
  dim3 grid(n_a / kTA, n_pairs);
  cudaStream_t s = (cudaStream_t)stream;
  const uint16_t* pa = (const uint16_t*)a;
  const uint16_t* pb = (const uint16_t*)b;
  if (wide)
    knn_float_kernel<uint16_t, kWide><<<grid, kThreads, 0, s>>>(
        pa, pb, (const float*)na2, (const float*)nb2, nullptr, nullptr, 0.f,
        nullptr, nullptr, (long long*)row_k, (long long*)col_k, n_a, n_b);
  else if (uv_a)
    knn_float_kernel<uint16_t, kPackedGated><<<grid, kThreads, 0, s>>>(
        pa, pb, (const float*)na2, (const float*)nb2, (const float*)uv_a,
        (const float*)pred_b, radius2, (int*)row_p, (int*)col_p, nullptr,
        nullptr, n_a, n_b);
  else
    knn_float_kernel<uint16_t, kPacked><<<grid, kThreads, 0, s>>>(
        pa, pb, (const float*)na2, (const float*)nb2, nullptr, nullptr, 0.f,
        (int*)row_p, (int*)col_p, nullptr, nullptr, n_a, n_b);
  return (int)cudaGetLastError();
}

// The __dp4a int8 body in K1's int8 modes (gated when uv_a != NULL): what
// K1 launched for int8 before the tensor-core body. Arguments as
// knn_packed_i8_gated, without the norms' scratch. Returns the
// cudaError_t of the launch.
extern "C" int knn_dp4a_i8(const void* a, const void* b, const void* uv_a,
                           const void* pred_b, float radius2, void* row_p,
                           void* col_p, int n_pairs, int n_a, int n_b,
                           void* stream) {
  if (bad_shape(n_pairs, n_a, n_b, kIdxMask + 1))
    return (int)cudaErrorInvalidValue;
  dim3 grid(n_a / kTA, n_pairs);
  cudaStream_t s = (cudaStream_t)stream;
  if (uv_a)
    knn_i8_kernel<true, kFull, kTA, kTB><<<grid, kThreads, 0, s>>>(
        (const int*)a, (const int*)b, (const float*)uv_a,
        (const float*)pred_b, radius2, (int*)row_p, (int*)col_p, n_a, n_b);
  else
    knn_i8_kernel<false, kFull, kTA, kTB><<<grid, kThreads, 0, s>>>(
        (const int*)a, (const int*)b, nullptr, nullptr, 0.f, (int*)row_p,
        (int*)col_p, n_a, n_b);
  return (int)cudaGetLastError();
}

// The FFMA float body (knn_float_kernel) on f32 descriptors in K1's modes
// (wide == 0: packed keys into row_p / col_p, gated when uv_a != NULL) or
// K3's (wide != 0: 64-bit keys into row_k / col_k): what K1 and K3
// launched for f32 before the tensor-core body. Arguments as
// knn_packed_float and knn_wide without the split scratch. Returns the
// cudaError_t of the launch.
extern "C" int knn_ffma_f32(const void* a, const void* b, const void* na2,
                            const void* nb2, const void* uv_a,
                            const void* pred_b, float radius2, void* row_p,
                            void* col_p, void* row_k, void* col_k,
                            int n_pairs, int n_a, int n_b, int wide,
                            void* stream) {
  if (bad_shape(n_pairs, n_a, n_b, wide ? 1 << 30 : kIdxMask + 1))
    return (int)cudaErrorInvalidValue;
  dim3 grid(n_a / kTA, n_pairs);
  cudaStream_t s = (cudaStream_t)stream;
  const float* pa = (const float*)a;
  const float* pb = (const float*)b;
  if (wide)
    knn_float_kernel<float, kWide><<<grid, kThreads, 0, s>>>(
        pa, pb, (const float*)na2, (const float*)nb2, nullptr, nullptr, 0.f,
        nullptr, nullptr, (long long*)row_k, (long long*)col_k, n_a, n_b);
  else if (uv_a)
    knn_float_kernel<float, kPackedGated><<<grid, kThreads, 0, s>>>(
        pa, pb, (const float*)na2, (const float*)nb2, (const float*)uv_a,
        (const float*)pred_b, radius2, (int*)row_p, (int*)col_p, nullptr,
        nullptr, n_a, n_b);
  else
    knn_float_kernel<float, kPacked><<<grid, kThreads, 0, s>>>(
        pa, pb, (const float*)na2, (const float*)nb2, nullptr, nullptr, 0.f,
        (int*)row_p, (int*)col_p, nullptr, nullptr, n_a, n_b);
  return (int)cudaGetLastError();
}

// The mma.sync body's product-only stage (kProductRowSum): row_p
// (n_pairs, n_a, 2) int32 gets each A row's wrapping sum of its dots with
// all n_b B rows in both slots. a, b int8 (dtype 0), integer-valued bf16
// bits (1) or integer-valued f32 (2, split first into split_a (n_pairs,
// n_a, 3, 128) and split_b (n_pairs, n_b, 3, 128) bf16 scratch, unused
// otherwise), 16-byte aligned; n_a and n_b multiples of 64, of any size
// (K1's and K3's shapes). P4's stage 0; the wgmma body's product-only
// stage at 128, the one K1 and K3 run, is knn_i8_d128's, knn_bf16_d128's
// and knn_f32_d128's. Returns the cudaError_t of the launch.
extern "C" int knn_tc_row_sum(const void* a, const void* b, void* split_a,
                              void* split_b, void* row_p, int n_pairs,
                              int n_a, int n_b, int dtype, void* stream) {
  if (bad_shape(n_pairs, n_a, n_b, 1 << 30) || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define ROW_SUM_ARGS                                                       \
  a, b, nullptr, nullptr, nullptr, nullptr, 0.f, row_p, nullptr, nullptr, \
      nullptr, n_pairs, n_a, n_b, s
  if (dtype == 1)
    return tc::launch_mma<uint16_t, kProductRowSum>(ROW_SUM_ARGS);
  if (dtype == 0)
    return tc::launch_mma<int8_t, kProductRowSum>(ROW_SUM_ARGS);
#undef ROW_SUM_ARGS
  int e = launch_split(a, split_a, (long long)n_pairs * n_a, s);
  if (e == 0) e = launch_split(b, split_b, (long long)n_pairs * n_b, s);
  if (e != 0) return e;
  return tc::launch_mma<Bf16x3, kProductRowSum>(
      split_a, split_b, nullptr, nullptr, nullptr, nullptr, 0.f, row_p,
      nullptr, nullptr, nullptr, n_pairs, n_a, n_b, s);
}

namespace {

struct RowMinArgs {
  const void* a;
  const void* b;
  void* row_p;
  int n_pairs, n_a, n_b;
  cudaStream_t stream;
};

// one tile of P6's sweep: its launch, or (x == NULL) its blocks an SM
template <typename T, int BM, int BN, int STAGES>
int row_min_tile(const RowMinArgs* x) {
  if (!x) return tc::tile_blocks_per_sm<T, kProductRowMin, BM, BN, STAGES>();
  return tc::launch_tile<T, kProductRowMin, BM, BN, STAGES>(
      x->a, x->b, nullptr, nullptr, nullptr, nullptr, 0.f, x->row_p, nullptr,
      nullptr, nullptr, x->n_pairs, x->n_a, x->n_b, x->stream);
}

template <typename T>
int row_min_tc(const RowMinArgs* x, int bm, int bn, int stages) {
  if (bm == 64 && bn == 64 && stages == 2)
    return row_min_tile<T, 64, 64, 2>(x);
  if (bm == 128 && bn == 64 && stages == 2)
    return row_min_tile<T, 128, 64, 2>(x);
  if (bm == 64 && bn == 128 && stages == 2)
    return row_min_tile<T, 64, 128, 2>(x);
  if (bm == 128 && bn == 128 && stages == 2)
    return row_min_tile<T, 128, 128, 2>(x);
  if (bm == 128 && bn == 128 && stages == 3)
    return row_min_tile<T, 128, 128, 3>(x);
  if (bm == 256 && bn == 64 && stages == 2)
    return row_min_tile<T, 256, 64, 2>(x);
  if (bm == 256 && bn == 128 && stages == 2)
    return row_min_tile<T, 256, 128, 2>(x);
  return x ? (int)cudaErrorInvalidValue : -(int)cudaErrorInvalidValue;
}

}  // namespace

// P6 on the tensor-core body (kProductRowMin) at tile (bm, bn, stages) of
// the sweep above: row_p (n_pairs, n_a, 2) int32 gets each A row's minimum
// dot with all n_b B rows, as an int, in both slots. a, b int8 (bf16 == 0)
// or integer-valued bf16 bits (bf16 != 0), 16-byte aligned; n_a a
// multiple of bm, n_b of 64. Returns the cudaError_t of the launch.
extern "C" int knn_tc_row_min(const void* a, const void* b, void* row_p,
                              int n_pairs, int n_a, int n_b, int bf16,
                              int bm, int bn, int stages, void* stream) {
  if (bad_shape(n_pairs, n_a, n_b, 1 << 30) || bm <= 0 || n_a % bm)
    return (int)cudaErrorInvalidValue;
  const RowMinArgs x{a, b, row_p, n_pairs, n_a, n_b, (cudaStream_t)stream};
  return bf16 ? row_min_tc<uint16_t>(&x, bm, bn, stages)
              : row_min_tc<int8_t>(&x, bm, bn, stages);
}

// Blocks of knn_tc_row_min's tile (bm, bn, stages) resident on one SM
// (the occupancy calculator's count); a negative cudaError_t on failure
extern "C" int knn_tc_row_min_blocks(int bf16, int bm, int bn, int stages) {
  return bf16 ? row_min_tc<uint16_t>(nullptr, bm, bn, stages)
              : row_min_tc<int8_t>(nullptr, bm, bn, stages);
}

namespace {

// one of P3's stages on the tensor-core body at K1's tile (128, 128, 2)
template <typename T, int MODE>
int tc_stage_launch(const Args& x) {
  return tc::launch_tile<T, MODE, 128>(
      x.a, x.b, x.na2, x.nb2, nullptr, nullptr, 0.f, x.row_p, x.col_p,
      nullptr, nullptr, x.n_pairs, x.n_a, x.n_b, x.stream);
}

template <typename T>
int tc_stage(const Args& x, int stage) {
  switch (stage) {
    case kRowMin: return tc_stage_launch<T, kProductRowMin>(x);
    case kTop1: return tc_stage_launch<T, kProductTop1>(x);
    case kTop2Tile: return tc_stage_launch<T, kProductTop2Tile>(x);
    case kTop2: return tc_stage_launch<T, kProductTop2>(x);
    case kFull: return tc_stage_launch<T, kPacked>(x);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K1's own entry points (knn_packed.cu), for the wgmma body's keyed modes:
// K1's code, not a second instantiation of it here
extern "C" int knn_packed_i8(const void* a, const void* b, void* na2,
                             void* nb2, void* row_p, void* col_p,
                             int n_pairs, int n_a, int n_b, int dim,
                             void* stream);
extern "C" int knn_packed_float(const void* a, const void* b,
                                const void* na2, const void* nb2,
                                const void* uv_a, const void* pred_b,
                                float radius2, void* row_p, void* col_p,
                                void* split_a, void* split_b, int n_pairs,
                                int n_a, int n_b, int bf16, int dim,
                                void* stream);
extern "C" int knn_packed_i8_gated(const void* a, const void* b, void* na2,
                                   void* nb2, const void* uv_a,
                                   const void* pred_b, float radius2,
                                   void* row_p, void* col_p, int n_pairs,
                                   int n_a, int n_b, int dim, void* stream);

// P3: K1 up to `stage` (a Stage of knn_common.cuh: row_min .. full) on
// the mma.sync body at its K1 tile (128, 128, 2): row_min the product
// with the row minimum of the dots (kProductRowMin), top1, top2_tile and
// top2 K1's packed keys with part of its epilogue (kProductTop1,
// kProductTop2Tile, kProductTop2), full its own K1 (kPacked on this body,
// so that every stage is one body's; K1 itself runs knn_wg.cuh's wgmma
// body). a, b (n_pairs, n_a | n_b, 128) int8 (dtype 0) or
// integer-valued bf16 bits (1), 16-byte aligned; na2, nb2 (n_pairs, n) f32:
// bf16's squared norms from top1 on, int8's scratch, which the norms
// pre-pass of K1 fills first from top1 on (as K1 int8 does); row_p
// (n_pairs, n_a, 2) int32; col_p (n_pairs, n_b) int32 pre-filled with
// 0x7FFFFFFF, written by full only. n_a a multiple of 128, n_b of 64,
// both <= 8192. Returns the cudaError_t of the first failed launch.
extern "C" int knn_tc_stage(const void* a, const void* b, void* na2,
                            void* nb2, void* row_p, void* col_p, int n_pairs,
                            int n_a, int n_b, int dtype, int stage,
                            void* stream) {
  if (bad_shape(n_pairs, n_a, n_b, kIdxMask + 1) || n_a % 128 ||
      dtype < 0 || dtype > 1 || stage < kRowMin || stage > kFull)
    return (int)cudaErrorInvalidValue;
  const Args x{a, b, na2, nb2, row_p, col_p, n_pairs, n_a, n_b,
               (cudaStream_t)stream};
  if (dtype == 1) return tc_stage<uint16_t>(x, stage);
  if (stage >= kTop1) {
    int e = launch_row_norms_i8(a, na2, (long long)n_pairs * n_a, x.stream);
    if (e == 0)
      e = launch_row_norms_i8(b, nb2, (long long)n_pairs * n_b, x.stream);
    if (e != 0) return e;
  }
  return tc_stage<int8_t>(x, stage);
}

// K3's own entry point (knn_wide.cu), for the wgmma body's keyed K3 mode
extern "C" int knn_wide(const void* a, const void* b, const void* na2,
                        const void* nb2, void* row_k, void* col_k,
                        void* split_a, void* split_b, int n_pairs, int n_a,
                        int n_b, int bf16, int dim, void* stream);

namespace {

#define BODY_ARGS                                                         \
  a, b, na2, nb2, uv_a, pred_b, radius2, row_p, col_p, row_k, col_k,      \
      n_pairs, n_a, n_b

// the mma.sync body at T (uint16_t, int8_t, Bf16x3 at 128 values a row;
// D256<T> at 256), as launch_tc sent those rows to it before the wgmma
// body (tc::launch_mma), in mode (kPacked, gated where uv_a != NULL;
// kWide; kProductRowSum)
template <typename T>
int mma_mode(const void* a, const void* b, const void* na2, const void* nb2,
             const void* uv_a, const void* pred_b, float radius2,
             void* row_p, void* col_p, void* row_k, void* col_k, int n_pairs,
             int n_a, int n_b, int mode, cudaStream_t s) {
  if (mode == kPacked && uv_a)
    return tc::launch_mma<T, kPackedGated>(BODY_ARGS, s);
  if (mode == kPacked) return tc::launch_mma<T, kPacked>(BODY_ARGS, s);
  if constexpr (!std::is_same<typename Elem<T>::type, int8_t>::value)
    if (mode == kWide) return tc::launch_mma<T, kWide>(BODY_ARGS, s);
  return tc::launch_mma<T, kProductRowSum>(BODY_ARGS, s);
}

bool bad_mode(int n_pairs, int n_a, int n_b, int mode, int body,
              bool wide) {
  return bad_shape(n_pairs, n_a, n_b,
                   mode == kPacked ? kIdxMask + 1 : 1 << 30) ||
         (mode != kPacked && !(wide && mode == kWide) &&
          mode != kProductRowSum) ||
         (body != 0 && body != 1);
}

// bf16 rows of dim values (H: uint16_t at 128, D256<uint16_t> at 256) on
// either body, as knn_bf16_d256 below
template <typename H>
int bf16_bodies(const void* a, const void* b, const void* na2,
                const void* nb2, const void* uv_a, const void* pred_b,
                float radius2, void* row_p, void* col_p, void* row_k,
                void* col_k, int n_pairs, int n_a, int n_b, int mode,
                int body, int dim, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (body == 1) {
    if (mode == kPacked)
      return knn_packed_float(a, b, na2, nb2, uv_a, pred_b, radius2, row_p,
                              col_p, nullptr, nullptr, n_pairs, n_a, n_b, 1,
                              dim, stream);
    if (mode == kWide)
      return knn_wide(a, b, na2, nb2, row_k, col_k, nullptr, nullptr,
                      n_pairs, n_a, n_b, 1, dim, stream);
    return launch_tc<H, kProductRowSum>(BODY_ARGS, s);
  }
  return mma_mode<H>(BODY_ARGS, mode, s);
}

// int8 rows of dim values (I8: int8_t at 128, D256<int8_t> at 256) on
// either body, as knn_i8_d256 below
template <typename I8>
int i8_bodies(const void* a, const void* b, void* na2, void* nb2,
              const void* uv_a, const void* pred_b, float radius2,
              void* row_p, void* col_p, int n_pairs, int n_a, int n_b,
              int mode, int body, int dim, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  void* row_k = nullptr;
  void* col_k = nullptr;
  if (mode == kProductRowSum)
    return body == 1 ? launch_tc<I8, kProductRowSum>(BODY_ARGS, s)
                     : mma_mode<I8>(BODY_ARGS, mode, s);
  if (body == 1)
    return uv_a ? knn_packed_i8_gated(a, b, na2, nb2, uv_a, pred_b, radius2,
                                      row_p, col_p, n_pairs, n_a, n_b, dim,
                                      stream)
                : knn_packed_i8(a, b, na2, nb2, row_p, col_p, n_pairs, n_a,
                                n_b, dim, stream);
  // the mma.sync body takes the norms as they are (no bias)
  int e = launch_row_norms_i8(a, na2, (long long)n_pairs * n_a, s, dim);
  if (e == 0)
    e = launch_row_norms_i8(b, nb2, (long long)n_pairs * n_b, s, dim);
  if (e != 0) return e;
  return mma_mode<I8>(BODY_ARGS, mode, s);
}

#undef BODY_ARGS

}  // namespace

// bf16 rows of 256 values on either body: body 0 the mma.sync body
// (knn_tc_kernel<D256<uint16_t>>, the yardstick), 1 the wgmma body that
// K1 and K3 run (knn_wg.cuh; its keyed modes through K1's and K3's own
// entry points). mode: kPacked (K1, gated when uv_a != NULL: row_p,
// col_p), kWide (K3: row_k, col_k) or kProductRowSum (the product-only
// stage: each A row's wrapping sum of its dots in both slots of row_p).
// a, b (n_pairs, n_a | n_b, 256) bf16 bits, 16-byte aligned; na2, nb2,
// uv_a, pred_b, col_p and col_k as knn_packed_float's and knn_wide's
// (norms unused by kProductRowSum); n_a and n_b multiples of 64, at most
// 8192 for kPacked. Returns the cudaError_t of the launch.
extern "C" int knn_bf16_d256(const void* a, const void* b, const void* na2,
                             const void* nb2, const void* uv_a,
                             const void* pred_b, float radius2, void* row_p,
                             void* col_p, void* row_k, void* col_k,
                             int n_pairs, int n_a, int n_b, int mode,
                             int body, void* stream) {
  if (bad_mode(n_pairs, n_a, n_b, mode, body, true))
    return (int)cudaErrorInvalidValue;
  return bf16_bodies<D256<uint16_t>>(a, b, na2, nb2, uv_a, pred_b, radius2,
                                     row_p, col_p, row_k, col_k, n_pairs,
                                     n_a, n_b, mode, body, 256, stream);
}

// bf16 rows of 128 values on either body, as knn_bf16_d256: body 0 the
// mma.sync body (knn_tc_kernel<uint16_t>, K1's and K3's yardstick at
// 128), 1 the wgmma body that K1 and K3 bf16 run. a, b (n_pairs, n_a |
// n_b, 128) bf16 bits. Returns the cudaError_t of the launch.
extern "C" int knn_bf16_d128(const void* a, const void* b, const void* na2,
                             const void* nb2, const void* uv_a,
                             const void* pred_b, float radius2, void* row_p,
                             void* col_p, void* row_k, void* col_k,
                             int n_pairs, int n_a, int n_b, int mode,
                             int body, void* stream) {
  if (bad_mode(n_pairs, n_a, n_b, mode, body, true))
    return (int)cudaErrorInvalidValue;
  return bf16_bodies<uint16_t>(a, b, na2, nb2, uv_a, pred_b, radius2, row_p,
                               col_p, row_k, col_k, n_pairs, n_a, n_b, mode,
                               body, 128, stream);
}

namespace {

// f32 rows of dim values (F: Bf16x3 at 128, D256<Bf16x3> at 256) on
// either body, as knn_f32_d256 below
template <typename F>
int f32_bodies(const void* a, const void* b, const void* na2,
               const void* nb2, const void* uv_a, const void* pred_b,
               float radius2, void* row_p, void* col_p, void* row_k,
               void* col_k, void* split_a, void* split_b, int n_pairs,
               int n_a, int n_b, int mode, int body, int dim, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (body == 1 && mode == kPacked)
    return knn_packed_float(a, b, na2, nb2, uv_a, pred_b, radius2, row_p,
                            col_p, split_a, split_b, n_pairs, n_a, n_b, 0,
                            dim, stream);
  if (body == 1 && mode == kWide)
    return knn_wide(a, b, na2, nb2, row_k, col_k, split_a, split_b, n_pairs,
                    n_a, n_b, 0, dim, stream);
  int e = launch_split(a, split_a, (long long)n_pairs * n_a, s, dim);
  if (e == 0) e = launch_split(b, split_b, (long long)n_pairs * n_b, s, dim);
  if (e != 0) return e;
  if (body == 1)
    return launch_tc<F, kProductRowSum>(
        split_a, split_b, nullptr, nullptr, nullptr, nullptr, 0.f, row_p,
        nullptr, nullptr, nullptr, n_pairs, n_a, n_b, s);
  return mma_mode<F>(split_a, split_b, na2, nb2, uv_a, pred_b, radius2,
                     row_p, col_p, row_k, col_k, n_pairs, n_a, n_b, mode, s);
}

}  // namespace

// f32 rows of 256 values on either body, as knn_bf16_d256 for bf16: body
// 0 the mma.sync body (knn_tc_kernel<D256<Bf16x3>>, the yardstick), 1 the
// wgmma body that K1 and K3 run (its keyed modes through K1's and K3's own
// entry points); both after the split pre-pass into split_a (n_pairs, n_a,
// 3, 256) and split_b (n_pairs, n_b, 3, 256) bf16 scratch. a, b (n_pairs,
// n_a | n_b, 256) f32, 16-byte aligned; other arguments and the modes as
// knn_bf16_d256's (kProductRowSum: integer-valued rows, so that each dot is
// an integer). Returns the cudaError_t of the first failed launch.
extern "C" int knn_f32_d256(const void* a, const void* b, const void* na2,
                            const void* nb2, const void* uv_a,
                            const void* pred_b, float radius2, void* row_p,
                            void* col_p, void* row_k, void* col_k,
                            void* split_a, void* split_b, int n_pairs,
                            int n_a, int n_b, int mode, int body,
                            void* stream) {
  if (bad_mode(n_pairs, n_a, n_b, mode, body, true))
    return (int)cudaErrorInvalidValue;
  return f32_bodies<D256<Bf16x3>>(a, b, na2, nb2, uv_a, pred_b, radius2,
                                  row_p, col_p, row_k, col_k, split_a,
                                  split_b, n_pairs, n_a, n_b, mode, body,
                                  256, stream);
}

// f32 rows of 128 values on either body, as knn_f32_d256: body 0 the
// mma.sync body (knn_tc_kernel<Bf16x3>, K1 f32's and K3 f32's yardstick at
// 128: K1's mode gated when uv_a != NULL), 1 the wgmma body that K1 and K3
// f32 run (its keyed modes through knn_packed_float and knn_wide); both
// after the split pre-pass into split_a (n_pairs, n_a, 3, 128) and split_b
// (n_pairs, n_b, 3, 128) bf16 scratch. a, b (n_pairs, n_a | n_b, 128) f32.
// Returns the cudaError_t of the first failed launch.
extern "C" int knn_f32_d128(const void* a, const void* b, const void* na2,
                            const void* nb2, const void* uv_a,
                            const void* pred_b, float radius2, void* row_p,
                            void* col_p, void* row_k, void* col_k,
                            void* split_a, void* split_b, int n_pairs,
                            int n_a, int n_b, int mode, int body,
                            void* stream) {
  if (bad_mode(n_pairs, n_a, n_b, mode, body, true))
    return (int)cudaErrorInvalidValue;
  return f32_bodies<Bf16x3>(a, b, na2, nb2, uv_a, pred_b, radius2, row_p,
                            col_p, row_k, col_k, split_a, split_b, n_pairs,
                            n_a, n_b, mode, body, 128, stream);
}

// int8 rows of 256 values on either body, as knn_bf16_d256 for bf16: body
// 0 the mma.sync body (knn_tc_kernel<D256<int8_t>>, the yardstick), 1 the
// wgmma body that K1 runs (knn_wg.cuh; its keyed modes through K1's own
// entry points). mode: kPacked (K1, gated when uv_a != NULL) or
// kProductRowSum (the product-only stage, each A row's wrapping sum of
// its dots in both slots of row_p). a, b (n_pairs, n_a | n_b, 256) int8,
// 16-byte aligned; na2 (n_pairs, n_a) and nb2 (n_pairs, n_b) f32 scratch,
// which kPacked's norm pre-pass fills first (as K1 int8 does; unused by
// kProductRowSum); uv_a, pred_b and col_p as knn_packed_i8_gated's; n_a
// and n_b multiples of 64, at most 8192 for kPacked. Returns the
// cudaError_t of the first failed launch.
extern "C" int knn_i8_d256(const void* a, const void* b, void* na2,
                           void* nb2, const void* uv_a, const void* pred_b,
                           float radius2, void* row_p, void* col_p,
                           int n_pairs, int n_a, int n_b, int mode, int body,
                           void* stream) {
  if (bad_mode(n_pairs, n_a, n_b, mode, body, false))
    return (int)cudaErrorInvalidValue;
  return i8_bodies<D256<int8_t>>(a, b, na2, nb2, uv_a, pred_b, radius2,
                                 row_p, col_p, n_pairs, n_a, n_b, mode, body,
                                 256, stream);
}

// int8 rows of 128 values (SIFT's in the int8 store) on either body, as
// knn_i8_d256: body 0 the mma.sync s8 body (knn_tc_kernel<int8_t>, K1's
// yardstick at 128), 1 the wgmma s8 body that K1 runs. Returns the
// cudaError_t of the first failed launch.
extern "C" int knn_i8_d128(const void* a, const void* b, void* na2,
                           void* nb2, const void* uv_a, const void* pred_b,
                           float radius2, void* row_p, void* col_p,
                           int n_pairs, int n_a, int n_b, int mode, int body,
                           void* stream) {
  if (bad_mode(n_pairs, n_a, n_b, mode, body, false))
    return (int)cudaErrorInvalidValue;
  return i8_bodies<int8_t>(a, b, na2, nb2, uv_a, pred_b, radius2, row_p,
                           col_p, n_pairs, n_a, n_b, mode, body, 128,
                           stream);
}
