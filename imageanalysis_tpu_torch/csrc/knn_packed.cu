// K1: streaming packed-key 2-NN, for Hopper (sm_90a).
//
// Replaces imageanalysis_tpu/ops/knn.py::_knn_kernel_packed in all of its
// modes: int8, bf16 and f32 descriptors, each with or without the spatial
// gate of the smart strategy. The reference launches it through
// _knn_packed_raw for every pair of n <= 8192 rows.
//
// Rows of 128 values (SIFT) or 256 (ORB's 256 bits as 0/1 values): every
// mode is instantiated at both widths (knn_tc.cuh's D256<T>), and the
// entry points take the width.
//
// What it computes, for each pair p, A row i and B row j:
//   d2   = |a_i|^2 + |b_j|^2 - 2 a_i.b_j     int8: exact int32
//                                            float: f32, clamped at 0; the
//                                            norms come from the f32
//                                            descriptors, the dot from the
//                                            bf16-rounded (or f32) ones
//   bits = bits(float(d2)) & ~0x1FFF, or (0x7FFFFFFF & ~0x1FFF) where the
//          gate is on and |uv_a[i] - pred_b[j]|^2 > radius2
//   row_p[p, i, 0:2] = the two smallest bits | j of row i
//   col_p[p, j]      = min_i bits | i
// Non-negative float bit patterns order like int32 and every key is unique
// (its index sits in the low 13 bits), so the result is bit-exact whatever
// the order of the reductions and the tiling, given bit-exact d2 — which
// integer-valued descriptors give in every mode.
//
// What bounds it on the H100: the product. A 4096 x 4096 pair is 2.1 G
// multiply-adds over 1-4 MB of descriptors, so memory is no limit; the
// limit is the rate of the product and of the per-element key epilogue
// (convert, mask, gate, or, two compares). Every mode, plain and gated,
// runs knn_tc.cuh's tensor-core body (through knn_common.cuh):
// - bf16 and int8:
//   mma.sync (bf16 m16n8k16 with f32 sums, s8 m16n8k32 with exact s32
//   sums) on the operands as they are, a 128-row A tile resident in shared
//   memory, B tiles of 128 rows through a two-stage cp.async ring, the key
//   epilogue on the accumulator fragments. Before it, the product was 93%
//   of the FFMA body's bf16 time (26.8 TFLOP/s) and 86% of the __dp4a
//   body's int8 time (100 TOP/s). int8 takes its squared norms from a
//   pre-pass (row_norms_i8_kernel) into f32 scratch of the caller's (exact:
//   at most 128 x 128^2 = 2^21), as the float modes take theirs from the
//   caller.
// - f32 takes the same body on three bf16 planes of each operand (hi, mid,
//   lo: the TPU kernel's own Precision.HIGHEST product is a multi-pass
//   bf16 product too), six plane products a k-step: hi·hi into one f32
//   accumulator, the five smaller products into a second, the two added
//   once a B tile (why: the head of knn_tc.cuh). The planes come from a
//   split pre-pass (split_bf16x3_kernel) into bf16 scratch of the
//   caller's. Integer-valued descriptors give exact dots, so keys
//   bit-exact with the plain version; other f32 within 2^-20 of the norms
//   (2^-19 at 256 values a row, where the plain version's own f32 product
//   errs more).
//   Before it, the FFMA body (now the yardstick knn_ffma_f32 in
//   knn_probe.cu) ran at 39% of the CUDA cores' 67 TFLOP/s.
// - bf16 and f32 at 256 values a row (ORB's) run knn_wg.cuh's body, plain
//   and gated: wgmma fed by TMA, two consumer warpgroups in ping-pong (f32
//   after its split pre-pass, A's hi plane in registers, B plane by plane;
//   the mma.sync bodies there are knn_probe.cu's yardsticks).
// In every body the row top-2 keys stay in registers for the whole sweep
// over B and are merged across the threads of a row by warp shuffles at
// the end; each B tile's column minimum is reduced in shared memory and
// leaves the block by one global atomicMin per column.

#include <cuda_bf16.h>

#include "knn_common.cuh"

namespace {

using namespace knn;

// f32 rows of D values → their three bf16 planes (hi, mid, lo; see the
// head of knn_tc.cuh), row by row: out (rows, 3, D) bf16 bits. One thread
// a float4, so a warp reads 512 bytes of a row and writes 256 of each
// plane. Each difference is exact in f32 (__fsub_rn of a value and its own
// rounding), each part rounded to nearest even as torch's .bfloat16().
template <int D>
__global__ void __launch_bounds__(256)
split_bf16x3_kernel(const float4* __restrict__ x, uint2* __restrict__ out,
                    long long n4) {
  constexpr int kQ = D / 4;         // float4 a row, uint2 a plane's row
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n4) return;
  const float4 v = x[t];
  const float f[4] = {v.x, v.y, v.z, v.w};
  unsigned h[3][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat16 hi = __float2bfloat16_rn(f[i]);
    const float r1 = __fsub_rn(f[i], __bfloat162float(hi));
    const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
    const float r2 = __fsub_rn(r1, __bfloat162float(mid));
    h[0][i] = __bfloat16_as_ushort(hi);
    h[1][i] = __bfloat16_as_ushort(mid);
    h[2][i] = __bfloat16_as_ushort(__float2bfloat16_rn(r2));
  }
  uint2* o = out + (t / kQ) * (3 * kQ) + (t % kQ);
#pragma unroll
  for (int p = 0; p < 3; ++p)
    o[kQ * p] = make_uint2(h[p][0] | h[p][1] << 16, h[p][2] | h[p][3] << 16);
}

// Squared norms of int8 rows of D values, summed in int32 and written as
// f32 (exact: at most 256 x 128^2 = 2^22): D / 16 threads a row, 16 bytes
// each, so a warp reads 512 contiguous bytes of whole rows
template <int D>
__global__ void __launch_bounds__(256)
row_norms_i8_kernel(const int4* __restrict__ x, float* __restrict__ out,
                    long long rows) {
  constexpr int kT = D / 16;        // threads a row
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = t / kT;
  int s = 0;
  if (r < rows) {
    const int4 v = x[t];
    s = __dp4a(v.x, v.x, s);
    s = __dp4a(v.y, v.y, s);
    s = __dp4a(v.z, v.z, s);
    s = __dp4a(v.w, v.w, s);
  }
#pragma unroll
  for (int off = kT / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (r < rows && t % kT == 0) out[r] = (float)s;
}

// int8 (I8: int8_t or D256<int8_t>): the norms pre-pass into na2 / nb2,
// then the tensor-core body
template <typename I8, int MODE>
int launch_i8_at(const void* a, const void* b, void* na2, void* nb2,
              const void* uv_a, const void* pred_b, float radius2,
              void* row_p, void* col_p, int n_pairs, int n_a, int n_b,
              int dim, cudaStream_t s) {
  int e = launch_row_norms_i8(a, na2, (long long)n_pairs * n_a, s, dim);
  if (e == 0)
    e = launch_row_norms_i8(b, nb2, (long long)n_pairs * n_b, s, dim);
  if (e != 0) return e;
  return launch_tc<I8, MODE>(a, b, na2, nb2, uv_a, pred_b, radius2, row_p,
                             col_p, nullptr, nullptr, n_pairs, n_a, n_b, s);
}

template <int MODE>
int launch_i8(const void* a, const void* b, void* na2, void* nb2,
              const void* uv_a, const void* pred_b, float radius2,
              void* row_p, void* col_p, int n_pairs, int n_a, int n_b,
              int dim, void* stream) {
  if (bad_shape(n_pairs, n_a, n_b, kIdxMask + 1) || bad_dim(dim))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 256)
    return launch_i8_at<D256<int8_t>, MODE>(a, b, na2, nb2, uv_a, pred_b,
                                            radius2, row_p, col_p, n_pairs,
                                            n_a, n_b, dim, s);
  return launch_i8_at<int8_t, MODE>(a, b, na2, nb2, uv_a, pred_b, radius2,
                                    row_p, col_p, n_pairs, n_a, n_b, dim, s);
}

// float descriptors (H: bf16 bits, F: f32's planes, at one width): the
// tensor-core body, f32 after the split pre-pass into split_a / split_b
template <typename H, typename F>
int launch_float_at(const void* a, const void* b, const void* na2,
                 const void* nb2, const void* uv_a, const void* pred_b,
                 float radius2, void* row_p, void* col_p, void* split_a,
                 void* split_b, int n_pairs, int n_a, int n_b, bool bf16,
                 int dim, cudaStream_t s) {
  if (bf16 && uv_a)
    return launch_tc<H, kPackedGated>(a, b, na2, nb2, uv_a, pred_b, radius2,
                                      row_p, col_p, nullptr, nullptr,
                                      n_pairs, n_a, n_b, s);
  if (bf16)
    return launch_tc<H, kPacked>(a, b, na2, nb2, nullptr, nullptr, 0.f,
                                 row_p, col_p, nullptr, nullptr, n_pairs,
                                 n_a, n_b, s);
  int e = launch_split(a, split_a, (long long)n_pairs * n_a, s, dim);
  if (e == 0) e = launch_split(b, split_b, (long long)n_pairs * n_b, s, dim);
  if (e != 0) return e;
  if (uv_a)
    return launch_tc<F, kPackedGated>(split_a, split_b, na2, nb2, uv_a,
                                      pred_b, radius2, row_p, col_p, nullptr,
                                      nullptr, n_pairs, n_a, n_b, s);
  return launch_tc<F, kPacked>(split_a, split_b, na2, nb2, nullptr, nullptr,
                               0.f, row_p, col_p, nullptr, nullptr, n_pairs,
                               n_a, n_b, s);
}

int launch_float(const void* a, const void* b, const void* na2,
                 const void* nb2, const void* uv_a, const void* pred_b,
                 float radius2, void* row_p, void* col_p, void* split_a,
                 void* split_b, int n_pairs, int n_a, int n_b, bool bf16,
                 int dim, void* stream) {
  if (bad_shape(n_pairs, n_a, n_b, kIdxMask + 1) || bad_dim(dim))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 256)
    return launch_float_at<D256<uint16_t>, D256<Bf16x3>>(
        a, b, na2, nb2, uv_a, pred_b, radius2, row_p, col_p, split_a,
        split_b, n_pairs, n_a, n_b, bf16, dim, s);
  return launch_float_at<uint16_t, Bf16x3>(a, b, na2, nb2, uv_a, pred_b,
                                           radius2, row_p, col_p, split_a,
                                           split_b, n_pairs, n_a, n_b, bf16,
                                           dim, s);
}

}  // namespace

// declared in knn_tc.cuh, for K1 int8 here and P3's stages in
// knn_probe.cu
int knn::launch_row_norms_i8(const void* x, void* out, long long rows,
                             cudaStream_t stream, int dim) {
  const unsigned blocks = (unsigned)((rows * (dim / 16) + 255) / 256);
  if (dim == 256)
    row_norms_i8_kernel<256><<<blocks, 256, 0, stream>>>((const int4*)x,
                                                         (float*)out, rows);
  else
    row_norms_i8_kernel<128><<<blocks, 256, 0, stream>>>((const int4*)x,
                                                         (float*)out, rows);
  return (int)cudaGetLastError();
}

// declared in knn_tc.cuh, for K1 f32 here and the product-only stage in
// knn_probe.cu
int knn::launch_split(const void* x, void* out, long long rows,
                      cudaStream_t stream, int dim) {
  const long long n4 = rows * (dim / 4);
  const unsigned blocks = (unsigned)((n4 + 255) / 256);
  if (dim == 256)
    split_bf16x3_kernel<256><<<blocks, 256, 0, stream>>>((const float4*)x,
                                                         (uint2*)out, n4);
  else
    split_bf16x3_kernel<128><<<blocks, 256, 0, stream>>>((const float4*)x,
                                                         (uint2*)out, n4);
  return (int)cudaGetLastError();
}


// Inputs (n_pairs, n_a, dim) and (n_pairs, n_b, dim), dim 128 or 256,
// contiguous; row_p
// (n_pairs, n_a, 2) int32; col_p (n_pairs, n_b) int32 pre-filled with
// 0x7FFFFFFF. n_a and n_b are multiples of 64 and at most 8192. The gated
// entry points take uv_a (n_pairs, n_a, 2) and pred_b (n_pairs, n_b, 2)
// f32. Each returns the cudaError_t of its launch.

// int8 descriptors (value - 128), 16-byte aligned; na2 (n_pairs, n_a)
// and nb2 (n_pairs, n_b) f32 scratch, which the first two launches fill
// with the rows' squared norms
extern "C" int knn_packed_i8(const void* a, const void* b, void* na2,
                             void* nb2, void* row_p, void* col_p,
                             int n_pairs, int n_a, int n_b, int dim,
                             void* stream) {
  return launch_i8<kPacked>(a, b, na2, nb2, nullptr, nullptr, 0.f, row_p,
                            col_p, n_pairs, n_a, n_b, dim, stream);
}

extern "C" int knn_packed_i8_gated(const void* a, const void* b, void* na2,
                                   void* nb2, const void* uv_a,
                                   const void* pred_b, float radius2,
                                   void* row_p, void* col_p, int n_pairs,
                                   int n_a, int n_b, int dim, void* stream) {
  return launch_i8<kPackedGated>(a, b, na2, nb2, uv_a, pred_b, radius2,
                                 row_p, col_p, n_pairs, n_a, n_b, dim,
                                 stream);
}

// bf16 (bf16 != 0) or f32 descriptors, 16-byte aligned, with their f32
// squared norms na2 (n_pairs, n_a) and nb2 (n_pairs, n_b); uv_a == NULL:
// no gate. f32: split_a (n_pairs, n_a, 3, dim) and split_b (n_pairs, n_b,
// 3, dim) bf16 scratch, which the first two launches fill with the
// operands' planes (unused for bf16)
extern "C" int knn_packed_float(const void* a, const void* b, const void* na2,
                                const void* nb2, const void* uv_a,
                                const void* pred_b, float radius2,
                                void* row_p, void* col_p, void* split_a,
                                void* split_b, int n_pairs, int n_a, int n_b,
                                int bf16, int dim, void* stream) {
  return launch_float(a, b, na2, nb2, uv_a, pred_b, radius2, row_p, col_p,
                      split_a, split_b, n_pairs, n_a, n_b, bf16 != 0, dim,
                      stream);
}

// The split pre-pass alone: x (rows, dim) f32, dim 128 or 256, 16-byte
// aligned → out (rows, 3, dim) bf16 bits, hi + mid + lo == x. Returns the
// cudaError_t of the launch.
extern "C" int split_bf16x3(const void* x, void* out, int rows, int dim,
                            void* stream) {
  if (rows <= 0 || bad_dim(dim)) return (int)cudaErrorInvalidValue;
  return launch_split(x, out, rows, (cudaStream_t)stream, dim);
}
