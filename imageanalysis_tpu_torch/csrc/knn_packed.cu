// K1: streaming packed-key 2-NN, for Hopper (sm_90a).
//
// Replaces imageanalysis_tpu/ops/knn.py::_knn_kernel_packed in all of its
// modes: int8, bf16 and f32 descriptors, each with or without the spatial
// gate of the smart strategy. The reference launches it through
// _knn_packed_raw for every pair of n <= 8192 rows.
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
// What bounds it on the H100: arithmetic. A 4096 x 4096 pair is 2.1 G
// multiply-adds over 1-4 MB of descriptors, so memory is no limit; the
// limit is the issue rate of __dp4a (int8, 4 MACs per instruction) or of
// f32 FMAs fed from shared memory (float modes), and of the per-element
// key epilogue (convert, mask, gate, or, two compares).
//
// Design: one block owns TA = 64 rows of A of one pair in shared memory
// and streams B through shared memory in tiles of TB = 64 rows, so each
// value read from shared memory feeds 4 dot products per thread (a 4 x 4
// register tile per thread). Row top-2 keys stay in registers for the
// whole sweep over B and are merged across the 16 threads of a row by
// warp shuffles at the end; the column minimum of each tile is reduced in
// shared memory and leaves the block by one global atomicMin per column.
// The float modes share their body with K3 (knn_common.cuh). Tensor cores
// (mma.sync / wgmma, s8 and bf16) are the next step.

#include "knn_common.cuh"

namespace {

using namespace knn;

constexpr int kWords = 32;          // 128 int8 = 32 int32 words per row
constexpr int kLds = kWords + 1;    // padded shared row: conflict-free reads

__device__ __forceinline__ int row_norm(const int* row) {
  int s = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) s = __dp4a(row[k], row[k], s);
  return s;
}

template <bool GATED>
__global__ void __launch_bounds__(kThreads)
knn_packed_i8_kernel(const int* __restrict__ a, const int* __restrict__ b,
                     const float* __restrict__ uv_a,
                     const float* __restrict__ pred_b, float radius2,
                     int* __restrict__ row_p, int* __restrict__ col_p,
                     int n_a, int n_b) {
  __shared__ int sa[kTA * kLds];
  __shared__ int sb[kTB * kLds];
  __shared__ int na2[kTA];
  __shared__ int nb2[kTB];
  __shared__ int colmin[kTB];
  __shared__ float sua[kTA * 2];
  __shared__ float spb[kTB * 2];

  const int pair = blockIdx.y;
  const int a0 = blockIdx.x * kTA;
  const int tid = threadIdx.x;
  const int tx = tid & 15;          // column group: cols tx + 16 j
  const int ty = tid >> 4;          // row group: rows ty + 16 i
  const int* A = a + ((size_t)pair * n_a + a0) * kWords;
  const int* Bm = b + (size_t)pair * n_b * kWords;
  int* colp = col_p + (size_t)pair * n_b;

  for (int w = tid; w < kTA * kWords; w += kThreads)
    sa[(w / kWords) * kLds + (w % kWords)] = A[w];
  if (GATED && tid < kTA * 2)
    sua[tid] = uv_a[((size_t)pair * n_a + a0) * 2 + tid];
  __syncthreads();
  if (tid < kTA) na2[tid] = row_norm(sa + tid * kLds);

  int r1[4], r2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { r1[i] = kKeyMax; r2[i] = kKeyMax; }

  for (int b0 = 0; b0 < n_b; b0 += kTB) {
    __syncthreads();                // previous tile fully consumed
    const int* Bt = Bm + (size_t)b0 * kWords;
    for (int w = tid; w < kTB * kWords; w += kThreads)
      sb[(w / kWords) * kLds + (w % kWords)] = Bt[w];
    if (tid < kTB) colmin[tid] = kKeyMax;
    if (GATED && tid < kTB * 2)
      spb[tid] = pred_b[((size_t)pair * n_b + b0) * 2 + tid];
    __syncthreads();
    if (tid < kTB) nb2[tid] = row_norm(sb + tid * kLds);
    __syncthreads();

    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll 8
    for (int k = 0; k < kWords; ++k) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[(ty + 16 * i) * kLds + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sb[(tx + 16 * j) * kLds + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }

    int ck[4] = {kKeyMax, kKeyMax, kKeyMax, kKeyMax};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int d2 = na2[row] + nb2[col] - 2 * acc[i][j];
        int bits = __float_as_int((float)d2) & ~kIdxMask;
        if (GATED && gated_out(sua[2 * row], sua[2 * row + 1], spb[2 * col],
                               spb[2 * col + 1], radius2))
          bits = kGatedBits;
        const int rk = bits | (b0 + col);
        if (rk < r1[i]) { r2[i] = r1[i]; r1[i] = rk; }
        else if (rk < r2[i]) { r2[i] = rk; }
        ck[j] = min(ck[j], bits | (a0 + row));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) atomicMin(&colmin[tx + 16 * j], ck[j]);
    __syncthreads();
    if (tid < kTB) atomicMin(&colp[b0 + tid], colmin[tid]);
  }

  // merge the 16 partial top-2 lists of each row (lanes 0-15 / 16-31)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const int o1 = __shfl_xor_sync(0xffffffffu, r1[i], off);
      const int o2 = __shfl_xor_sync(0xffffffffu, r2[i], off);
      const int n2 = min(max(r1[i], o1), min(r2[i], o2));
      r1[i] = min(r1[i], o1);
      r2[i] = n2;
    }
    if (tx == 0) {
      int* out = row_p + ((size_t)pair * n_a + a0 + ty + 16 * i) * 2;
      out[0] = r1[i];
      out[1] = r2[i];
    }
  }
}

template <bool GATED>
int launch_i8(const void* a, const void* b, const void* uv_a,
              const void* pred_b, float radius2, void* row_p, void* col_p,
              int n_pairs, int n_a, int n_b, void* stream) {
  if (bad_shape(n_pairs, n_a, n_b, kIdxMask + 1))
    return (int)cudaErrorInvalidValue;
  dim3 grid(n_a / kTA, n_pairs);
  knn_packed_i8_kernel<GATED><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (const float*)uv_a, (const float*)pred_b,
      radius2, (int*)row_p, (int*)col_p, n_a, n_b);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_float(const void* a, const void* b, const void* na2,
                 const void* nb2, const void* uv_a, const void* pred_b,
                 float radius2, void* row_p, void* col_p, int n_pairs,
                 int n_a, int n_b, void* stream) {
  if (bad_shape(n_pairs, n_a, n_b, kIdxMask + 1))
    return (int)cudaErrorInvalidValue;
  dim3 grid(n_a / kTA, n_pairs);
  cudaStream_t s = (cudaStream_t)stream;
  if (uv_a)
    knn_float_kernel<T, kPackedGated><<<grid, kThreads, 0, s>>>(
        (const T*)a, (const T*)b, (const float*)na2, (const float*)nb2,
        (const float*)uv_a, (const float*)pred_b, radius2, (int*)row_p,
        (int*)col_p, nullptr, nullptr, n_a, n_b);
  else
    knn_float_kernel<T, kPacked><<<grid, kThreads, 0, s>>>(
        (const T*)a, (const T*)b, (const float*)na2, (const float*)nb2,
        nullptr, nullptr, 0.f, (int*)row_p, (int*)col_p, nullptr, nullptr,
        n_a, n_b);
  return (int)cudaGetLastError();
}

}  // namespace

// Inputs (n_pairs, n_a, 128) and (n_pairs, n_b, 128), contiguous; row_p
// (n_pairs, n_a, 2) int32; col_p (n_pairs, n_b) int32 pre-filled with
// 0x7FFFFFFF. n_a and n_b are multiples of 64 and at most 8192. The gated
// entry points take uv_a (n_pairs, n_a, 2) and pred_b (n_pairs, n_b, 2)
// f32. Each returns the cudaError_t of its launch.

// int8 descriptors (value - 128), 4-byte aligned; norms computed inside
extern "C" int knn_packed_i8(const void* a, const void* b, void* row_p,
                             void* col_p, int n_pairs, int n_a, int n_b,
                             void* stream) {
  return launch_i8<false>(a, b, nullptr, nullptr, 0.f, row_p, col_p, n_pairs,
                          n_a, n_b, stream);
}

extern "C" int knn_packed_i8_gated(const void* a, const void* b,
                                   const void* uv_a, const void* pred_b,
                                   float radius2, void* row_p, void* col_p,
                                   int n_pairs, int n_a, int n_b,
                                   void* stream) {
  return launch_i8<true>(a, b, uv_a, pred_b, radius2, row_p, col_p, n_pairs,
                         n_a, n_b, stream);
}

// bf16 (bf16 != 0) or f32 descriptors with their f32 squared norms na2
// (n_pairs, n_a) and nb2 (n_pairs, n_b); uv_a == NULL: no gate
extern "C" int knn_packed_float(const void* a, const void* b, const void* na2,
                                const void* nb2, const void* uv_a,
                                const void* pred_b, float radius2,
                                void* row_p, void* col_p, int n_pairs,
                                int n_a, int n_b, int bf16, void* stream) {
  if (bf16)
    return launch_float<uint16_t>(a, b, na2, nb2, uv_a, pred_b, radius2,
                                  row_p, col_p, n_pairs, n_a, n_b, stream);
  return launch_float<float>(a, b, na2, nb2, uv_a, pred_b, radius2, row_p,
                             col_p, n_pairs, n_a, n_b, stream);
}
