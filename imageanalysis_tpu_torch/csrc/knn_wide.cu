// K3: unpacked ("wide") 2-NN for sets of any size, for Hopper (sm_90a).
//
// Replaces imageanalysis_tpu/ops/knn.py::_knn_kernel, which the reference's
// knn_top2 takes when max(n_a, n_b) > 8192 (beyond the 13 index bits of
// K1's packed keys). Inputs are bf16 or f32 descriptors (the caller casts
// int8 store rows to bf16, exactly) with f32 squared norms.
//
// What it computes, for each pair p, A row i and B row j:
//   d2 = |a_i|^2 + |b_j|^2 - 2 a_i.b_j      f32, NOT clamped at 0
//   key(d2, idx) = (orderable(d2) << 32) | idx       signed 64-bit
//   row_k[p, i, 0:2] = the two smallest key(d2, j) of row i
//   col_k[p, j]      = min_i key(d2, i)
// orderable() maps f32 bits to an int32 that orders like the float,
// negatives included: unclamped float inputs give slightly negative d2,
// whose raw bits would order backwards. The smallest key is the smallest
// value and, among equal values, the lowest index — the Pallas merges'
// rule for the best row and the column (`m1 < r1`, `cm < old`). The
// second index on an exact tie may differ from the Pallas merge; only the
// two values and the best index are used downstream.
//
// What bounds it on the H100: the product, 64 pairs of 10240 x 10240 x
// 128 are 8.6e11 multiply-adds over 168 MB (bf16) of descriptors, and the
// 64-bit key epilogue, twice K1's key registers and shuffles.
//
// Design: the TPU kernel carries its running state across a sequential
// grid; here blocks run in any order. A block owns a tile of A rows for
// the whole sweep over B and keeps their row top-2 as 64-bit keys in
// registers, merged across the threads of a row by warp shuffles; the
// column minimum leaves the block by a 64-bit atomicMin on the key, which
// is order-independent. There is no 8192 limit. bf16 inputs (every
// store beyond 8192 rows) run knn_tc.cuh's tensor-core body: mma.sync
// m16n8k16 on 128-row tiles with a two-stage cp.async ring of B tiles
// (its FFMA predecessor spent 93% of its time in the product); f32 inputs
// run knn_common.cuh's FFMA body, at most the CUDA cores' 67 TFLOP/s.

#include "knn_common.cuh"

// a (n_pairs, n_a, 128) and b (n_pairs, n_b, 128): bf16 (bf16 != 0) or
// f32, contiguous; na2 (n_pairs, n_a), nb2 (n_pairs, n_b) f32; row_k
// (n_pairs, n_a, 2) int64; col_k (n_pairs, n_b) int64 pre-filled with
// INT64_MAX. n_a and n_b are multiples of 64. Returns the cudaError_t of
// the launch.
extern "C" int knn_wide(const void* a, const void* b, const void* na2,
                        const void* nb2, void* row_k, void* col_k,
                        int n_pairs, int n_a, int n_b, int bf16,
                        void* stream) {
  using namespace knn;
  if (bad_shape(n_pairs, n_a, n_b, 1 << 30)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_tc<uint16_t, kWide>(a, b, na2, nb2, nullptr, nullptr, 0.f,
                                      nullptr, nullptr, row_k, col_k, n_pairs,
                                      n_a, n_b, s);
  dim3 grid(n_a / kTA, n_pairs);
  knn_float_kernel<float, kWide><<<grid, kThreads, 0, s>>>(
      (const float*)a, (const float*)b, (const float*)na2, (const float*)nb2,
      nullptr, nullptr, 0.f, nullptr, nullptr, (long long*)row_k,
      (long long*)col_k, n_a, n_b);
  return (int)cudaGetLastError();
}
