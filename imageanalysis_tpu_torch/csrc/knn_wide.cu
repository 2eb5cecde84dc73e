// K3: unpacked ("wide") 2-NN for sets of any size, for Hopper (sm_90a).
//
// Replaces imageanalysis_tpu/ops/knn.py::_knn_kernel, which the reference's
// knn_top2 takes when max(n_a, n_b) > 8192 (beyond the 13 index bits of
// K1's packed keys). Inputs are bf16 or f32 descriptors (the caller casts
// int8 store rows to bf16, exactly) of 128 or 256 values a row (ORB's
// 10,000 features a frame reach it), with f32 squared norms.
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
// 128 are 8.6e11 multiply-adds over 168 MB (bf16) or 336 MB (f32) of
// descriptors, at the tensor cores' bf16 rate (1.7 ms); f32 takes six bf16
// products (10.4 ms), where the CUDA cores' f32 FMA would take 25.6 ms.
// Then the 64-bit key epilogue, twice K1's key registers and shuffles.
//
// Design: the TPU kernel carries its running state across a sequential
// grid; here blocks run in any order. Both modes run knn_tc.cuh's
// tensor-core body (kWide): mma.sync m16n8k16 with a two-stage cp.async
// ring of B tiles. A block owns a tile of A rows for the whole sweep over
// B and keeps their row top-2 as f32 values and int indices in
// registers, made into 64-bit keys for the merges across the threads of
// a row; the column minimum leaves the block by a 64-bit atomicMin on the
// key, which is order-independent. There is no 8192 limit.
// - bf16 (every store beyond 8192 rows): the operands as they are, 128-row
//   B tiles; its FFMA predecessor spent 93% of its time in the product.
//   At 256 values a row (ORB's) bf16 runs knn_wg.cuh's body instead:
//   wgmma fed by TMA, two consumer warpgroups in ping-pong (the mma.sync
//   body there is knn_probe.cu's yardstick).
// - f32: the TPU kernel's f32 dot runs at Precision.HIGHEST, a multi-pass
//   bf16 product; here a pre-pass (knn_packed.cu's split_bf16x3_kernel)
//   writes each operand as three bf16 planes into the caller's scratch and
//   the body takes six plane products a k-step, hi.hi in one f32
//   accumulator and the five smaller ones in a second (why: the head of
//   knn_tc.cuh), on 64-row B tiles (~199 KB of shared memory, one block an
//   SM). Integer-valued descriptors give exact dots, so keys equal the
//   plain version's bit for bit; other f32 within 2^-20 of the norms. Its
//   FFMA predecessor (knn_probe.cu's knn_ffma_f32, kept as the yardstick)
//   ran at 39% of the CUDA cores' 67 TFLOP/s.

#include "knn_common.cuh"

namespace {

// one width (H: bf16 bits, F: f32's planes)
template <typename H, typename F>
int launch_wide(const void* a, const void* b, const void* na2,
                const void* nb2, void* row_k, void* col_k, void* split_a,
                void* split_b, int n_pairs, int n_a, int n_b, bool bf16,
                int dim, cudaStream_t s) {
  using namespace knn;
  if (bf16)
    return launch_tc<H, kWide>(a, b, na2, nb2, nullptr, nullptr, 0.f,
                               nullptr, nullptr, row_k, col_k, n_pairs, n_a,
                               n_b, s);
  int e = launch_split(a, split_a, (long long)n_pairs * n_a, s, dim);
  if (e == 0) e = launch_split(b, split_b, (long long)n_pairs * n_b, s, dim);
  if (e != 0) return e;
  return launch_tc<F, kWide>(split_a, split_b, na2, nb2, nullptr, nullptr,
                             0.f, nullptr, nullptr, row_k, col_k, n_pairs,
                             n_a, n_b, s);
}

}  // namespace

// a (n_pairs, n_a, dim) and b (n_pairs, n_b, dim), dim 128 or 256: bf16
// (bf16 != 0) or f32, contiguous and 16-byte aligned; na2 (n_pairs, n_a),
// nb2 (n_pairs, n_b) f32; row_k (n_pairs, n_a, 2) int64; col_k (n_pairs,
// n_b) int64 pre-filled with INT64_MAX. f32: split_a (n_pairs, n_a, 3, dim)
// and split_b (n_pairs, n_b, 3, dim) bf16 scratch, which the first two
// launches fill with the operands' planes (unused for bf16). n_a and n_b
// are multiples of 64. Returns the cudaError_t of the launch.
extern "C" int knn_wide(const void* a, const void* b, const void* na2,
                        const void* nb2, void* row_k, void* col_k,
                        void* split_a, void* split_b, int n_pairs, int n_a,
                        int n_b, int bf16, int dim, void* stream) {
  using namespace knn;
  if (bad_shape(n_pairs, n_a, n_b, 1 << 30) || bad_dim(dim))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 256)
    return launch_wide<D256<uint16_t>, D256<Bf16x3>>(
        a, b, na2, nb2, row_k, col_k, split_a, split_b, n_pairs, n_a, n_b,
        bf16 != 0, dim, s);
  return launch_wide<uint16_t, Bf16x3>(a, b, na2, nb2, row_k, col_k, split_a,
                                       split_b, n_pairs, n_a, n_b, bf16 != 0,
                                       dim, s);
}
