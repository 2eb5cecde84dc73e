// K1: streaming packed-key 2-NN over int8 descriptors, for Hopper (sm_90a).
//
// Replaces imageanalysis_tpu/ops/knn.py::_knn_kernel_packed (int8 inputs,
// no spatial gate), which the reference launches through _knn_packed_raw
// for every pair of the match path.
//
// What it computes, for each pair p, A row i and B row j:
//   d2   = |a_i|^2 + |b_j|^2 - 2 a_i.b_j                  (exact int32)
//   key  = (bits(float(d2)) & ~0x1FFF) | j                (row key)
//   row_p[p, i, 0:2] = the two smallest row keys of row i
//   col_p[p, j]      = min_i (bits(float(d2)) & ~0x1FFF) | i
// d2 <= 128 * 255^2 < 2^23, so float(d2) is exact; non-negative float bit
// patterns order like int32, and every key is unique (its index sits in
// the low 13 bits), so the result is bit-exact whatever the order of the
// reductions and the tiling.
//
// What bounds it on the H100: integer arithmetic. A 4096 x 4096 pair is
// 2.1 G int8 multiply-adds over only 1 MB of descriptors, so memory is no
// limit; the limit is the issue rate of __dp4a (4 MACs per instruction)
// and of the per-element key epilogue (convert, mask, or, two compares).
//
// Design: one block owns TA = 64 rows of A of one pair in shared memory
// and streams B through shared memory in tiles of TB = 64 rows, so each
// descriptor byte read from shared memory feeds 4 dot products per thread
// (a 4 x 4 register tile per thread). Row top-2 keys stay in registers for
// the whole sweep over B and are merged across the 16 threads of a row by
// warp shuffles at the end; the column minimum of each tile is reduced in
// shared memory and leaves the block by one global atomicMin per column.
// The int8 tensor cores (mma.sync / wgmma s8) are the next step.

#include <cuda_runtime.h>

namespace {

constexpr int kWords = 32;          // 128 int8 = 32 int32 words per row
constexpr int kTA = 64;             // A rows per block
constexpr int kTB = 64;             // B rows per streamed tile
constexpr int kThreads = 256;       // 16 x 16 threads, 4 x 4 elements each
constexpr int kLds = kWords + 1;    // padded shared row: conflict-free reads
constexpr int kKeyMax = 0x7FFFFFFF;
constexpr int kIdxMask = 0x1FFF;

__device__ __forceinline__ int row_norm(const int* row) {
  int s = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) s = __dp4a(row[k], row[k], s);
  return s;
}

__global__ void __launch_bounds__(kThreads)
knn_packed_i8_kernel(const int* __restrict__ a, const int* __restrict__ b,
                     int* __restrict__ row_p, int* __restrict__ col_p,
                     int n_a, int n_b) {
  __shared__ int sa[kTA * kLds];
  __shared__ int sb[kTB * kLds];
  __shared__ int na2[kTA];
  __shared__ int nb2[kTB];
  __shared__ int colmin[kTB];

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
        const int bits = __float_as_int((float)d2) & ~kIdxMask;
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

}  // namespace

// a (n_pairs, n_a, 128) int8, b (n_pairs, n_b, 128) int8, both contiguous
// and 4-byte aligned; row_p (n_pairs, n_a, 2) int32; col_p (n_pairs, n_b)
// int32 pre-filled with 0x7FFFFFFF. n_a and n_b are multiples of 64 and at
// most 8192. Returns the cudaError_t of the launch.
extern "C" int knn_packed_i8(const void* a, const void* b, void* row_p,
                             void* col_p, int n_pairs, int n_a, int n_b,
                             void* stream) {
  if (n_pairs <= 0 || n_a <= 0 || n_b <= 0 || n_a % kTA || n_b % kTB ||
      n_a > kIdxMask + 1 || n_b > kIdxMask + 1 || n_pairs > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(n_a / kTA, n_pairs);
  knn_packed_i8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (int*)row_p, (int*)col_p, n_a, n_b);
  return (int)cudaGetLastError();
}
