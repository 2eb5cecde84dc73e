// Shared pieces of the 2-NN kernels (K1 in knn_packed.cu, K3 in
// knn_wide.cu, the probes in knn_probe.cu and knn_fused_probe.cu): tile
// constants, the spatial gate, the keys, and three bodies, each compiled
// in its own modes:
//   knn_tc_kernel      every mode of K1 (bf16, int8 and f32 as three bf16
//                      planes, each plain and gated) and of K3 (bf16,
//                      f32), mma.sync on the tensor cores (knn_tc.cuh,
//                      included at the end of this file); P6's row-min
//                      sweep, P3's stages and P2's single launch
//   knn_float_kernel   f32 FMAs on bf16 or f32 descriptors: the
//                      tensor-core body's f32 and bf16 yardsticks (K1's
//                      modes and K3's) and bf16 for the probes of K1's
//                      anatomy (knn_probe.cu); K1 and K3 no longer launch
//                      it
//   knn_i8_block       int8 descriptors, __dp4a: the probes' int8 anatomy
//                      (knn_probe.cu), the tensor-core body's int8
//                      yardstick and P2's first body (knn_fused_probe.cu);
//                      K1 no longer launches it
//
// What bounds them on the H100: the product. An int8 pair of 6144 rows is
// 9.7 G multiply-adds over 1.6 MB; the card's int8 and bf16 rates are only
// reached on the tensor cores, which the __dp4a body does not use (100
// TOP/s). The f32 body's bound is the CUDA cores' 67 TFLOP/s of f32 FMA;
// the tensor-core body reaches the tensor cores for f32 by a three-part
// bf16 split, exact on integer-valued descriptors. The tensor-core body
// keeps the same key epilogue.
//
// The __dp4a and f32 bodies are templates over a STAGE and a block tile
// (TA A rows per block, B streamed in tiles of TB rows; 256 threads in a
// 16 x 16 grid, so each thread holds a TA/16 x TB/16 register tile of
// dots). Their full stage at TA = TB = 64 is K1's result bit for bit (its
// kWide mode K3's); the probes of K1's anatomy compile the
// earlier stages and other tiles from the same source, so each dtype's
// stages are one body's:
//   kRowSum    product + row sum (unsigned, wrapping: the TPU probe's int32
//              sum; float dots, integers below 2^24, are converted first)
//   kRowMin    product + row min of the raw dot
//   kTop1      + d2, the packed key bits | j, row top-1
//   kTop2Tile  + row top-2, restarted at every B tile (the last tile's)
//   kTop2      + the running top-2 across B tiles
//   kFull      + the column minimum by atomicMin: K1's result
//
// The float kernel: one block owns TA rows of A of one pair, resident in
// shared memory as f32 for the whole sweep over B; B streams through
// shared memory in tiles of TB rows, 32 dims at a time. Each thread
// accumulates its register tile of dots with f32 FMAs. For integer-valued
// descriptors (OpenCV SIFT's and the int8 store's) every product and
// partial sum is an integer below 2^24, so the dots are exact whatever the
// order of the sums. The epilogue is written with __fadd_rn/__fmul_rn so
// nvcc cannot contract it into FMAs: the plain PyTorch version rounds each
// operation on its own. Its bf16 instantiations (operands widened to f32
// in shared memory) are the probes' and, with its f32 K1 modes, the timing
// yardsticks of the tensor-core body (knn_ffma_bf16 and knn_ffma_f32 in
// knn_probe.cu, each in K1's modes and K3's).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace knn {

constexpr int kDim = 128;
constexpr int kTA = 64;             // A rows per block
constexpr int kTB = 64;             // B rows per streamed tile
constexpr int kKC = 32;             // dims per streamed B chunk (float path)
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kKeyMax = 0x7FFFFFFF;
constexpr int kIdxMask = 0x1FFF;    // packed keys hold indices < 8192
constexpr int kGatedBits = kKeyMax & ~kIdxMask;
constexpr long long kWideMax = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kWords = 32;          // 128 int8 = 32 int32 words per row
constexpr int kLds8 = kWords + 1;   // padded shared row: conflict-free reads

// kProductRowSum and kProductRowMin: the tensor-core body's product with
// a wrapping row sum (the probes' product-only stage) or the row minimum
// of the dots (P6) in place of the keys. kProductTop1, kProductTop2Tile
// and kProductTop2: kPacked's d2 and keys with only part of its epilogue
// (P3's stages on the tensor-core body): the row top-1; the row top-2
// restarted at every B tile (the last tile's); the running row top-2. The
// three leave the column minimum out and col_p alone. kFused (P2,
// knn_fused_probe.cu only): kPacked on int8 with a tail where the row
// keys leave the block, the pb gather and K4's epilogue (knn_tc.cuh);
// the TPU probe's variants are flags added to it.
enum Mode {
  kPacked = 0, kPackedGated = 1, kWide = 2, kProductRowSum = 3,
  kProductRowMin = 4, kProductTop1 = 5, kProductTop2Tile = 6,
  kProductTop2 = 7, kFused = 16
};
enum FusedFlag {
  kFusedNoPb = 1, kFusedNoEpi = 2, kFusedNoMain = 4,
  kFusedEpiHalf = 8                 // the epilogue on half the block
};
__host__ __device__ constexpr bool fused(int mode) {
  return (mode & ~15) == kFused;
}
// the modes that compute keys (K1's and K3's, P2's), not the probes'
// reductions
__host__ __device__ constexpr bool keyed(int mode) {
  return mode == kPacked || mode == kPackedGated || mode == kWide ||
         fused(mode);
}
// the probes' modes with K1's packed row keys, and no column
__host__ __device__ constexpr bool row_keyed(int mode) {
  return mode == kProductTop1 || mode == kProductTop2Tile ||
         mode == kProductTop2;
}
// the modes that read the squared norms
__host__ __device__ constexpr bool normed(int mode) {
  return keyed(mode) || row_keyed(mode);
}
enum Stage {
  kRowSum = 0, kRowMin = 1, kTop1 = 2, kTop2Tile = 3, kTop2 = 4, kFull = 5
};

// dx*dx + dy*dy > radius2 with every operation rounded on its own: an FMA
// would move candidates that sit on the gate's boundary
__device__ __forceinline__ bool gated_out(float ax, float ay, float bx,
                                          float by, float radius2) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) > radius2;
}

// f32 bits → an int32 that orders like the float, negatives included
__device__ __forceinline__ int orderable(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

// (orderable value, index) as one signed 64-bit key: the minimum is the
// smallest value, and among equal values the lowest index
__device__ __forceinline__ long long wide_key(float d2, int idx) {
  return (long long)(((unsigned long long)(unsigned)orderable(d2) << 32) |
                     (unsigned)idx);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t h) {  // bf16 bits
  return __uint_as_float((unsigned)h << 16);
}

__device__ __forceinline__ int row_norm(const int* row) {
  int s = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) s = __dp4a(row[k], row[k], s);
  return s;
}

// Insert key rk into the ordered pair (k1 <= k2)
template <typename K>
__device__ __forceinline__ void insert2(K rk, K& k1, K& k2) {
  if (rk < k1) { k2 = k1; k1 = rk; }
  else if (rk < k2) { k2 = rk; }
}

// Merge the 16 partial lists of a row (lanes 0-15 / 16-31 of a warp) and
// write them: top-2 keys, or for the stages before kTop2Tile one value
// (sum, min or top-1) into both slots
template <int STAGE>
__device__ __forceinline__ void merge_row(int r1, int r2, int tx,
                                          int* out) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    const int o1 = __shfl_xor_sync(0xffffffffu, r1, off);
    if (STAGE == kRowSum) {
      r1 = (int)((unsigned)r1 + (unsigned)o1);
    } else if (STAGE <= kTop1) {
      r1 = min(r1, o1);
    } else {
      const int o2 = __shfl_xor_sync(0xffffffffu, r2, off);
      const int n2 = min(max(r1, o1), min(r2, o2));
      r1 = min(r1, o1);
      r2 = n2;
    }
  }
  if (tx == 0) {
    out[0] = r1;
    out[1] = STAGE <= kTop1 ? r1 : r2;
  }
}

// The __dp4a int8 body for one block (blockIdx.x: A tile, blockIdx.y:
// pair); its full stage is K1's int8 result.
// Inputs (n_pairs, n, 32) int32 words of 128 int8; row_p (n_pairs, n_a, 2)
// and col_p (n_pairs, n_b) int32, col_p pre-filled with 0x7FFFFFFF (read
// and written by kFull only). A __device__ function so that the fused
// probe can run its epilogue after it in the same launch.
template <bool GATED, int STAGE, int TA, int TB>
__device__ __forceinline__ void knn_i8_block(
    const int* __restrict__ a, const int* __restrict__ b,
    const float* __restrict__ uv_a, const float* __restrict__ pred_b,
    float radius2, int* __restrict__ row_p, int* __restrict__ col_p,
    int n_a, int n_b) {
  static_assert(TA % 16 == 0 && TB % 16 == 0 && TA <= 128 && TB <= 128,
                "tiles of 16..128 rows");
  constexpr int RI = TA / 16;       // rows per thread: ty + 16 i
  constexpr int RJ = TB / 16;       // cols per thread: tx + 16 j
  constexpr bool kKeys = STAGE >= kTop1;
  __shared__ int sa[TA * kLds8];
  __shared__ int sb[TB * kLds8];
  __shared__ int na2[TA];
  __shared__ int nb2[TB];
  __shared__ int colmin[TB];
  __shared__ float sua[TA * 2];
  __shared__ float spb[TB * 2];

  const int pair = blockIdx.y;
  const int a0 = blockIdx.x * TA;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int* A = a + ((size_t)pair * n_a + a0) * kWords;
  const int* Bm = b + (size_t)pair * n_b * kWords;
  int* colp = col_p + (size_t)pair * n_b;

  for (int w = tid; w < TA * kWords; w += kThreads)
    sa[(w / kWords) * kLds8 + (w % kWords)] = A[w];
  if (GATED && tid < TA * 2)
    sua[tid] = uv_a[((size_t)pair * n_a + a0) * 2 + tid];
  __syncthreads();
  if (kKeys && tid < TA) na2[tid] = row_norm(sa + tid * kLds8);

  int r1[RI], r2[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    r1[i] = STAGE == kRowSum ? 0 : kKeyMax;
    r2[i] = kKeyMax;
  }

  for (int b0 = 0; b0 < n_b; b0 += TB) {
    __syncthreads();                // previous tile fully consumed
    const int* Bt = Bm + (size_t)b0 * kWords;
    for (int w = tid; w < TB * kWords; w += kThreads)
      sb[(w / kWords) * kLds8 + (w % kWords)] = Bt[w];
    if (STAGE == kFull && tid < TB) colmin[tid] = kKeyMax;
    if (GATED && tid < TB * 2)
      spb[tid] = pred_b[((size_t)pair * n_b + b0) * 2 + tid];
    __syncthreads();
    if (kKeys) {
      if (tid < TB) nb2[tid] = row_norm(sb + tid * kLds8);
      __syncthreads();
    }

    int acc[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) acc[i][j] = 0;
#pragma unroll 8
    for (int k = 0; k < kWords; ++k) {
      int av[RI], bv[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) av[i] = sa[(ty + 16 * i) * kLds8 + k];
#pragma unroll
      for (int j = 0; j < RJ; ++j) bv[j] = sb[(tx + 16 * j) * kLds8 + k];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }

    if constexpr (STAGE == kRowSum) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j)
          r1[i] = (int)((unsigned)r1[i] + (unsigned)acc[i][j]);
    } else if constexpr (STAGE == kRowMin) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) r1[i] = min(r1[i], acc[i][j]);
    } else {
      if (STAGE == kTop2Tile) {
#pragma unroll
        for (int i = 0; i < RI; ++i) r1[i] = r2[i] = kKeyMax;
      }
      int ck[RJ];
#pragma unroll
      for (int j = 0; j < RJ; ++j) ck[j] = kKeyMax;
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int row = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const int col = tx + 16 * j;
          const int d2 = na2[row] + nb2[col] - 2 * acc[i][j];
          int bits = __float_as_int((float)d2) & ~kIdxMask;
          if (GATED && gated_out(sua[2 * row], sua[2 * row + 1],
                                 spb[2 * col], spb[2 * col + 1], radius2))
            bits = kGatedBits;
          const int rk = bits | (b0 + col);
          if (STAGE == kTop1) r1[i] = min(r1[i], rk);
          else insert2(rk, r1[i], r2[i]);
          if (STAGE == kFull) ck[j] = min(ck[j], bits | (a0 + row));
        }
      }
      if (STAGE == kFull) {
#pragma unroll
        for (int j = 0; j < RJ; ++j) atomicMin(&colmin[tx + 16 * j], ck[j]);
        __syncthreads();
        if (tid < TB) atomicMin(&colp[b0 + tid], colmin[tid]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i)
    merge_row<STAGE>(r1[i], r2[i], tx,
                     row_p + ((size_t)pair * n_a + a0 + ty + 16 * i) * 2);
}

template <bool GATED, int STAGE, int TA, int TB>
__global__ void __launch_bounds__(kThreads)
knn_i8_kernel(const int* __restrict__ a, const int* __restrict__ b,
              const float* __restrict__ uv_a,
              const float* __restrict__ pred_b, float radius2,
              int* __restrict__ row_p, int* __restrict__ col_p, int n_a,
              int n_b) {
  knn_i8_block<GATED, STAGE, TA, TB>(a, b, uv_a, pred_b, radius2, row_p,
                                     col_p, n_a, n_b);
}

// The float body. MODE kPacked and kPackedGated write packed keys (K1),
// kWide 64-bit keys (K3); the stages before kFull exist for kPacked only
// (the probe). kRowSum adds each dot as an int (exact for the integer-
// valued descriptors the probe takes); kRowMin keeps the f32 minimum and
// writes it as an int.
template <typename T, int MODE, int STAGE = kFull, int TA = kTA,
          int TB = kTB>
__global__ void __launch_bounds__(kThreads)
knn_float_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const float* __restrict__ na2, const float* __restrict__ nb2,
                 const float* __restrict__ uv_a,
                 const float* __restrict__ pred_b, float radius2,
                 int* __restrict__ row_p, int* __restrict__ col_p,
                 long long* __restrict__ row_k, long long* __restrict__ col_k,
                 int n_a, int n_b) {
  static_assert(TA % 16 == 0 && TB % 16 == 0, "tiles of 16-row multiples");
  static_assert(MODE == kPacked || STAGE == kFull, "stages: kPacked only");
  constexpr int RI = TA / 16;
  constexpr int RJ = TB / 16;
  constexpr bool kKeys = STAGE >= kTop1;
  constexpr int kLdsA = kDim + 1;   // padded rows: conflict-free reads
  constexpr int kLdsB = kKC + 1;
  __shared__ float sa[TA * kLdsA];
  __shared__ float sb[TB * kLdsB];
  __shared__ float sna[TA];
  __shared__ float snb[TB];
  __shared__ float sua[TA * 2];
  __shared__ float spb[TB * 2];
  __shared__ int colmin[TB];
  __shared__ long long colmin_w[TB];

  const int pair = blockIdx.y;
  const int a0 = blockIdx.x * TA;
  const int tid = threadIdx.x;
  const int tx = tid & 15;          // column group: cols tx + 16 j
  const int ty = tid >> 4;          // row group: rows ty + 16 i
  const T* A = a + ((size_t)pair * n_a + a0) * kDim;
  const T* Bm = b + (size_t)pair * n_b * kDim;

  for (int w = tid; w < TA * kDim; w += kThreads)
    sa[(w / kDim) * kLdsA + (w % kDim)] = to_f32(A[w]);
  if (kKeys && tid < TA) sna[tid] = na2[(size_t)pair * n_a + a0 + tid];
  if (MODE == kPackedGated && tid < TA * 2)
    sua[tid] = uv_a[((size_t)pair * n_a + a0) * 2 + tid];

  int r1[RI], r2[RI];
  long long w1[RI], w2[RI];
  float fm[RI];                     // kRowMin: the f32 minimum
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    r1[i] = STAGE == kRowSum ? 0 : kKeyMax;
    r2[i] = kKeyMax;
    w1[i] = w2[i] = kWideMax;
    fm[i] = __int_as_float(0x7F800000);
  }

  for (int b0 = 0; b0 < n_b; b0 += TB) {
    float acc[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) acc[i][j] = 0.f;
    const T* Bt = Bm + (size_t)b0 * kDim;
    for (int kc = 0; kc < kDim; kc += kKC) {
      __syncthreads();              // previous chunk fully consumed
      for (int w = tid; w < TB * kKC; w += kThreads)
        sb[(w / kKC) * kLdsB + (w % kKC)] =
            to_f32(Bt[(size_t)(w / kKC) * kDim + kc + (w % kKC)]);
      if (kc == 0) {
        if (tid < TB) {
          if (kKeys) snb[tid] = nb2[(size_t)pair * n_b + b0 + tid];
          colmin[tid] = kKeyMax;
          colmin_w[tid] = kWideMax;
        }
        if (MODE == kPackedGated && tid < TB * 2)
          spb[tid] = pred_b[((size_t)pair * n_b + b0) * 2 + tid];
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kKC; ++k) {
        float av[RI], bv[RJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) av[i] = sa[(ty + 16 * i) * kLdsA + kc + k];
#pragma unroll
        for (int j = 0; j < RJ; ++j) bv[j] = sb[(tx + 16 * j) * kLdsB + k];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RJ; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    if constexpr (STAGE == kRowSum) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j)
          r1[i] = (int)((unsigned)r1[i] + (unsigned)__float2int_rz(acc[i][j]));
      continue;
    } else if constexpr (STAGE == kRowMin) {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) fm[i] = fminf(fm[i], acc[i][j]);
      continue;
    }
    if (STAGE == kTop2Tile) {
#pragma unroll
      for (int i = 0; i < RI; ++i) r1[i] = r2[i] = kKeyMax;
    }
    int ck[RJ];
    long long cw[RJ];
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      ck[j] = kKeyMax;
      cw[j] = kWideMax;
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int col = tx + 16 * j;
        // (|a|^2 + |b|^2) - 2 a.b, as the reference and the plain version
        float d2 = __fsub_rn(__fadd_rn(sna[row], snb[col]),
                             __fmul_rn(2.f, acc[i][j]));
        if (MODE == kWide) {
          d2 = __fadd_rn(d2, 0.f);  // -0 → +0: equal values tie on index
          insert2(wide_key(d2, b0 + col), w1[i], w2[i]);
          const long long k2 = wide_key(d2, a0 + row);
          cw[j] = k2 < cw[j] ? k2 : cw[j];
        } else {
          int bits = __float_as_int(fmaxf(d2, 0.f)) & ~kIdxMask;
          if (MODE == kPackedGated &&
              gated_out(sua[2 * row], sua[2 * row + 1], spb[2 * col],
                        spb[2 * col + 1], radius2))
            bits = kGatedBits;
          const int rk = bits | (b0 + col);
          if (STAGE == kTop1) r1[i] = min(r1[i], rk);
          else insert2(rk, r1[i], r2[i]);
          if (STAGE == kFull) ck[j] = min(ck[j], bits | (a0 + row));
        }
      }
    }
    if (STAGE == kFull) {
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        if (MODE == kWide) atomicMin(&colmin_w[tx + 16 * j], cw[j]);
        else atomicMin(&colmin[tx + 16 * j], ck[j]);
      }
      __syncthreads();
      if (tid < TB) {
        if (MODE == kWide)
          atomicMin(&col_k[(size_t)pair * n_b + b0 + tid], colmin_w[tid]);
        else
          atomicMin(&col_p[(size_t)pair * n_b + b0 + tid], colmin[tid]);
      }
    }
  }

  // merge the 16 partial lists of each row (lanes 0-15 / 16-31)
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    if (MODE == kWide) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const long long o1 = __shfl_xor_sync(0xffffffffu, w1[i], off);
        const long long o2 = __shfl_xor_sync(0xffffffffu, w2[i], off);
        const long long hi = w1[i] > o1 ? w1[i] : o1;
        const long long lo2 = w2[i] < o2 ? w2[i] : o2;
        w1[i] = w1[i] < o1 ? w1[i] : o1;
        w2[i] = hi < lo2 ? hi : lo2;
      }
      if (tx == 0) {
        const size_t r = ((size_t)pair * n_a + a0 + ty + 16 * i) * 2;
        row_k[r] = w1[i];
        row_k[r + 1] = w2[i];
      }
    } else {
      if (STAGE == kRowMin) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          fm[i] = fminf(fm[i], __shfl_xor_sync(0xffffffffu, fm[i], off));
        r1[i] = __float2int_rz(fm[i]);
      }
      merge_row<STAGE == kRowMin ? kTop1 : STAGE>(
          r1[i], r2[i], tx,
          row_p + ((size_t)pair * n_a + a0 + ty + 16 * i) * 2);
    }
  }
}

// shape checks shared by every entry point
inline bool bad_shape(int n_pairs, int n_a, int n_b, int max_rows) {
  return n_pairs <= 0 || n_a <= 0 || n_b <= 0 || n_a % kTA || n_b % kTB ||
         n_a > max_rows || n_b > max_rows || n_pairs > 65535;
}

}  // namespace knn

#include "knn_tc.cuh"
