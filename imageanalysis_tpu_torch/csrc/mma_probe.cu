// Tensor-core probes, for Hopper (sm_90a), through inline PTX: P5's
// product + row sum on wgmma fed by TMA (hopper.cuh), its first body and
// P1's one-hot gather on mma.sync m16n8k16 bf16 -> f32 (mma_sync.cuh,
// shared with K1/K3's bf16 body).
//
// mm_rowsum_wg replaces scripts_dev/matmul_shape_probe.py:33 (mm_kernel,
// P5): the descriptor product's rate against K and tile. For each matrix
// of a batch,
//   out[m] = sum_n sum_k a[m, k] b[n, k]       a (M, K), b (N, K) bf16
// with f32 accumulation: the product K1 and K3 compute, with the
// cheapest epilogue (a row sum) in place of their keys. Every one of the
// 2 M N K products runs on the tensor cores: the probe's subject is the
// product's rate at the descriptor shape.
// What bounds it on the H100 (bench's batch, 64 x 6144 x 6144 x 128):
// - the tensor cores: 618.5 GFLOP at 989 TFLOP/s, 0.625 ms;
// - not HBM: A and B are read once, 201 MB, 0.06 ms;
// - the L2 -> SM feed: every block reads all of its matrix's B (1.57 MB
//   at K = 128). At BM = 128 A rows a block that is 48 reads a matrix,
//   4.83 GB for the batch, 7.7 TB/s from L2 at the bound; at BM = 256,
//   2.42 GB, 3.9 TB/s. (A cluster of two blocks along M with TMA
//   multicast of each B tile would halve it again; not done here.)
// Design (hopper.cuh's head has the layouts):
// - warp specialisation: 384 threads, warpgroups 0 and 1 consumers, 2 the
//   producer, whose one thread issues every TMA load; setmaxnreg gives
//   the producer's registers (40) to the consumers (232). Shared memory
//   is sized so that one block holds an SM (the register move needs it);
// - A resident, B streamed: the block's BM rows of A, in 64-dim chunks of
//   BM x 128 bytes, stay in shared memory while all of B's BN-row tiles
//   stream past in a ring of one-chunk stages (BN x 128 bytes), each with
//   a full and an empty mbarrier. Where A's K does not fit beside four
//   stages (K = 512 at BM = 256), K is cut into passes: A's chunks of a
//   pass are loaded, all of B streams past with the same chunks, and the
//   next pass reloads A once both consumers are done with it;
// - each consumer warpgroup owns BM / 2 rows, in m64 halves, and issues
//   wgmma.m64nWNk16 (WN = min(BN, 128)) from both operands in shared
//   memory, 4 k-steps a chunk; one group in flight, a stage released one
//   stage late. Shared memory feeds the tensor cores 96 bytes a clock at
//   their rate (of the SM's 128); A from registers (64) was no faster
//   (scripts_torch/mm_rowsum_designs.py keeps that design): under this
//   load the card runs at its power limit;
// - the row sum: the accumulators are never zeroed between tiles (scale-d
//   on throughout), so each holds its column slot's sum over every B
//   tile and pass; once at the end a thread adds its accumulators into
//   its two rows of each half, the quad's lanes are added by shuffles in
//   a fixed order, and lane 0 of the quad stores its rows' sums, or adds
//   them with atomicAdd where B's tiles are split over several blocks
//   (n_split > 1, to fill the card with one matrix);
// - TMA maps: 2-D over a (B M, K) and b (B N, K), 128-byte swizzle, boxes
//   of 64 dims x BM (A) or BN (B) rows; M and N are multiples of BM and
//   BN, so a box never crosses matrices (hopper.cuh's encode_tiled
//   fetches cuTensorMapEncodeTiled at run time).
// Integer-valued inputs whose sums stay below 2^24 give exact sums in any
// order.
// mm_rowsum_v0 is the first body, kept as the yardstick: 8 warps of
// mma.sync fed by ldmatrix from A and B tiles loaded synchronously (no
// cp.async, TMA or wgmma), rows padded to 144 B; a thread adds its
// accumulators into its rows' sums after each B tile.
//
// onehot_gather replaces scripts_dev/epilogue_dot_probe.py:25 (kern, P1):
//   out[t, c] = sum_n [j[t] == n] vals[c, n]   j (T) int32, vals (3, N) f32
// the one-hot gather the TPU's match epilogue ran on its matrix unit, at
// DEFAULT precision: the operands rounded to bf16 (nearest even) and
// multiplied exactly. The one-hot dot stays on the tensor cores, since it
// is the probe's subject: does the matrix unit's one-hot product return
// bf16 rows exactly? (a direct gather would give the same numbers and
// answer nothing). What bounds it: latency (37 KB of inputs, 4.7 MFLOP);
// its (T / 16) x (N / 16) mma.sync, and the instructions that build their
// one-hot operands, are the work. Design, so that one short launch does it
// all:
// - f32 vals are rounded in registers (cvt.rn.bf16x2.f32), as the TPU's
//   matrix unit rounds them: no conversion launch before it;
// - the work is spread over many SMs: a thread-block cluster of
//   kGatherCluster (8) blocks owns a 16-row group of T (T = 128: 64
//   blocks), block rank r the r-th eighth of N's k-steps of 16 columns,
//   its kGatherWarps (8) warps runs of kGatherSteps (6) k-steps. A warp
//   issues all of a run's loads (16 bytes a lane) before its first
//   mma.sync. The lanes of a quad (q = lane % 4) load 4 consecutive values
//   of a limb: b0 and b1 of mma.sync's B fragment hold k pairs 2q and
//   8 + 2q, so a k-step's 16 columns are taken in the order 4q, 4q + 1,
//   4q + 2, 4q + 3, and the one-hot A fragment is built in that order (the
//   product is unchanged);
// - the one-hot A fragment of a run is zero but for the k-step that holds
//   a row's j: a lane finds that step and its two non-zero registers once a
//   run, and selects them or zero at each step (a compare and two selects a
//   row; a compare-and-select per fragment value was ~3x the instructions,
//   and the kernel was issue-bound on the 8 SMs of one block a row group);
// - the warps' 16 x 8 accumulators are summed in shared memory in warp
//   order; the blocks' sums meet in rank 0's shared memory by st.async with
//   an mbarrier's byte count (no cluster-wide memory fence: cluster.sync()
//   costs a GPU-scope membar and an L1 invalidation), and rank 0 adds them
//   in rank order and writes each output once: no atomics, no zero-fill.
// Every product is 1.0 x a bf16 value or an exact zero, so any order of
// the sums is exact: out is vals[:, j] rounded to bf16 first.
// onehot_gather_v0 is the first body, kept as the yardstick: bf16 vals
// rounded by the caller, a warp a 512-column range of one 16-row group (a
// serial chain of 32 loads and mma.sync), its partial sums added into a
// zero-filled out with atomicAdd.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

using mma_sync::ldmatrix_x4;
using mma_sync::mma_bf16;

constexpr int kThreads = 256;
constexpr int kKC = 64;             // dims per shared-memory chunk
constexpr int kLds = kKC + 8;       // padded row: 144 B

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
mm_rowsum_kernel(const uint16_t* __restrict__ a,
                 const uint16_t* __restrict__ b, float* __restrict__ out,
                 int M, int N, int K, int n_split) {
  constexpr int WM = BM / 32;       // warps along M: 32 rows each
  constexpr int WN = 8 / WM;        // warps along N
  constexpr int MT = 2;             // m16 tiles per warp
  constexpr int NT = BN / WN / 8;   // n8 tiles per warp
  static_assert(WM * WN == 8 && NT % 2 == 0, "8 warps, n8 tiles in pairs");
  __shared__ __align__(16) uint16_t sa[BM * kLds];
  __shared__ __align__(16) uint16_t sb[BN * kLds];
  __shared__ float red[WN][BM];

  const int mat = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = (warp % WM) * 32;  // the warp's rows within the block
  const int wn = (warp / WM) * (BN / WN);
  const uint16_t* A = a + ((size_t)mat * M + m0) * K;
  const uint16_t* Bm = b + (size_t)mat * N * K;
  const int n_tiles = N / BN;
  const int t_begin = (int)((long long)blockIdx.y * n_tiles / n_split);
  const int t_end = (int)((long long)(blockIdx.y + 1) * n_tiles / n_split);

  float rs[MT][2];                  // this thread's rows: g and g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) rs[mt][0] = rs[mt][1] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const uint16_t* Bt = Bm + (size_t)t * BN * K;
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    for (int kc = 0; kc < K; kc += kKC) {
      __syncthreads();              // previous chunk fully consumed
      for (int w = tid; w < BM * (kKC / 8); w += kThreads) {
        const int r = w / (kKC / 8), c = (w % (kKC / 8)) * 8;
        *reinterpret_cast<uint4*>(sa + r * kLds + c) =
            *reinterpret_cast<const uint4*>(A + (size_t)r * K + kc + c);
      }
      for (int w = tid; w < BN * (kKC / 8); w += kThreads) {
        const int r = w / (kKC / 8), c = (w % (kKC / 8)) * 8;
        *reinterpret_cast<uint4*>(sb + r * kLds + c) =
            *reinterpret_cast<const uint4*>(Bt + (size_t)r * K + kc + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        unsigned af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                      sa + (wm + mt * 16 + (lane & 15)) * kLds + kk +
                          (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          unsigned b0, b1, b2, b3;  // (nt, k 0-7), (nt, k 8-15), nt + 1
          ldmatrix_x4(b0, b1, b2, b3,
                      sb + (wn + nt * 8 + (lane >> 4) * 8 + (lane & 7)) *
                                   kLds +
                          kk + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][nt], af[mt][0], af[mt][1], af[mt][2],
                     af[mt][3], b0, b1);
            mma_bf16(acc[mt][nt + 1], af[mt][0], af[mt][1], af[mt][2],
                     af[mt][3], b2, b3);
          }
        }
      }
    }
    // the row sum: c0, c1 are row g = lane / 4, c2, c3 row g + 8
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        rs[mt][0] += acc[mt][nt][0] + acc[mt][nt][1];
        rs[mt][1] += acc[mt][nt][2] + acc[mt][nt][3];
      }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rs[mt][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0)
        red[warp / WM][wm + mt * 16 + h * 8 + (lane >> 2)] = v;
    }
  __syncthreads();
  if (tid < BM) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WN; ++w) s += red[w][tid];
    float* o = out + (size_t)mat * M + m0 + tid;
    if (n_split == 1) *o = s;
    else atomicAdd(o, s);
  }
}

template <int BM, int BN>
int launch_mm(const void* a, const void* b, void* out, int batch, int M,
              int N, int K, int n_split, cudaStream_t s) {
  if (M % BM || N % BN || n_split > N / BN)
    return (int)cudaErrorInvalidValue;
  dim3 grid(M / BM, n_split, batch);
  mm_rowsum_kernel<BM, BN><<<grid, kThreads, 0, s>>>(
      (const uint16_t*)a, (const uint16_t*)b, (float*)out, M, N, K, n_split);
  return (int)cudaGetLastError();
}

constexpr int kWgThreads = 384;    // consumer warpgroups 0, 1; producer 2
constexpr int kWgMaxStages = 16;
constexpr int kWgSmem = 232448;     // the most a block may hold (227 KB)
constexpr int kWgChunk = 128;       // bytes of a row's 64-dim chunk

// Shared memory of a (bm, bn) block at K: A's chunks a pass, the ring's
// stages, and the dynamic bytes (with 1024 of alignment slack). Stages
// fill what A leaves, at most kWgMaxStages: always more than half of the
// SM, so one block holds it (setmaxnreg counts on that).
struct WgPlan {
  int stages, passes, chunks, smem;
};

WgPlan wg_plan(int bm, int bn, int K) {
  const int kc = K / 64, a_chunk = bm * kWgChunk, stage = bn * kWgChunk;
  const int budget = kWgSmem - 1024 - 1024;   // slack; static barriers
  const int most = (budget - 4 * stage) / a_chunk;
  if (kc <= 0 || most <= 0) return {0, 0, 0, 0};
  const int passes = (kc + most - 1) / most;
  const int chunks = (kc + passes - 1) / passes;
  int stages = (budget - chunks * a_chunk) / stage;
  if (stages > kWgMaxStages) stages = kWgMaxStages;
  return {stages, passes, chunks, 1024 + chunks * a_chunk + stages * stage};
}

template <int BM, int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
mm_rowsum_wg_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    float* __restrict__ out, int M, int N, int kc,
                    int chunks, int stages, int n_split) {
  using namespace hopper;
  constexpr int MH = BM / 128;      // m64 halves a consumer warpgroup
  constexpr int WN = BN > 128 ? 128 : BN;   // wgmma's N
  constexpr int NJ = BN / WN;       // wgmma columns blocks a B stage
  constexpr int A_CHUNK = BM * kWgChunk, STAGE = BN * kWgChunk;
  extern __shared__ uint8_t raw[];
  __shared__ __align__(8) uint64_t full[kWgMaxStages];
  __shared__ __align__(8) uint64_t empty[kWgMaxStages];
  __shared__ __align__(8) uint64_t a_full, a_empty;
  const uint32_t base = smem_u32(raw);
  uint8_t* sa = raw + (((base + 1023u) & ~1023u) - base);
  uint8_t* sb = sa + chunks * A_CHUNK;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);      // one arrival a consumer warpgroup
    }
    mbar_init(&a_full, 1);
    mbar_init(&a_empty, 2);
    mbar_init_fence();
  }
  __syncthreads();

  const int mat = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n_tiles = N / BN;
  const int t_begin = (int)((long long)blockIdx.y * n_tiles / n_split);
  const int t_end = (int)((long long)(blockIdx.y + 1) * n_tiles / n_split);
  const int passes = (kc + chunks - 1) / chunks;

  if (tid >= 256) {                 // the producer warpgroup
    regs_dec<40>();
    if (tid != 256) return;
    tma_prefetch(&ta);
    tma_prefetch(&tb);
    int s = 0;
    uint32_t ph = 0;
    for (int p = 0; p < passes; ++p) {
      const int c0 = p * chunks, nc = min(chunks, kc - c0);
      if (p > 0) mbar_wait(&a_empty, (p - 1) & 1);
      mbar_expect_tx(&a_full, nc * A_CHUNK);
      for (int c = 0; c < nc; ++c)
        tma_load_2d(sa + c * A_CHUNK, &ta, &a_full, (c0 + c) * 64,
                    mat * M + m0);
      for (int t = t_begin; t < t_end; ++t)
        for (int c = 0; c < nc; ++c) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], STAGE);
          tma_load_2d(sb + s * STAGE, &tb, &full[s], (c0 + c) * 64,
                      mat * N + t * BN);
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
    }
    return;
  }

  regs_inc<232>();
  const int wg = tid >> 7;          // consumer warpgroup: rows wg BM / 2..
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const bool leader = (tid & 127) == 0;
  float acc[MH][WN / 2];
#pragma unroll
  for (int h = 0; h < MH; ++h)
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[h][i] = 0.f;
  int s = 0, held = -1;
  uint32_t ph = 0;
  for (int p = 0; p < passes; ++p) {
    const int nc = min(chunks, kc - p * chunks);
    mbar_wait(&a_full, p & 1);
    for (int t = t_begin; t < t_end; ++t)
      for (int c = 0; c < nc; ++c) {
        mbar_wait(&full[s], ph);
#pragma unroll
        for (int h = 0; h < MH; ++h)
#pragma unroll
          for (int i = 0; i < WN / 2; ++i) reg_fence(acc[h][i]);
        wgmma_fence();
        const uint8_t* at = sa + c * A_CHUNK + wg * (BM / 2) * kWgChunk;
        const uint8_t* bt = sb + s * STAGE;
#pragma unroll
        for (int h = 0; h < MH; ++h)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t da = desc_sw128(at + h * 64 * kWgChunk + kk * 32);
              const uint64_t db = desc_sw128(bt + j * WN * kWgChunk + kk * 32);
              if constexpr (WN == 128) wgmma_128(acc[h], da, db);
              else wgmma_64(acc[h], da, db);
            }
        wgmma_commit();
        wgmma_wait<1>();            // the stage before is read: release it
#pragma unroll
        for (int h = 0; h < MH; ++h)
#pragma unroll
          for (int i = 0; i < WN / 2; ++i) reg_fence(acc[h][i]);
        if (held >= 0 && leader) mbar_arrive(&empty[held]);
        held = s;
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < MH; ++h)
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) reg_fence(acc[h][i]);
    if (leader) {
      mbar_arrive(&empty[held]);
      mbar_arrive(&a_empty);        // this pass's A chunks are read
    }
    held = -1;
  }

  // the row sum: d[i] is row l / 4 + 8 ((i / 2) % 2) of the warp's 16
#pragma unroll
  for (int h = 0; h < MH; ++h) {
    float r[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) r[(i >> 1) & 1] += acc[h][i];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      r[e] += __shfl_xor_sync(0xffffffffu, r[e], 1);
      r[e] += __shfl_xor_sync(0xffffffffu, r[e], 2);
    }
    if ((lane & 3) == 0) {
      float* o = out + (size_t)mat * M + m0 + wg * (BM / 2) + h * 64 +
                 warp * 16 + (lane >> 2);
      if (n_split == 1) {
        o[0] = r[0];
        o[8] = r[1];
      } else {
        atomicAdd(o, r[0]);
        atomicAdd(o + 8, r[1]);
      }
    }
  }
}

// a 2-D map over rows x K bf16 (row-major), boxes of 64 dims x box_rows,
// 128-byte swizzle
int encode_rows(CUtensorMap* map, const void* p, long long rows, int K,
                int box_rows) {
  hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(p), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BM, int BN>
int launch_wg(const void* a, const void* b, void* out, int batch, int M,
              int N, int K, int n_split, cudaStream_t s) {
  const WgPlan pl = wg_plan(BM, BN, K);
  if (M % BM || N % BN || n_split > N / BN || pl.stages < 2)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int err = encode_rows(&ta, a, (long long)batch * M, K, BM);
  if (err == 0) err = encode_rows(&tb, b, (long long)batch * N, K, BN);
  if (err) return err;
  auto kernel = mm_rowsum_wg_kernel<BM, BN>;
  static int smem_allowed = 0;      // the opt-in, raised as plans need
  if (pl.smem > smem_allowed) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err) return err;
    smem_allowed = pl.smem;
  }
  dim3 grid(M / BM, n_split, batch);
  kernel<<<grid, kWgThreads, pl.smem, s>>>(ta, tb, (float*)out, M, N, K / 64,
                                           pl.chunks, pl.stages, n_split);
  return (int)cudaGetLastError();
}

const void* wg_kernel(int bm, int bn) {
  if (bm == 128 && bn == 128)
    return (const void*)mm_rowsum_wg_kernel<128, 128>;
  if (bm == 256 && bn == 64) return (const void*)mm_rowsum_wg_kernel<256, 64>;
  if (bm == 256 && bn == 128)
    return (const void*)mm_rowsum_wg_kernel<256, 128>;
  if (bm == 256 && bn == 256)
    return (const void*)mm_rowsum_wg_kernel<256, 256>;
  return nullptr;
}

constexpr int kV0Cols = 512;        // v0: N columns per warp
constexpr int kV0Warps = 4;         // v0: 16 rows each

__device__ __forceinline__ unsigned onehot2(int j, int k) {
  return (j == k ? 0x3F80u : 0u) | (j == k + 1 ? 0x3F800000u : 0u);
}

__global__ void __launch_bounds__(kV0Warps * 32)
onehot_gather_v0_kernel(const int* __restrict__ j,
                        const uint16_t* __restrict__ vals,
                        float* __restrict__ out, int T, int N) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kV0Warps + warp) * 16;
  if (row0 >= T) return;
  const int g = lane >> 2;          // fragment row; B column
  const int q = (lane & 3) * 2;     // fragment column pair
  const int ja = j[row0 + g];
  const int jb = j[row0 + g + 8];
  const int k_begin = blockIdx.y * kV0Cols;
  const int k_end = min(N, k_begin + kV0Cols);
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = k_begin; k0 < k_end; k0 += 16) {
    const int k = k0 + q;
    // A (16 x 16): a0 row g, cols k, k+1; a1 row g+8; a2, a3 cols k+8, k+9
    const unsigned a0 = onehot2(ja, k), a1 = onehot2(jb, k);
    const unsigned a2 = onehot2(ja, k + 8), a3 = onehot2(jb, k + 8);
    // B (16 x 8) column g = vals row g: b0 rows k, k+1; b1 rows k+8, k+9
    unsigned b0 = 0u, b1 = 0u;
    if (g < 3) {
      b0 = *reinterpret_cast<const unsigned*>(vals + (size_t)g * N + k);
      b1 = *reinterpret_cast<const unsigned*>(vals + (size_t)g * N + k + 8);
    }
    mma_bf16(c, a0, a1, a2, a3, b0, b1);
  }
  // c0, c1: row g, columns q, q+1; c2, c3: row g + 8
  if (q < 3) {
    atomicAdd(out + (size_t)(row0 + g) * 3 + q, c[0]);
    atomicAdd(out + (size_t)(row0 + g + 8) * 3 + q, c[2]);
  }
  if (q + 1 < 3) {
    atomicAdd(out + (size_t)(row0 + g) * 3 + q + 1, c[1]);
    atomicAdd(out + (size_t)(row0 + g + 8) * 3 + q + 1, c[3]);
  }
}

constexpr int kGatherCluster = 8;   // blocks a 16-row group
constexpr int kGatherWarps = 8;    // warps a block
constexpr int kGatherSteps = 6;     // k-steps of 16 columns in a warp's run

// bf16x2 of (lo, hi), each rounded to nearest even; lo in the low half
__device__ __forceinline__ unsigned bf16x2_rn(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One row's one-hot A registers for the run of k-steps from column k0, in
// the column order above: the step that holds j (-1: none), and the
// registers' values there (lo: columns 4q, 4q + 1; hi: 4q + 2, 4q + 3)
struct OneHot {
  int step;
  unsigned lo, hi;
};
__device__ __forceinline__ OneHot onehot_run(int j, int k0, int q) {
  const int e = j - k0 - 4 * q;     // 16 step + r, r in 0..3 on a hit
  const int r = e & 15;
  const unsigned one = 0x3F80u << (16 * (r & 1));   // bf16 1.0, low or high
  return {e >= 0 && r < 4 ? e >> 4 : -1, r < 2 ? one : 0u,
          r >= 2 ? one : 0u};
}

__global__ void __cluster_dims__(kGatherCluster, 1, 1)
__launch_bounds__(kGatherWarps * 32, 1)
onehot_gather_kernel(const int* __restrict__ j,
                     const float* __restrict__ vals,
                     float* __restrict__ out, int N) {
  __shared__ __align__(8) unsigned long long bar;   // rank 0's
  __shared__ float red[kGatherWarps][48];
  __shared__ float parts[kGatherCluster][48];       // rank 0's
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  if (rank == 0 && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(&bar)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // waited on before the sums travel: rank 0's barrier is then initialised
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x / kGatherCluster) * 16;
  const int g = lane >> 2;          // fragment row; B column (the limb)
  const int q = lane & 3;
  const int S = N / 16;             // k-steps
  const int s_end = (int)((long long)(rank + 1) * S / kGatherCluster);
  const int ja = j[row0 + g];
  const int jb = j[row0 + g + 8];
  const float* v = vals + (size_t)(g < 3 ? g : 0) * N + 4 * q;
  float c[2][4] = {};               // two chains of mma.sync
  for (int s0 = (int)((long long)rank * S / kGatherCluster) +
                warp * kGatherSteps;
       s0 < s_end; s0 += kGatherWarps * kGatherSteps) {
    const OneHot ha = onehot_run(ja, 16 * s0, q);
    const OneHot hb = onehot_run(jb, 16 * s0, q);
    float4 x[kGatherSteps];
#pragma unroll
    for (int s = 0; s < kGatherSteps; ++s)
      x[s] = g < 3 && s0 + s < s_end
                 ? *reinterpret_cast<const float4*>(v + 16 * (s0 + s))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kGatherSteps; ++s)
      if (s0 + s < s_end)           // warp-uniform
        mma_bf16(c[s & 1], ha.step == s ? ha.lo : 0u,
                 hb.step == s ? hb.lo : 0u, ha.step == s ? ha.hi : 0u,
                 hb.step == s ? hb.hi : 0u, bf16x2_rn(x[s].x, x[s].y),
                 bf16x2_rn(x[s].z, x[s].w));
  }
  // c0, c1: row g, columns 2q, 2q + 1; c2, c3: row g + 8
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (2 * q + e < 3) {
      red[warp][3 * g + 2 * q + e] = c[0][e] + c[1][e];
      red[warp][3 * (g + 8) + 2 * q + e] = c[0][2 + e] + c[1][2 + e];
    }
  __syncthreads();
  float sum = 0.f;
  if (threadIdx.x < 48) {
#pragma unroll
    for (int w = 0; w < kGatherWarps; ++w) sum += red[w][threadIdx.x];
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x >= 48) return;
  if (rank != 0) {
    // into rank 0's parts[rank], counted by its barrier's bytes
    unsigned dst, rbar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
                 : "=r"(dst) : "r"(smem_u32(&parts[rank][threadIdx.x])));
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
                 : "=r"(rbar) : "r"(smem_u32(&bar)));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], "
        "%1, [%2];\n"
        :: "r"(dst), "r"(__float_as_uint(sum)), "r"(rbar) : "memory");
    return;
  }
  if (threadIdx.x == 0)
    asm volatile(
        "{\n .reg .b64 st;\n"
        " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
        :: "r"(smem_u32(&bar)), "r"((kGatherCluster - 1) * 48 * 4)
        : "memory");
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(&bar)) : "memory");
#pragma unroll
  for (int r = 1; r < kGatherCluster; ++r) sum += parts[r][threadIdx.x];
  out[(size_t)row0 * 3 + threadIdx.x] = sum;
}

}  // namespace

// a (batch, M, K), b (batch, N, K) bf16 bits, 16-byte aligned; out (batch,
// M) f32, zero-filled when n_split > 1. K a multiple of 64; (bm, bn) one of
// (128, 128), (256, 64), (256, 128), (256, 256) with M % bm = N % bn = 0;
// 1 <= n_split <= N / bn. Returns the cudaError_t of the launch (that of
// the tensor maps' encoding where it fails).
extern "C" int mm_rowsum_bf16_wg(const void* a, const void* b, void* out,
                                 int batch, int M, int N, int K, int bm,
                                 int bn, int n_split, void* stream) {
  if (batch <= 0 || batch > 65535 || M <= 0 || N <= 0 || K <= 0 ||
      K % 64 || n_split <= 0 || n_split > 65535 ||
      wg_kernel(bm, bn) == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 128)
    return launch_wg<128, 128>(a, b, out, batch, M, N, K, n_split, s);
  if (bn == 64)
    return launch_wg<256, 64>(a, b, out, batch, M, N, K, n_split, s);
  if (bn == 128)
    return launch_wg<256, 128>(a, b, out, batch, M, N, K, n_split, s);
  return launch_wg<256, 256>(a, b, out, batch, M, N, K, n_split, s);
}

// mm_rowsum_bf16_wg's plan at (bm, bn, K) into plan[5]: ring stages, K
// passes, 64-dim chunks of A a pass, dynamic shared bytes, and the blocks
// an SM of the current card holds (the occupancy calculator's count).
// Returns a cudaError_t.
extern "C" int mm_rowsum_wg_plan(int bm, int bn, int K, int* plan) {
  const void* kernel = wg_kernel(bm, bn);
  if (kernel == nullptr || K <= 0 || K % 64)
    return (int)cudaErrorInvalidValue;
  const WgPlan pl = wg_plan(bm, bn, K);
  if (pl.stages < 2) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  int blocks = 0;
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kWgThreads, pl.smem);
  plan[0] = pl.stages;
  plan[1] = pl.passes;
  plan[2] = pl.chunks;
  plan[3] = pl.smem;
  plan[4] = blocks;
  return err;
}

// The first body: a, b, out and n_split as mm_rowsum_bf16_wg; K a multiple
// of 64; (bm, bn) one of (64, 64), (64, 128), (128, 64), (128, 128) with
// M % bm = N % bn = 0. Returns the cudaError_t of the launch.
extern "C" int mm_rowsum_bf16(const void* a, const void* b, void* out,
                              int batch, int M, int N, int K, int bm,
                              int bn, int n_split, void* stream) {
  if (batch <= 0 || batch > 65535 || M <= 0 || N <= 0 || K <= 0 ||
      K % kKC || n_split <= 0 || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 64 && bn == 64)
    return launch_mm<64, 64>(a, b, out, batch, M, N, K, n_split, s);
  if (bm == 64 && bn == 128)
    return launch_mm<64, 128>(a, b, out, batch, M, N, K, n_split, s);
  if (bm == 128 && bn == 64)
    return launch_mm<128, 64>(a, b, out, batch, M, N, K, n_split, s);
  if (bm == 128 && bn == 128)
    return launch_mm<128, 128>(a, b, out, batch, M, N, K, n_split, s);
  return (int)cudaErrorInvalidValue;
}

// j (T) int32 in [0, N); vals (3, N) f32, 16-byte aligned; out (T, 3)
// f32, every value written. T a multiple of 16, N a multiple of 16.
// Returns the cudaError_t of the launch.
extern "C" int onehot_gather_bf16(const void* j, const void* vals, void* out,
                                  int T, int N, void* stream) {
  if (T <= 0 || N <= 0 || T % 16 || N % 16) return (int)cudaErrorInvalidValue;
  onehot_gather_kernel<<<T / 16 * kGatherCluster, kGatherWarps * 32, 0,
                         (cudaStream_t)stream>>>(
      (const int*)j, (const float*)vals, (float*)out, N);
  return (int)cudaGetLastError();
}

// The first body: j as above; vals (3, N) bf16 bits; out (T, 3) f32,
// zero-filled. T a multiple of 16, N a multiple of 16.
extern "C" int onehot_gather_bf16_v0(const void* j, const void* vals,
                                     void* out, int T, int N, void* stream) {
  if (T <= 0 || N <= 0 || T % 16 || N % 16) return (int)cudaErrorInvalidValue;
  const int rows_per_block = kV0Warps * 16;
  dim3 grid((T + rows_per_block - 1) / rows_per_block,
            (N + kV0Cols - 1) / kV0Cols);
  onehot_gather_v0_kernel<<<grid, kV0Warps * 32, 0,
                            (cudaStream_t)stream>>>(
      (const int*)j, (const uint16_t*)vals, (float*)out, T, N);
  return (int)cudaGetLastError();
}
