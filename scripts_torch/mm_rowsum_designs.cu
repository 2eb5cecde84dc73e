// The design of P5's wgmma product + row sum that the kernel in
// imageanalysis_tpu_torch/csrc/mma_probe.cu (mm_rowsum_wg_kernel) was timed
// against and kept over, here to time against it
// (scripts_torch/mm_rowsum_designs.py builds this file with nvcc and loads
// it by ctypes). It computes, as that kernel does,
//   out[m] = sum_n sum_k a[m, k] b[n, k]       a (M, K), b (N, K) bf16
// with the same producer warp, TMA ring of B stages and row-sum epilogue,
// at the same tiles (design 0-3: (128, 128), (256, 64), (256, 128), (256,
// 256)); it differs in where wgmma reads A: from registers (wgmma's RS
// form). K runs in passes of 128 dims: TMA brings a pass's two 64-dim
// chunks of A, each consumer warpgroup loads its rows' A fragments with
// ldmatrix from the swizzled chunks (64 registers a thread at BM = 256)
// and releases the chunks at once, so the next pass's A loads under this
// pass's products. Shared memory then feeds the tensor cores B alone: 64
// bytes a clock at their rate, against the shipped kernel's 96 (of the
// SM's 128) with A read there too.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../imageanalysis_tpu_torch/csrc/hopper.cuh"
#include "../imageanalysis_tpu_torch/csrc/mma_sync.cuh"

namespace {

using namespace hopper;

// wgmma.m64nNk16 with A (m64 x k16) from registers: warp w's rows 16w..
// 16w+15 in mma.sync's m16n8k16 A fragment (a0 rows 0-7, k 0-7; a1 rows
// 8-15; a2, a3 k 8-15), as ldmatrix.x4 loads them
// d (64 x 64 f32, 32 a thread) += A (registers) . B^T
__device__ __forceinline__ void wgmma_rs_64(float (&d)[32],
                                             const unsigned (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32, 64 a thread) += A (registers) . B^T
__device__ __forceinline__ void wgmma_rs_128(float (&d)[64],
                                             const unsigned (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


constexpr int kWgThreads = 384;    // consumer warpgroups 0, 1; producer 2
constexpr int kWgMaxStages = 16;
constexpr int kWgSmem = 232448;     // the most a block may hold (227 KB)
constexpr int kWgChunk = 128;       // bytes of a row's 64-dim chunk
constexpr int kWgPass = 2;          // 64-dim chunks of A a pass: 128 dims

// Shared memory of a (bm, bn) block at K: K passes of at most kWgPass
// chunks of A, the ring's stages (filling what A leaves, at most
// kWgMaxStages) and the dynamic bytes (with 1024 of alignment slack).
// Always more than half of the SM, so one block holds it (setmaxnreg
// counts on that).
struct WgPlan {
  int stages, passes, chunks, smem;
};

WgPlan wg_plan(int bm, int bn, int K) {
  const int kc = K / 64, a_chunk = bm * kWgChunk, stage = bn * kWgChunk;
  if (kc <= 0) return {0, 0, 0, 0};
  const int chunks = kc < kWgPass ? kc : kWgPass;
  const int budget = kWgSmem - 1024 - 1024;   // slack; static barriers
  int stages = (budget - chunks * a_chunk) / stage;
  if (stages > kWgMaxStages) stages = kWgMaxStages;
  return {stages, (kc + kWgPass - 1) / kWgPass, chunks,
          1024 + chunks * a_chunk + stages * stage};
}

template <int BM, int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
rs_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    float* __restrict__ out, int M, int N, int kc,
                    int stages, int n_split) {
  using namespace hopper;
  constexpr int MH = BM / 128;      // m64 halves a consumer warpgroup
  constexpr int WN = BN > 128 ? 128 : BN;   // wgmma's N
  constexpr int NJ = BN / WN;       // wgmma column blocks a B stage
  constexpr int A_CHUNK = BM * kWgChunk, STAGE = BN * kWgChunk;
  extern __shared__ uint8_t raw[];
  __shared__ __align__(8) uint64_t full[kWgMaxStages];
  __shared__ __align__(8) uint64_t empty[kWgMaxStages];
  __shared__ __align__(8) uint64_t a_full, a_empty;
  const uint32_t base = smem_u32(raw);
  uint8_t* sa = raw + (((base + 1023u) & ~1023u) - base);
  uint8_t* sb = sa + (kc < kWgPass ? kc : kWgPass) * A_CHUNK;

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
  const int passes = (kc + kWgPass - 1) / kWgPass;

  if (tid >= 256) {                 // the producer warpgroup
    regs_dec<40>();
    if (tid != 256) return;
    tma_prefetch(&ta);
    tma_prefetch(&tb);
    int s = 0;
    uint32_t ph = 0;
    for (int p = 0; p < passes; ++p) {
      const int c0 = p * kWgPass, nc = min(kWgPass, kc - c0);
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
  // the pass's A fragments: [half][k-step of 16][wgmma's a0..a3]
  unsigned af[MH][kWgPass * 4][4];
  // ldmatrix.x4's row of this lane within the warp's 16: matrices 0 and 2
  // rows 0-7, 1 and 3 rows 8-15; 2 and 3 the k-step's second 8 dims
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;
  int s = 0, held = -1;
  uint32_t ph = 0;
  for (int p = 0; p < passes; ++p) {
    const int nc = min(kWgPass, kc - p * kWgPass);
    mbar_wait(&a_full, p & 1);
#pragma unroll
    for (int h = 0; h < MH; ++h)
#pragma unroll
      for (int ks = 0; ks < kWgPass * 4; ++ks)
        if (ks < nc * 4) {
          const int u = 2 * (ks % 4) + (lane >> 4);   // 16-byte unit
          const uint8_t* row = sa + (ks / 4) * A_CHUNK +
              (wg * (BM / 2) + h * 64 + warp * 16 + lr) * kWgChunk;
          mma_sync::ldmatrix_x4(af[h][ks][0], af[h][ks][1], af[h][ks][2],
                                af[h][ks][3], row + ((u ^ (lr & 7)) << 4));
        }
    // every lane of the warpgroup has read its A: release the chunks, so
    // that the next pass's load runs under this pass's products
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    if (leader) mbar_arrive(&a_empty);
    for (int t = t_begin; t < t_end; ++t)
#pragma unroll
      for (int c = 0; c < kWgPass; ++c)
        if (c < nc) {
          mbar_wait(&full[s], ph);
#pragma unroll
          for (int h = 0; h < MH; ++h)
#pragma unroll
            for (int i = 0; i < WN / 2; ++i) reg_fence(acc[h][i]);
          wgmma_fence();
          const uint8_t* bt = sb + s * STAGE;
#pragma unroll
          for (int h = 0; h < MH; ++h)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const uint64_t db =
                    desc_sw128(bt + j * WN * kWgChunk + kk * 32);
                if constexpr (WN == 128)
                  wgmma_rs_128(acc[h], af[h][c * 4 + kk], db);
                else
                  wgmma_rs_64(acc[h], af[h][c * 4 + kk], db);
              }
          wgmma_commit();
          wgmma_wait<1>();          // the stage before is read: release it
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
    // the pass's products are done before its A registers are reloaded
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < MH; ++h)
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) reg_fence(acc[h][i]);
    if (leader) mbar_arrive(&empty[held]);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched once at run time (null if absent)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// a 2-D map over rows x K bf16 (row-major), boxes of 64 dims x box_rows,
// 128-byte swizzle
int encode_rows(CUtensorMap* map, const void* p, long long rows, int K,
                int box_rows) {
  EncodeTiled fn = encode_tiled();
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
  auto kernel = rs_kernel<BM, BN>;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err) return err;
  dim3 grid(M / BM, n_split, batch);
  kernel<<<grid, kWgThreads, pl.smem, s>>>(ta, tb, (float*)out, M, N, K / 64,
                                           pl.stages, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// design 0-3 (see the head); a, b, out, batch, M, N, K and n_split as
// mm_rowsum_bf16_wg's. Returns the cudaError_t of the launch.
extern "C" int mm_rowsum_design(int design, const void* a, const void* b,
                                void* out, int batch, int M, int N, int K,
                                int n_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 0 || K % 64) return (int)cudaErrorInvalidValue;
  if (design == 0)
    return launch_wg<128, 128>(a, b, out, batch, M, N, K, n_split, s);
  if (design == 1)
    return launch_wg<256, 64>(a, b, out, batch, M, N, K, n_split, s);
  if (design == 2)
    return launch_wg<256, 128>(a, b, out, batch, M, N, K, n_split, s);
  if (design == 3)
    return launch_wg<256, 256>(a, b, out, batch, M, N, K, n_split, s);
  return (int)cudaErrorInvalidValue;
}
