// K4: the fused match epilogue, for Hopper (sm_90a).
//
// Replaces imageanalysis_tpu/ops/knn.py:253 _match_epilogue_kernel, the
// second launch of knn_match_fused: K1's raw packed keys in, per A row
//   j    = row_p[i].x & 0x1FFF                    (the best B index)
//   d1   = f32 bits of row_p[i].x with the low 13 bits cleared, d2 of .y
//   ok   = max(d1, 0) < ratio2 * max(d2, 0)       (Lowe ratio, squared)
//          && (col_p[j] & 0x1FFF) == i            (mutual check)
//   pb   = uv_b[j]                                (matched B coordinate)
// for a batch of pairs: row_p (B, n_a, 2) int32, col_p (B, n_b) int32,
// uv_b (B, n_b, 2) f32 → best_j (B, n_a) int32, ok (B, n_a) as bool storage
// (one byte, 0 or 1, written here as unsigned char; the wrapper allocates a
// torch.bool tensor), pb (B, n_a, 2) f32. A j >= n_b (no K1 key names one)
// gives ok = 0 and pb = (0, 0), as the plain version.
//
// The ratio product is __fmul_rn (one f32 rounding, never contracted), so
// ok equals the plain version's (ratio * ratio) * d2 test bit for bit; the
// gathers are exact loads, so best_j and pb are bit-exact too.
//
// What bounds it on the H100: bytes and launch latency. Per A row it reads
// 8 B of row_p and writes 13 B; per B row it reads col_p (4 B) and uv_b
// (8 B) once: ~13 MB at 64 pairs x 6144 rows, ~4 us at 3.35 TB/s, under the
// few microseconds a launch costs. Design: one thread per A row, an int2
// load of its row_p keys (neighbouring threads, neighbouring 8-byte words),
// and two gathers into its pair's col_p and uv_b, which stay in L2 (a
// pair's B side is at most 96 KB). The TPU kernel split every gathered
// value into bf16-exact limbs (the column index into two 8-bit limbs, each
// coordinate into a Dekker hi/mid/lo triple, knn.py:377-404) because its
// gather was a one-hot MXU dot in single-pass bf16; a direct load needs no
// split. It stays a second launch after K1: col_p is final only after K1
// has swept every A tile.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kIdxMask = (1 << 13) - 1;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
match_epilogue_kernel(const int2* __restrict__ row_p,
                      const int* __restrict__ col_p,
                      const float2* __restrict__ uv_b, float ratio2,
                      int* __restrict__ best_j, unsigned char* __restrict__ ok,
                      float2* __restrict__ pb, long long total, int n_a,
                      int n_b) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long pair = t / n_a;
  const int i = (int)(t - pair * n_a);
  const int2 k = row_p[t];
  const int j = k.x & kIdxMask;
  // max(d, 0) that keeps a NaN, as torch.clamp_min and jnp.maximum: a
  // gated-out key (0x7FFFE000 | idx) decodes to a NaN, and fmaxf would turn
  // it into 0
  float d1 = __int_as_float(k.x & ~kIdxMask);
  float d2 = __int_as_float(k.y & ~kIdxMask);
  d1 = d1 < 0.0f ? 0.0f : d1;
  d2 = d2 < 0.0f ? 0.0f : d2;
  bool good = d1 < __fmul_rn(ratio2, d2);
  float2 uv = make_float2(0.0f, 0.0f);
  if (j < n_b) {
    const long long bj = pair * n_b + j;
    good = good && (col_p[bj] & kIdxMask) == i;
    uv = uv_b[bj];
  } else {
    good = false;
  }
  best_j[t] = j;
  ok[t] = good ? 1 : 0;
  pb[t] = uv;
}

}  // namespace

// row_p (n_pairs, n_a, 2) int32, col_p (n_pairs, n_b) int32, uv_b
// (n_pairs, n_b, 2) f32: contiguous device buffers, 8-byte aligned. Outputs
// best_j (n_pairs, n_a) int32, ok (n_pairs, n_a) bytes, pb (n_pairs, n_a, 2)
// f32. 0 < n_a, n_b <= 8192. Returns the cudaError_t of the launch (0 and
// no launch for an empty batch).
extern "C" int match_epilogue(const void* row_p, const void* col_p,
                              const void* uv_b, float ratio2, void* best_j,
                              void* ok, void* pb, int n_pairs, int n_a,
                              int n_b, void* stream) {
  if (n_pairs < 0 || n_a < 0 || n_b <= 0 || n_a > 8192 || n_b > 8192)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)n_pairs * n_a;
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  match_epilogue_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int2*)row_p, (const int*)col_p, (const float2*)uv_b, ratio2,
      (int*)best_j, (unsigned char*)ok, (float2*)pb, total, n_a, n_b);
  return (int)cudaGetLastError();
}
