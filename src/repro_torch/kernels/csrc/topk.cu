// topk: the k largest values of each row, sorted descending (values only).
//
// Replaces the Pallas kernel `_topk_kernel` / `topk` in
// src/repro/kernels/topk.py (pallas_call at line 56), as called by
// `ops.topk_padded`, `ops.topk_padded_parts` and `ops.topk_masked_padded`.
// `largest=False` is served by negation, as the reference does: the first
// round loads sign * x and the last round stores sign * winner.
//
// Bound on an H100 SXM: device memory, n * 4 bytes per row read once at
// 3.35 TB/s.  The sorting network does O(TILE log^2 TILE) compares per tile
// in shared memory, so at the main path's sizes the kernel is bound by
// shared-memory traffic and barriers, not by device memory.
//
// Design: each block bitonic-sorts one TILE of its row in shared memory and
// writes that tile's top k.  The wrapper repeats the same kernel on the
// (rows, tiles * k) winners until one tile is left; each round shrinks a row
// by TILE / k (>= 16 for k <= 128).  Pads and short tiles are -inf, which
// never beats a real value.  The result is exact (values only; +0.0 and
// -0.0 compare equal and may trade places).
#include "common.cuh"

namespace {

constexpr int TILE = 2048;
constexpr int THREADS = TILE / 2;

__global__ void __launch_bounds__(THREADS)
topk_tiles(const float* __restrict__ x, long long n, int ntiles, int k,
           float sign_in, float sign_out, float* __restrict__ out) {
  __shared__ float buf[TILE];
  const int t = (int)(blockIdx.x % ntiles);
  const long long row = blockIdx.x / ntiles;
  const float* xr = x + row * n;
  const long long base = (long long)t * TILE;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const long long g = base + i;
    buf[i] = g < n ? sign_in * xr[g] : -CUDART_INF_F;
  }
  // bitonic sort, descending overall
  for (int size = 2; size <= TILE; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      const int i = threadIdx.x;  // one compare-exchange per thread
      const int lo = 2 * i - (i & (stride - 1));
      const int hi = lo + stride;
      const bool desc = (lo & size) == 0;
      const float a = buf[lo], b = buf[hi];
      if (desc ? (a < b) : (a > b)) {
        buf[lo] = b;
        buf[hi] = a;
      }
    }
  }
  __syncthreads();
  float* o = out + (row * ntiles + t) * (long long)k;
  for (int i = threadIdx.x; i < k; i += THREADS) o[i] = sign_out * buf[i];
}

}  // namespace

// One round: x f32[rows, n] -> out f32[rows, ceil(n / TILE) * k].
REPRO_EXPORT int repro_topk_round(const void* x, long long rows, long long n,
                                  int k, float sign_in, float sign_out,
                                  void* out, void* stream) {
  if (rows <= 0 || n <= 0 || k < 1 || k > TILE) return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + TILE - 1) / TILE;
  if (rows * ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  topk_tiles<<<(unsigned)(rows * ntiles), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, (int)ntiles, k, sign_in, sign_out, (float*)out);
  return (int)cudaGetLastError();
}

REPRO_EXPORT int repro_topk_tile() { return TILE; }
