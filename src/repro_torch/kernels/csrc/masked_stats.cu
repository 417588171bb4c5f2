// masked_stats: (count, sum, m2, min, max) over the valid entries of each row.
//
// Replaces the Pallas kernel `_stats_kernel` / `masked_stats` in
// src/repro/kernels/masked_stats.py (pallas_call at line 84), as batched by
// `ops.masked_stats_batch`.  m2 is the centered second moment, Chan-merged
// across tiles with the live-gated update of the reference's tiled path
// (src/repro/kernels/ops.py:172-193).
//
// Bound on an H100 SXM: device memory.  Each row element is read once as a
// 4-byte value and a 1-byte mask, so R rows of n cost R * n * 5 bytes at
// 3.35 TB/s (a 10M-row column: 50 MB, about 15 us).  The arithmetic is a few
// operations per element, far below the card's float32 rate.
//
// Design:
//  * pass 1, grid rows * tiles: one block per fixed TILE of a row.  TILE
//    equals ops._TILE and does not depend on the row length, so a row padded
//    further only gains all-masked tiles, which pass 2 skips exactly.  The
//    block sweeps its tile twice (count/sum/min/max, then m2 about the tile
//    mean; the second sweep hits L1/L2) with a fixed per-thread stride and a
//    fixed tree (common.cuh).  Counts are integers.
//  * pass 2: one thread per row merges the tile partials IN TILE ORDER with
//    the live-gated Chan update; an all-masked tile changes nothing.
//  * no atomics: the result is a pure function of the row's tiles.
#include "common.cuh"

namespace {

constexpr int TILE = 16384;  // == repro_torch.kernels.ops._TILE
constexpr int THREADS = 256;
constexpr int PER_THREAD = TILE / THREADS;

__global__ void __launch_bounds__(THREADS)
stats_tiles(const float* __restrict__ x, const uint8_t* __restrict__ m,
            long long n, int ntiles, float* __restrict__ part_f,
            int* __restrict__ part_c) {
  __shared__ float fscr[32];
  __shared__ long long iscr[32];
  const int t = (int)(blockIdx.x % ntiles);
  const long long row = blockIdx.x / ntiles;
  const float* xr = x + row * n;
  const uint8_t* mr = m + row * n;
  const long long base = (long long)t * TILE;

  long long cnt = 0;
  float s = 0.0f, mn = CUDART_INF_F, mx = -CUDART_INF_F;
#pragma unroll 4
  for (int j = 0; j < PER_THREAD; ++j) {
    const long long i = base + (long long)j * THREADS + threadIdx.x;
    if (i < n && mr[i]) {
      const float v = xr[i];
      cnt += 1;
      s += v;
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
  }
  const long long tcnt = repro::block_reduce_ll(cnt, iscr);
  const float tsum = repro::block_reduce<repro::SumF>(s, fscr);
  const float tmn = repro::block_reduce<repro::MinF>(mn, fscr);
  const float tmx = repro::block_reduce<repro::MaxF>(mx, fscr);
  const float tmean = tsum / fmaxf((float)tcnt, 1.0f);

  float m2 = 0.0f;
#pragma unroll 4
  for (int j = 0; j < PER_THREAD; ++j) {
    const long long i = base + (long long)j * THREADS + threadIdx.x;
    if (i < n && mr[i]) {
      const float d = xr[i] - tmean;
      m2 += d * d;
    }
  }
  const float tm2 = repro::block_reduce<repro::SumF>(m2, fscr);
  if (threadIdx.x == 0) {
    const long long o = row * ntiles + t;
    part_c[o] = (int)tcnt;
    part_f[o * 4 + 0] = tsum;
    part_f[o * 4 + 1] = tm2;
    part_f[o * 4 + 2] = tmn;
    part_f[o * 4 + 3] = tmx;
  }
}

__global__ void stats_merge(const float* __restrict__ part_f,
                            const int* __restrict__ part_c, int rows,
                            int ntiles, float* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  long long cnt = 0;
  float s = 0.0f, m2 = 0.0f, mn = CUDART_INF_F, mx = -CUDART_INF_F;
  for (int t = 0; t < ntiles; ++t) {
    const long long o = (long long)row * ntiles + t;
    const int tc = part_c[o];
    if (tc > 0) {  // all-masked tiles are exact no-ops
      const float tsum = part_f[o * 4 + 0];
      const float tm2 = part_f[o * 4 + 1];
      const float fc = (float)cnt, ftc = (float)tc;
      const float nn = fc + ftc;
      const float tmean = tsum / fmaxf(ftc, 1.0f);
      const float delta = tmean - s / fmaxf(fc, 1.0f);
      m2 = (m2 + tm2) + delta * delta * fc * ftc / fmaxf(nn, 1.0f);
      s = s + tsum;
      cnt += tc;
    }
    mn = fminf(mn, part_f[o * 4 + 2]);
    mx = fmaxf(mx, part_f[o * 4 + 3]);
  }
  out[row * 5 + 0] = (float)cnt;
  out[row * 5 + 1] = s;
  out[row * 5 + 2] = m2;
  out[row * 5 + 3] = mn;
  out[row * 5 + 4] = mx;
}

}  // namespace

// x: f32[rows, n], m: bool[rows, n] (one byte each), both contiguous.
// Scratch: part_f f32[rows * ntiles * 4], part_c i32[rows * ntiles] with
// ntiles = ceil(n / TILE).  out: f32[rows, 5].
REPRO_EXPORT int repro_masked_stats(const void* x, const void* m, long long rows,
                                    long long n, void* part_f, void* part_c,
                                    void* out, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + TILE - 1) / TILE;
  if (rows * ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  stats_tiles<<<(unsigned)(rows * ntiles), THREADS, 0, st>>>(
      (const float*)x, (const uint8_t*)m, n, (int)ntiles, (float*)part_f,
      (int*)part_c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int mt = 128;
  stats_merge<<<(unsigned)((rows + mt - 1) / mt), mt, 0, st>>>(
      (const float*)part_f, (const int*)part_c, (int)rows, (int)ntiles,
      (float*)out);
  return (int)cudaGetLastError();
}

REPRO_EXPORT int repro_masked_stats_tile() { return TILE; }
