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
// 3.35 TB/s (4 x 4,194,304: 84 MB, 25 us).  The arithmetic is a few
// operations per element, far below the card's float32 rate.
//
// Design, two launches, no atomics:
//  * stats_tiles, grid rows * tiles: one block of THREADS threads per fixed
//    TILE of a row.  TILE equals ops._TILE and does not depend on the row
//    length, so a row padded further only gains all-masked tiles, which the
//    merge skips exactly.  Thread tid owns the VECS groups of four elements
//    at tile indices 4 (u THREADS + tid) + c (u < VECS, c < 4).  It loads
//    them all before it uses any: VECS 16-byte value loads and VECS 4-byte
//    mask loads, 80 KB a block, two blocks an SM, so up to 160 KB an SM in
//    flight (streaming at 3.35 TB/s needs some 20 KB an SM).  No load waits
//    on a mask byte: a masked lane is dropped by a select, never by a
//    multiply, so a masked ±inf or NaN contributes nothing.  The values
//    stay in registers: count, sum, min and max come from one shuffle tree
//    and one pass through shared memory, then m2 about the tile mean from
//    the same registers, without a second read.  Counts are integers.  On
//    an H100 this streams about 2.5 TB/s; bringing whole tiles into shared
//    memory by bulk copies (cp.async.bulk) measured slower in every ring
//    tried (PERF.md).
//  * stats_merge, one block per row, launched as a programmatic dependent
//    launch so that it is resident before the tiles finish: it waits for
//    them (griddepcontrol.wait), loads the row's partials into shared memory
//    in one coalesced sweep (CHUNK at a time), and folds them IN TILE ORDER
//    with the live-gated Chan update; an all-masked tile changes nothing.
//    One thread walking the tiles alone (three divisions a tile) took most
//    of the call on an H100, so the fold is split by what carries from tile
//    to tile, into a pipeline of three warps over SPAN tiles at a time: one
//    thread of warp 0 carries the running sum before each tile (an add a
//    tile); warp 1 takes the count before each tile by an integer scan,
//    then computes each SPAN's cross terms delta^2 n_a n_b / n, a lane a
//    tile, as soon as its sums are published; one thread of warp 2 adds up
//    m2 in tile order (two adds a tile) as the cross terms arrive.  The
//    live gate is taken off both chains: an all-masked tile adds -0.0,
//    which leaves any sum as it was, bit for bit, so each step of a chain
//    is one add (two for m2) on values selected beforehand.  The arithmetic
//    is the one-thread fold's, operation for operation; min and max, exact
//    in any order, reduce on all threads.  A merge that folded each tile as
//    it became ready (ready bits zeroed by a memset), without waiting for
//    the grid, measured slower on an H100 (PERF.md).
//
// Why the bits do not depend on alignment: a row starts at row * n * 4
// bytes (values) and row * n bytes (mask), and a slice or a copy of it
// starts elsewhere again.  The owner of an element and the order of every
// sum are fixed by the element's index within its tile alone; alignment
// only chooses how the same elements are loaded (vectors where the tile's
// address allows them and the tile is whole, single loads otherwise, never
// past the end of the row).  So the partials, and the result, are a pure
// function of the row's values and mask.
#include "common.cuh"

namespace {

constexpr int TILE = 16384;  // == repro_torch.kernels.ops._TILE
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VECS = TILE / (4 * THREADS);  // groups of four elements a thread
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_WARPS = MERGE_THREADS / 32;
constexpr int CHUNK = 1024;  // partials a merge block stages at once
constexpr int SPAN = 32;     // tiles a step of the merge's pipeline: a lane each in warp 1
static_assert(CHUNK % SPAN == 0 && CHUNK % 32 == 0, "spans tile a chunk");
static_assert(VECS * 4 * THREADS == TILE, "threads cover the tile exactly");

__global__ void __launch_bounds__(THREADS, 2)
stats_tiles(const float* __restrict__ x, const uint8_t* __restrict__ m, long long n,
            int ntiles, float4* __restrict__ part_f, int* __restrict__ part_c) {
  // the merge may become resident now; it waits for this grid before it
  // reads a partial
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float4 w_a[WARPS];  // (sum, min, max, -) a warp
  __shared__ int w_c[WARPS];
  __shared__ float w_m2[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = (int)(blockIdx.x % ntiles);
  const long long row = blockIdx.x / ntiles;
  const long long base = (long long)t * TILE;
  const float* xt = x + row * n + base;
  const uint8_t* mt = m + row * n + base;
  const int len = (int)min((long long)TILE, n - base);

  float v[VECS][4];
  unsigned mk[VECS];  // the four mask bytes of a group, low byte first
  if (len == TILE && ((uintptr_t)xt & 15) == 0 && ((uintptr_t)mt & 3) == 0) {
#pragma unroll
    for (int u = 0; u < VECS; ++u) {
      const int j = (u * THREADS + tid) * 4;
      const float4 q = __ldcs(reinterpret_cast<const float4*>(xt + j));
      v[u][0] = q.x;
      v[u][1] = q.y;
      v[u][2] = q.z;
      v[u][3] = q.w;
      mk[u] = __ldcs(reinterpret_cast<const unsigned*>(mt + j));
    }
  } else {  // the same elements, one at a time; past the row's end masked
#pragma unroll
    for (int u = 0; u < VECS; ++u) {
      const int j = (u * THREADS + tid) * 4;
      mk[u] = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = j + c < len;
        v[u][c] = in ? xt[j + c] : 0.0f;
        mk[u] |= (in && mt[j + c] != 0 ? 1u : 0u) << (8 * c);
      }
    }
  }

  int cnt = 0;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float mn = CUDART_INF_F, mx = -CUDART_INF_F;
#pragma unroll
  for (int u = 0; u < VECS; ++u) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool live = ((mk[u] >> (8 * c)) & 0xffu) != 0;
      const float a = v[u][c];
      cnt += live;
      s[c] += live ? a : 0.0f;
      mn = live ? fminf(mn, a) : mn;
      mx = live ? fmaxf(mx, a) : mx;
    }
  }
  float sum = (s[0] + s[1]) + (s[2] + s[3]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    sum += __shfl_down_sync(0xffffffffu, sum, o);
    mn = fminf(mn, __shfl_down_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, o));
  }
  if (lane == 0) {
    w_a[warp] = make_float4(sum, mn, mx, 0.0f);
    w_c[warp] = cnt;
  }
  __syncthreads();
  // every thread folds the warps' partials in warp order: the same bits in
  // each, so the tile mean needs no second barrier
  int tcnt = 0;
  float tsum = 0.0f, tmn = CUDART_INF_F, tmx = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float4 a = w_a[w];
    tcnt += w_c[w];
    tsum += a.x;
    tmn = fminf(tmn, a.y);
    tmx = fmaxf(tmx, a.z);
  }
  const float tmean = tsum / fmaxf((float)tcnt, 1.0f);

#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = 0.0f;
#pragma unroll
  for (int u = 0; u < VECS; ++u) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool live = ((mk[u] >> (8 * c)) & 0xffu) != 0;
      const float d = live ? v[u][c] - tmean : 0.0f;
      s[c] += d * d;
    }
  }
  float m2 = (s[0] + s[1]) + (s[2] + s[3]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m2 += __shfl_down_sync(0xffffffffu, m2, o);
  if (lane == 0) w_m2[warp] = m2;
  __syncthreads();
  if (tid == 0) {
    float tm2 = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) tm2 += w_m2[w];
    const long long o = row * ntiles + t;
    part_f[o] = make_float4(tsum, tm2, tmn, tmx);
    part_c[o] = tcnt;
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
stats_merge(const float4* __restrict__ part_f, const int* __restrict__ part_c, int ntiles,
            float* __restrict__ out) {
  __shared__ float tsum[CHUNK], tm2[CHUNK], s_before[CHUNK], fc_before[CHUNK], cross[CHUNK];
  __shared__ int tcnt[CHUNK];
  __shared__ volatile int sums_ready, cross_ready;  // tiles of the chunk done so far
  __shared__ float w_mn[MERGE_WARPS], w_mx[MERGE_WARPS], m2_out;
  __shared__ long long cnt_out;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const float4* rf = part_f + row * ntiles;
  const int* rc = part_c + row * ntiles;
  long long carry = 0;           // warp 1: live values in the chunks before this one
  float s = 0.0f, m2 = 0.0f;     // thread 0's running sum, warp 2's lane 0's m2
  float mn = CUDART_INF_F, mx = -CUDART_INF_F;  // over the tiles this thread stages
  for (int c0 = 0; c0 < ntiles; c0 += CHUNK) {
    const int len = min(CHUNK, ntiles - c0);
    for (int i = tid; i < CHUNK; i += MERGE_THREADS) {  // past len: no-op tiles
      const bool in = i < len;
      const float4 p = in ? rf[c0 + i] : make_float4(0.0f, 0.0f, CUDART_INF_F, -CUDART_INF_F);
      tsum[i] = p.x;
      tm2[i] = p.y;
      tcnt[i] = in ? rc[c0 + i] : 0;
      mn = fminf(mn, p.z);
      mx = fmaxf(mx, p.w);
    }
    if (tid == 0) sums_ready = cross_ready = 0;
    __syncthreads();
    if (warp == 0) {
      // the running sum before each tile, in tile order, SPAN tiles loaded
      // at a time; each SPAN published to warp 1 as soon as it is done
      if (lane == 0) {
        for (int i0 = 0; i0 < len; i0 += SPAN) {
          float x[SPAN];
#pragma unroll
          for (int j = 0; j < SPAN; ++j) x[j] = tcnt[i0 + j] > 0 ? tsum[i0 + j] : -0.0f;
#pragma unroll
          for (int j = 0; j < SPAN; ++j) {
            s_before[i0 + j] = s;
            s = s + x[j];
          }
          __threadfence_block();
          sums_ready = i0 + SPAN;
        }
      }
    } else if (warp == 1) {
      // the count before each tile: an integer scan, exact in any order
      int c[CHUNK / 32];
      long long run = 0;
#pragma unroll
      for (int j = 0; j < CHUNK / 32; ++j) {
        c[j] = tcnt[lane * (CHUNK / 32) + j];
        run += c[j];
      }
      long long incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long up = __shfl_up_sync(0xffffffffu, incl, o);
        incl += lane >= o ? up : 0;
      }
      long long before = carry + incl - run;
#pragma unroll
      for (int j = 0; j < CHUNK / 32; ++j) {
        fc_before[lane * (CHUNK / 32) + j] = (float)before;
        before += c[j];
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
      __syncwarp();
      // each tile's cross term of the Chan update, a lane a tile, SPAN tiles
      // at a time as their running sums arrive
      for (int i0 = 0; i0 < len; i0 += SPAN) {
        while (sums_ready < i0 + SPAN) {
        }
        __threadfence_block();
        const int i = i0 + lane;
        const float fc = fc_before[i], ftc = (float)tcnt[i];
        const float delta = tsum[i] / fmaxf(ftc, 1.0f) - s_before[i] / fmaxf(fc, 1.0f);
        cross[i] = delta * delta * fc * ftc / fmaxf(fc + ftc, 1.0f);
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          cross_ready = i0 + SPAN;
        }
      }
    } else if (warp == 2 && lane == 0) {
      // m2 in tile order; all-masked tiles are exact no-ops
      for (int i0 = 0; i0 < len; i0 += SPAN) {
        while (cross_ready < i0 + SPAN) {
        }
        __threadfence_block();
        float y[SPAN], z[SPAN];
#pragma unroll
        for (int j = 0; j < SPAN; ++j) {
          const bool live = tcnt[i0 + j] > 0;
          y[j] = live ? tm2[i0 + j] : -0.0f;
          z[j] = live ? cross[i0 + j] : -0.0f;
        }
#pragma unroll
        for (int j = 0; j < SPAN; ++j) m2 = (m2 + y[j]) + z[j];
      }
    }
    __syncthreads();
  }
  mn = repro::warp_reduce<repro::MinF>(mn);
  mx = repro::warp_reduce<repro::MaxF>(mx);
  if (lane == 0) {
    w_mn[warp] = mn;
    w_mx[warp] = mx;
  }
  if (tid == 32) cnt_out = carry;
  if (tid == 64) m2_out = m2;
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < MERGE_WARPS; ++w) {
      mn = fminf(mn, w_mn[w]);
      mx = fmaxf(mx, w_mx[w]);
    }
    float* o = out + row * 5;
    o[0] = (float)cnt_out;
    o[1] = s;
    o[2] = m2_out;
    o[3] = mn;
    o[4] = mx;
  }
}

}  // namespace

// x: f32[rows, n], m: bool[rows, n] (one byte each), both contiguous.
// scratch, 16-byte aligned: the partials f32x4[rows * ntiles] (sum, m2, min,
// max), then the counts i32[rows * ntiles], with ntiles = ceil(n / TILE):
// 20 bytes a tile.  out: f32[rows, 5].
REPRO_EXPORT int repro_masked_stats(const void* x, const void* m, long long rows, long long n,
                                    void* scratch, void* out, void* stream) {
  if (rows <= 0 || n <= 0 || ((uintptr_t)scratch & 15) != 0) return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + TILE - 1) / TILE;
  if (rows * ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float4* part_f = (float4*)scratch;
  int* part_c = (int*)(part_f + rows * ntiles);
  stats_tiles<<<(unsigned)(rows * ntiles), THREADS, 0, st>>>(
      (const float*)x, (const uint8_t*)m, n, (int)ntiles, part_f, part_c);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // a programmatic dependent launch: it may begin before stats_tiles ends
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows);
  cfg.blockDim = dim3(MERGE_THREADS);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, stats_merge, (const float4*)part_f, (const int*)part_c,
                                 (int)ntiles, (float*)out);
}

REPRO_EXPORT int repro_masked_stats_tile() { return TILE; }
