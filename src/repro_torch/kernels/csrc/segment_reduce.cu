// segment_reduce: per-bucket sum / min / max of S value rows keyed by int32
// codes under V validity rows, plus V rows of per-bucket valid counts, for
// any bucket count B < 2^24.  A deterministic sort-and-fold.
//
// Replaces the Pallas kernel `_segment_kernel` / `segment_reduce` in
// src/repro/kernels/segment_reduce.py (pallas_call at line 103), as batched
// by `ops.segment_reduce_batch`.  The reference's one-hot matmul was a way
// round the TPU's lack of scatter and atomics; it is not carried over.
//
// Bound on an H100 SXM: bytes.  Each input read once and each output
// written once: n * (4 + 4S + V) + (S + V) * B * 4 bytes at 3.35 TB/s.
//
// Design (no float atomics anywhere; integer atomics only for counts):
//  * counts, all V rows: a block-local shared-memory histogram (V * B ints
//    up to 48 KB) merged into `cnts`, else integer atomics straight into
//    `cnts`, one per distinct key of a warp.  Integer sums do not depend on
//    order.  With S == 0 (value_counts) this is the whole call.
//  * sums, min, max: for each validity row u that a value row reads,
//    (a) the live rows (key in [0, B) and valid in u) go into
//    (b) a stable LSD radix sort of (key, row id) by key: `passes` passes of
//        `digit_bits` bits (both from B alone, at most 3 passes of at most
//        11 bits; one 0-bit pass, a stable compaction, for B = 1).  A pass is
//        a per-tile digit histogram, an exclusive scan over (digit, tile) in
//        that fixed order, and a scatter that ranks each row stably inside
//        its tile (each warp owns a contiguous slice of the tile and walks it
//        32 rows at a time; __match_any_sync ranks equal digits by lane),
//        lays the tile out by digit in shared memory and writes each digit's
//        rows to consecutive positions.  The first pass reads the input and
//        drops every row that is not live, so padding and compacted-away
//        slots vanish here.
//    (c) the fold, per value row: each bucket's rows now form one run in row
//        order.  Level 1 cuts a run into chunks of CHUNK rows counted from
//        its first row; one thread loads a chunk and folds it left to right.
//        Level k folds CHUNK level-(k-1) partials the same way, until one is
//        left (ceil(log_CHUNK n) levels; a level above the longest run
//        returns at once).  A lone partial is passed up as it is; no neutral
//        is ever folded in (min / max keep fminf / fmaxf).
//
// Why this association: it is a fixed function of the run's length alone
// (the order of a bucket's valid rows is fixed by the stable sort), so a
// bucket's bits do not depend on how far the input was padded, on which
// other value or validity rows share the call, on rows of other keys, or on
// the run: batched == per-row, pad invariance, fused == unfused, `*_parts` ==
// unbatched, repeat-equality and bucket independence hold by construction.
//
// What the sort and fold move (n rows, l live, one validity row, S = 1):
// counts 5n; pass 1 reads keys and validity twice (histogram, scatter: 10n)
// and writes 8l; each further pass reads 4l + 8l and writes 8l; the fold
// reads 8l (keys, ids), gathers 4l of values (32-byte sectors, mostly from
// L2), writes 4l of run positions, and each level that has work reads those
// 4l again.  At B = 100,000, n = 2.2M, l = 0.9n (2 passes; uniform keys
// leave one level above the first with work) that is about 130 MB, against
// a bound of 20.6 MB: the sort and the run positions are the price of a
// fixed association without float atomics.
//
// Scratch (the wrapper allocates it from `segment_reduce.sort_plan`): two
// (key, id) buffers of n ints each (16 bytes a row), the tile histograms
// (bins * tiles ints, at most 2 bytes a row) and 2 * bins + 2 ints.  After
// the sort the buffer pair that does not hold the result holds the run
// positions and the fold's partials.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;  // == segment_reduce.TILE_ROWS
constexpr int WARP_ROWS = TILE / WARPS;
constexpr int MAX_DIGIT_BITS = 11;  // == segment_reduce.MAX_DIGIT_BITS
constexpr int MAX_BINS = 1 << MAX_DIGIT_BITS;
constexpr int CHUNK = 32;  // == segment_reduce.FOLD_CHUNK
constexpr int SHARED_COUNTS = 48 * 1024 / 4;  // V * B up to this: shared histogram
constexpr int COUNT_BLOCKS = 4 * 132;  // four blocks on each SM
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned DEAD = 0xffffffffu;  // the digit of a row that takes no part
static_assert(WARP_ROWS == 32 * ITEMS, "a warp walks its slice 32 rows at a time");

enum Mode { kSum = 0, kMin = 1, kMax = 2 };

__device__ __forceinline__ float combine(int mode, float a, float x) {
  return mode == kSum ? a + x : (mode == kMin ? fminf(a, x) : fmaxf(a, x));
}

// Exclusive prefix sum of one int a thread, in thread order, and the total.
__device__ int block_exclusive_sum(int x, int& total, int* sw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  __syncthreads();  // sw may still be read by a previous call
  if (lane == 31) sw[warp] = incl;
  __syncthreads();
  int pre = 0;
  total = 0;
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) pre += sw[w];
    total += sw[w];
  }
  return pre + incl - x;
}

// Exclusive running max of one int a thread, in thread order (-1 for thread 0).
__device__ int block_exclusive_max(int x, int* sw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = max(incl, y);
  }
  __syncthreads();
  if (lane == 31) sw[warp] = incl;
  __syncthreads();
  int pre = -1;
  for (int w = 0; w < warp; ++w) pre = max(pre, sw[w]);
  int ex = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) ex = -1;
  return max(pre, ex);
}

// ---------------------------------------------------------------- counts --

// Counts of one tile-strided block: each thread loads its ITEMS keys first
// (independent loads in flight together), then counts them.
__global__ void __launch_bounds__(THREADS)
count_shared(const int* __restrict__ keys, const uint8_t* __restrict__ valids, int V, int B,
             long long n, int* __restrict__ cnts) {
  extern __shared__ int hist[];  // V * B
  for (int i = threadIdx.x; i < V * B; i += THREADS) hist[i] = 0;
  __syncthreads();
  for (long long t0 = (long long)blockIdx.x * TILE; t0 < n; t0 += (long long)gridDim.x * TILE) {
    int k[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long r = t0 + j * THREADS + threadIdx.x;
      k[j] = r < n ? keys[r] : -1;
    }
    for (int v = 0; v < V; ++v) {
      const uint8_t* valid = valids + (long long)v * n;
      bool ok[ITEMS];
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const long long r = t0 + j * THREADS + threadIdx.x;
        ok[j] = k[j] >= 0 && k[j] < B && valid[r];
      }
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        if (ok[j]) atomicAdd(&hist[v * B + k[j]], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < V * B; i += THREADS)
    if (hist[i]) atomicAdd(&cnts[i], hist[i]);
}

// Counts straight into `cnts`: lanes of a warp with one key add once
// (skewed keys would otherwise queue on one address).
__global__ void __launch_bounds__(THREADS)
count_global(const int* __restrict__ keys, const uint8_t* __restrict__ valids, int V, int B,
             long long n, int* __restrict__ cnts) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int k = r < n ? keys[r] : -1;
  const bool in = k >= 0 && k < B;
  for (int v = 0; v < V; ++v) {
    const bool ok = in && valids[(long long)v * n + r];
    const unsigned peers = __match_any_sync(FULL, ok ? (unsigned)k : DEAD);
    if (ok && __ffs(peers) - 1 == lane) atomicAdd(&cnts[(long long)v * B + k], __popc(peers));
  }
}

// A value row's result before the fold: the neutral of its mode, which
// stays in every bucket without a valid row.
__global__ void fill_neutral(float* __restrict__ out, int B, int mode) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) out[i] = mode == kSum ? 0.0f : (mode == kMin ? CUDART_INF_F : -CUDART_INF_F);
}

// ------------------------------------------------------------------ sort --
// Pass input: the first pass reads the raw keys (row ids are positions) and
// keeps live rows only; later passes read the previous pass's (key, id)
// pairs, all live.  Rows past the input's end are DEAD too.

struct PassIn {
  const int* keys;  // previous pass's keys, or nullptr on the first pass
  const int* ids;
  const int* raw;  // the call's keys
  const uint8_t* valid;  // the validity row u
  const int* nlive;  // live rows (written by the first pass's digit scan)
  long long n;
  int B, shift;
  unsigned mask;
};

__device__ __forceinline__ unsigned fetch(const PassIn& in, long long nin, long long p, int& key,
                                          int& id) {
  key = 0;
  id = 0;
  if (p >= nin) return DEAD;
  if (in.keys) {
    key = in.keys[p];
    id = in.ids[p];
  } else {
    key = in.raw[p];
    id = (int)p;
    if (key < 0 || key >= in.B || !in.valid[p]) return DEAD;
  }
  return ((unsigned)key >> in.shift) & in.mask;
}

__device__ __forceinline__ long long input_rows(const PassIn& in) {
  return in.keys ? (long long)*in.nlive : in.n;
}

// hist[d * ntiles + t] = live rows of tile t with digit d.
__global__ void __launch_bounds__(THREADS)
sort_hist(PassIn in, int bins, long long ntiles, int* __restrict__ hist) {
  __shared__ int h[MAX_BINS];
  for (int d = threadIdx.x; d < bins; d += THREADS) h[d] = 0;
  __syncthreads();
  const long long nin = input_rows(in);
  const long long base = (long long)blockIdx.x * TILE;
  if (base < nin) {
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
      int key, id;
      const unsigned d = fetch(in, nin, base + i, key, id);
      if (d != DEAD) atomicAdd(&h[d], 1);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < bins; d += THREADS) hist[(long long)d * ntiles + blockIdx.x] = h[d];
}

// One block per digit: exclusive scan of its tiles' counts in tile order
// (in place), and the digit's total.
__global__ void __launch_bounds__(THREADS)
sort_scan_tiles(int* __restrict__ hist, long long ntiles, int* __restrict__ totals) {
  __shared__ int sw[WARPS];
  int* row = hist + (long long)blockIdx.x * ntiles;
  int carry = 0;
  for (long long b = 0; b < ntiles; b += THREADS) {
    const long long i = b + threadIdx.x;
    const int x = i < ntiles ? row[i] : 0;
    int total;
    const int ex = block_exclusive_sum(x, total, sw);
    if (i < ntiles) row[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// One block: each digit's first output position, and the live row count
// (the same on every pass).
__global__ void __launch_bounds__(THREADS)
sort_scan_digits(const int* __restrict__ totals, int bins, int* __restrict__ base,
                 int* __restrict__ nlive) {
  __shared__ int sw[WARPS];
  int carry = 0;
  for (int b = 0; b < bins; b += THREADS) {
    const int i = b + threadIdx.x;
    const int x = i < bins ? totals[i] : 0;
    int total;
    const int ex = block_exclusive_sum(x, total, sw);
    if (i < bins) base[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) *nlive = carry;
}

// Stable scatter of one tile.  Each warp ranks the rows of its contiguous
// slice by digit (per-warp digit counters in shared memory; in one step of
// 32 rows __match_any_sync orders equal digits by lane).  The tile is then
// laid out in shared memory in (digit, warp, rank) order, which is row order
// within a digit, and written out by consecutive threads to consecutive
// positions of each digit's output run: the digit's base + the tile's
// exclusive count (hist, scanned) + the row's place among the tile's rows of
// that digit.
__global__ void __launch_bounds__(THREADS)
sort_scatter(PassIn in, int bins, long long ntiles, const int* __restrict__ hist,
             const int* __restrict__ base, int* __restrict__ keys_out,
             int* __restrict__ ids_out) {
  extern __shared__ int smem[];
  int* wcnt = smem;                  // WARPS * bins: counts, then each (warp, digit)'s start
  int* delta = wcnt + WARPS * bins;  // bins: output position - tile position, by digit
  int* skey = delta + bins;          // TILE
  int* sid = skey + TILE;            // TILE
  __shared__ int sw[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long nin = input_rows(in);
  const long long tile0 = (long long)blockIdx.x * TILE;
  if (tile0 >= nin) return;  // the whole block: nothing of this tile is live
  for (int i = threadIdx.x; i < WARPS * bins; i += THREADS) wcnt[i] = 0;

  const long long row0 = tile0 + (long long)warp * WARP_ROWS;
  unsigned dig[ITEMS];
  int key[ITEMS], id[ITEMS], rank[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) dig[j] = fetch(in, nin, row0 + j * 32 + lane, key[j], id[j]);
  __syncthreads();

  int* mine = wcnt + warp * bins;
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const unsigned peers = __match_any_sync(FULL, dig[j]);
    const int ahead = __popc(peers & below);
    const int old = dig[j] != DEAD ? mine[dig[j]] : 0;
    __syncwarp();
    if (dig[j] != DEAD && ahead == 0) mine[dig[j]] = old + __popc(peers);
    __syncwarp();
    rank[j] = old + ahead;
  }
  __syncthreads();

  int live = 0;  // the tile's live rows, after the loop
  for (int b = 0; b < bins; b += THREADS) {
    const int d = b + threadIdx.x;
    int count = 0;
    if (d < bins)
      for (int w = 0; w < WARPS; ++w) count += wcnt[w * bins + d];
    int total;
    const int ex = block_exclusive_sum(count, total, sw);
    if (d < bins) {
      int run = live + ex;
      delta[d] = base[d] + hist[(long long)d * ntiles + blockIdx.x] - run;
      for (int w = 0; w < WARPS; ++w) {
        const int c = wcnt[w * bins + d];
        wcnt[w * bins + d] = run;
        run += c;
      }
    }
    live += total;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (dig[j] == DEAD) continue;
    const int at = mine[dig[j]] + rank[j];
    skey[at] = key[j];
    sid[at] = id[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < live; i += THREADS) {
    const int k = skey[i];
    const int pos = delta[((unsigned)k >> in.shift) & in.mask] + i;
    keys_out[pos] = k;
    ids_out[pos] = sid[i];
  }
}

// ------------------------------------------------------------------ fold --

// Folds the run of key k from position p: at most CHUNK values, at
// p, p + stride, ..., that still hold key k.  All loads are issued before the
// first add; the adds run left to right.  Returns the fold and sets `len`.
template <typename Load>
__device__ __forceinline__ float fold_chunk(const int* __restrict__ sk, long long nl, long long p,
                                            long long stride, int k, int mode, Load load,
                                            int& len) {
  float v[CHUNK];
  len = 0;
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    const long long q = p + i * stride;
    const bool in = q < nl && sk[q] == k;  // a run is contiguous: `in` is a prefix
    v[i] = in ? load(q) : 0.0f;
    len += in;
  }
  float a = v[0];
#pragma unroll
  for (int i = 1; i < CHUNK; ++i)
    if (i < len) a = combine(mode, a, v[i]);
  return a;
}

// Level 1 over the sorted (key, id) pairs: each position's index in its run
// (from a block-wide running max of run heads, seeded by a binary search for
// the run that holds the tile's first position) goes to `rpos`, and the
// longest run to `maxrun`; a thread whose position starts a chunk folds the
// chunk's values in order.  A chunk that is its run's whole is the bucket's
// result.
__global__ void __launch_bounds__(THREADS)
fold_first(const int* __restrict__ sk, const int* __restrict__ si, const int* __restrict__ nlive,
           const float* __restrict__ x, int mode, float* __restrict__ red,
           float* __restrict__ part, int* __restrict__ rpos, int* __restrict__ maxrun) {
  __shared__ int sw[WARPS];
  __shared__ int carry;
  const long long nl = *nlive;
  const long long p0 = (long long)blockIdx.x * TILE;
  if (p0 >= nl) return;
  if (threadIdx.x == 0) {
    const int k = sk[p0];
    long long lo = 0, hi = p0;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (sk[mid] < k) lo = mid + 1; else hi = mid;
    }
    carry = (int)lo;
  }
  const long long q0 = p0 + (long long)threadIdx.x * ITEMS;
  int start[ITEMS];
  int m = -1;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long p = q0 + j;
    start[j] = (p < nl && (p == 0 || sk[p] != sk[p - 1])) ? (int)p : -1;
    m = max(m, start[j]);
  }
  int run = block_exclusive_max(m, sw);  // its __syncthreads publish `carry`
  run = max(run, carry);
  unsigned heads = 0, whole = 0;  // bit j: position q0 + j starts a chunk / a run
  int longest = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    run = max(run, start[j]);
    const long long p = q0 + j;
    if (p < nl) {
      const int r = (int)(p - run);
      rpos[p] = r;
      longest = max(longest, r + 1);
      if (r % CHUNK == 0) heads |= 1u << j;
      if (r == 0) whole |= 1u << j;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) longest = max(longest, __shfl_down_sync(FULL, longest, o));
  if ((threadIdx.x & 31) == 0) atomicMax(maxrun, longest);
  while (heads) {
    const int j = __ffs(heads) - 1;
    heads &= heads - 1;
    const long long p = q0 + j;
    const int k = sk[p];
    int len;
    const float a = fold_chunk(sk, nl, p, 1, k, mode, [&](long long q) { return x[si[q]]; }, len);
    const long long q = p + len;
    if (((whole >> j) & 1) && (q == nl || sk[q] != k)) red[k] = a;
    else part[p] = a;
  }
}

// Level k >= 2: a position whose run index is a multiple of CHUNK * stride
// folds the partials at p, p + stride, ... (at most CHUNK, within its run)
// in order.  One partial alone is left where it is; with no run longer than
// `stride` the level has nothing to do.  A thread looks at ITEMS positions.
__global__ void __launch_bounds__(THREADS)
fold_level(const int* __restrict__ sk, const int* __restrict__ nlive,
           const int* __restrict__ rpos, const int* __restrict__ maxrun, long long stride,
           int mode, float* __restrict__ red, float* __restrict__ part) {
  if (*maxrun <= stride) return;
  const long long nl = *nlive;
  const long long q0 = (long long)blockIdx.x * TILE + (long long)threadIdx.x * ITEMS;
  if (q0 >= nl) return;
  const long long span = stride * CHUNK;  // a power of two
  unsigned heads = 0, whole = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long p = q0 + j;
    const int r = p < nl ? rpos[p] : 1;
    if (((long long)r & (span - 1)) == 0) heads |= 1u << j;
    if (r == 0) whole |= 1u << j;
  }
  while (heads) {
    const int j = __ffs(heads) - 1;
    heads &= heads - 1;
    const long long p = q0 + j;
    const int k = sk[p];
    if (p + stride >= nl || sk[p + stride] != k) continue;  // done below, or a lone partial
    int len;
    const float a = fold_chunk(sk, nl, p, stride, k, mode, [&](long long q) { return part[q]; },
                               len);
    const long long q = p + len * stride;
    if (((whole >> j) & 1) && (q >= nl || sk[q] != k)) red[k] = a;
    else part[p] = a;
  }
}

int key_bits(int B) {
  int b = 0;
  while ((1LL << b) < B) ++b;
  return b;
}

#define LAUNCHED()                           \
  do {                                       \
    cudaError_t e_ = cudaGetLastError();     \
    if (e_ != cudaSuccess) return (int)e_;   \
  } while (0)

}  // namespace

// keys i32[n]; values f32[S, n]; valids bool[V, n]; plan: HOST int[2S],
// plan[s] = mode of value row s (0 sum, 1 min, 2 max), plan[S + s] = the
// validity row it reads.  passes / digit_bits / levels and the scratch
// sizes come from `segment_reduce.sort_plan(n, B, S)`: sort_keys and
// sort_ids i32[2n], hist i32[bins * ceil(n / TILE)], aux i32[2 * bins + 2]
// (all unused, and may be null, when S == 0).  Outputs reds f32[S, B],
// cnts i32[V, B].
REPRO_EXPORT int repro_segment_reduce(const void* keys, const void* values, const void* valids,
                                      const int* plan, int S, int V, int B, long long n,
                                      int passes, int digit_bits, int levels, void* sort_keys,
                                      void* sort_ids, void* hist, void* aux, void* reds,
                                      void* cnts, void* stream) {
  if (n <= 0 || n >= (1LL << 31) || B <= 0 || B >= (1 << 24) || V <= 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  long long reach = 1;
  for (int l = 0; l < levels && reach < n; ++l) reach *= CHUNK;
  if (S > 0 && (passes < 1 || digit_bits < 0 || digit_bits > MAX_DIGIT_BITS ||
                passes * digit_bits < key_bits(B) || levels < 1 || reach < n || !plan ||
                !sort_keys || !sort_ids || !hist || !aux))
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < S; ++s)
    if (plan[s] < kSum || plan[s] > kMax || plan[S + s] < 0 || plan[S + s] >= V)
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* k_in = (const int*)keys;
  const uint8_t* v_in = (const uint8_t*)valids;
  int* c_out = (int*)cnts;
  const long long ntiles = (n + TILE - 1) / TILE;

  cudaError_t e = cudaMemsetAsync(c_out, 0, (size_t)V * B * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if ((long long)V * B <= SHARED_COUNTS) {
    const int blocks = (int)(ntiles < COUNT_BLOCKS ? ntiles : COUNT_BLOCKS);
    count_shared<<<blocks, THREADS, (size_t)V * B * sizeof(int), st>>>(k_in, v_in, V, B, n, c_out);
  } else {
    count_global<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, st>>>(k_in, v_in, V, B, n,
                                                                            c_out);
  }
  LAUNCHED();
  if (S == 0) return 0;

  const int bins = 1 << digit_bits;
  const size_t scatter_smem = ((size_t)(WARPS + 1) * bins + 2 * TILE) * sizeof(int);
  if (scatter_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(sort_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)scatter_smem);
    if (e != cudaSuccess) return (int)e;
  }
  int* buf_k[2] = {(int*)sort_keys, (int*)sort_keys + n};
  int* buf_i[2] = {(int*)sort_ids, (int*)sort_ids + n};
  int* h = (int*)hist;
  int* totals = (int*)aux;
  int* base = totals + bins;
  int* nlive = base + bins;
  int* maxrun = nlive + 1;
  const float* x = (const float*)values;
  float* out = (float*)reds;

  for (int s = 0; s < S; ++s) {
    fill_neutral<<<(B + THREADS - 1) / THREADS, THREADS, 0, st>>>(out + (size_t)s * B, B,
                                                                   plan[s]);
    LAUNCHED();
  }
  for (int u = 0; u < V; ++u) {
    bool used = false;
    for (int s = 0; s < S; ++s) used |= plan[S + s] == u;
    if (!used) continue;
    // (a) + (b): live rows of validity row u, stably sorted by key
    for (int pass = 0; pass < passes; ++pass) {
      PassIn in;
      in.keys = pass ? buf_k[(pass - 1) & 1] : nullptr;
      in.ids = pass ? buf_i[(pass - 1) & 1] : nullptr;
      in.raw = k_in;
      in.valid = v_in + (long long)u * n;
      in.nlive = nlive;
      in.n = n;
      in.B = B;
      in.shift = pass * digit_bits;
      in.mask = (unsigned)bins - 1u;
      sort_hist<<<(unsigned)ntiles, THREADS, 0, st>>>(in, bins, ntiles, h);
      LAUNCHED();
      sort_scan_tiles<<<bins, THREADS, 0, st>>>(h, ntiles, totals);
      LAUNCHED();
      sort_scan_digits<<<1, THREADS, 0, st>>>(totals, bins, base, nlive);
      LAUNCHED();
      sort_scatter<<<(unsigned)ntiles, THREADS, scatter_smem, st>>>(
          in, bins, ntiles, h, base, buf_k[pass & 1], buf_i[pass & 1]);
      LAUNCHED();
    }
    const int* sk = buf_k[(passes - 1) & 1];
    const int* si = buf_i[(passes - 1) & 1];
    int* rpos = buf_k[passes & 1];
    float* part = (float*)buf_i[passes & 1];
    // (c) the fold, one value row at a time (the partials' buffer is shared)
    e = cudaMemsetAsync(maxrun, 0, sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    for (int s = 0; s < S; ++s) {
      if (plan[S + s] != u) continue;
      fold_first<<<(unsigned)ntiles, THREADS, 0, st>>>(sk, si, nlive, x + (long long)s * n,
                                                       plan[s], out + (size_t)s * B, part, rpos,
                                                       maxrun);
      LAUNCHED();
      long long stride = CHUNK;
      for (int l = 1; l < levels; ++l, stride *= CHUNK) {
        fold_level<<<(unsigned)ntiles, THREADS, 0, st>>>(
            sk, nlive, rpos, maxrun, stride, plan[s], out + (size_t)s * B, part);
        LAUNCHED();
      }
    }
  }
  return 0;
}
