// topk: the k largest values of each row, sorted descending (values only).
//
// Replaces the Pallas kernel `_topk_kernel` / `topk` in
// src/repro/kernels/topk.py (pallas_call at line 56), as called by
// `ops.topk_padded`, `ops.topk_padded_parts` and `ops.topk_masked_padded`.
// `largest=False` is served by negation, as the reference does: the first
// launch loads sign * x and the last one stores sign * winner.
//
// Bound on an H100 SXM: device memory, n * 4 bytes per row read once at
// 3.35 TB/s (1 x 4,194,304: 16.8 MB, 5 us).  A few compares an element.
//
// Design, a threshold-filtered select in two launches, no atomics:
//  1. topk_spans over `blocks` blocks a row (about two an SM), each on a
//     contiguous span of its row.  A lane loads UNROLL 16-byte vectors a
//     step, and the next step's loads are out before it works on this one
//     (up to 64 KB a block, 128 KB an SM in flight; 8 vectors a lane beat
//     4 on an ascending row, and 16 cost a block an SM; PERF.md).  Single
//     loads take the at most three elements before the span's first 16-byte
//     boundary and after its last one, so any row start works.  Each warp
//     holds a sorted top-K list (K = 32, 64 or 128, the power of two >= k;
//     K / 32 values a lane) whose k-th value is a running threshold.  Before
//     its first step the warp seeds the list with each lane's R largest
//     loaded values, so the threshold starts high.  A batch of a step's
//     values is offered only if some lane's value beats the threshold (one
//     vote); those that beat it (strictly: the output is values, so a tie
//     changes nothing) go by ballot rank into the warp's queue in shared
//     memory, which has room for a whole batch.  After the batch, whole runs
//     of K come off the queue's end: the warp sorts a run (bitonic, in
//     registers and shuffles), folds it into the list by the bitonic max
//     trick (the list descending against the run ascending), merges the
//     result and raises the threshold.  At the end the rest of the queue is
//     folded, and the warps' lists fold pairwise in a tree.  Offering value
//     by value with a fold inlined at every offer, and networks of compares
//     and selects, measured several times slower on an H100 (PERF.md).
//  2. topk_merge, the same select with one block a row over the (rows,
//     blocks * k) winners, launched as a programmatic dependent launch (it
//     waits for launch 1 with griddepcontrol.wait), applies the output
//     sign.  A row short enough for one block takes topk_merge alone.
// Pads and missing values are -inf, which never beats the threshold; a row
// with fewer than k values above -inf returns -inf for the rest.  NaN ranks
// above every value, as in the reference (its rounds of max and argmax put
// NaN first) and in the plain version (a descending sort): a NaN compares
// false with the threshold, so it never enters a queue or a network, and
// each lane counts the NaNs among the values it loads instead.  The batch
// vote costs no more for it (one compare a value, "above the threshold or
// unordered"); only a batch that holds a NaN, or a value that beats the
// threshold, counts them.  A block sums its warps' counts and emits min(count,
// k) NaNs first, then the k - min(count, k) largest values; the merge counts
// the NaNs among the spans' winners the same way, so a row with c NaNs gives
// min(c, k) of them, for `largest` either way (a negated NaN is a NaN).  The
// result is exact (values only; +0.0 and -0.0 compare equal and may trade
// places): which lane or block sees a value depends on the row's start
// address and length, but the k largest values, sorted, do not, so
// padding, batching and alignment leave the result as it is.  Sorted rows are the worst case of a running threshold: on an
// ascending span every value enters the queue, so a warp folds a batch for
// every K values it reads (PERF.md gives the time).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;         // 16-byte loads a lane issues a step
constexpr int STEP = 4 * UNROLL;  // values a lane loads a step
constexpr int BATCH = 32;         // values a lane offers between two drains
static_assert(STEP % BATCH == 0, "a step is whole batches");
constexpr unsigned FULL = 0xffffffffu;

// A warp's sequence of 32 R values: element e = r * 32 + lane is v[r] of
// lane `lane`.  A compare-exchange is one shuffle and one fminf or fmaxf:
// written as compares and selects, a sort and merge of 32 values took
// several times as many cycles on an H100 (PERF.md).  No NaN reaches the
// networks (only values that beat the threshold enter a queue; NaNs are
// counted apart), so the pair keeps its two values.

// Sort ascending (a full bitonic network).
template <int R>
__device__ __forceinline__ void sort_asc(float (&v)[R], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = r * 32 + lane;
        const bool up = (e & size) == 0;  // the pair's run sorts ascending
        if (j < 32) {
          const float o = __shfl_xor_sync(FULL, v[r], j);
          const bool keep_min = ((e & j) == 0) == up;
          v[r] = keep_min ? fminf(v[r], o) : fmaxf(v[r], o);
        } else if ((r & (j >> 5)) == 0) {
          const int p = r | (j >> 5);
          const float a = v[r], b = v[p];
          v[r] = up ? fminf(a, b) : fmaxf(a, b);
          v[p] = up ? fmaxf(a, b) : fminf(a, b);
        }
      }
    }
  }
}

// Sort a bitonic sequence descending (half-cleaners).
template <int R>
__device__ __forceinline__ void merge_desc(float (&v)[R], int lane) {
#pragma unroll
  for (int j = 16 * R; j > 0; j >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = r * 32 + lane;
      if (j < 32) {
        const float o = __shfl_xor_sync(FULL, v[r], j);
        v[r] = (e & j) == 0 ? fmaxf(v[r], o) : fminf(v[r], o);
      } else if ((r & (j >> 5)) == 0) {
        const int p = r | (j >> 5);
        const float a = v[r], b = v[p];
        v[r] = fmaxf(a, b);
        v[p] = fminf(a, b);
      }
    }
  }
}

// Element i of the sequence, to every lane.
template <int R>
__device__ __forceinline__ float element(const float (&v)[R], int i) {
  float x = v[0];
#pragma unroll
  for (int r = 1; r < R; ++r) x = r == (i >> 5) ? v[r] : x;
  return __shfl_sync(FULL, x, i & 31);
}

// A warp's running top-K: the list (descending), its k-th value, and the
// queue in shared memory of values that beat it.
template <int R>
struct WarpTopK {
  static constexpr int K = 32 * R;
  static constexpr int QCAP = K + 32 * BATCH;  // K - 1 left over, then one batch
  float lst[R];
  float th;
  int qn;
  float* q;
  int k, lane;

  __device__ __forceinline__ void init(float* queue, int k_, int lane_) {
#pragma unroll
    for (int r = 0; r < R; ++r) lst[r] = -CUDART_INF_F;
    th = -CUDART_INF_F;
    qn = 0;
    q = queue;
    k = k_;
    lane = lane_;
  }

  // Fold a sequence sorted ascending into the list, keeping the K largest.
  __device__ __forceinline__ void fold_ascending(float (&c)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) lst[r] = fmaxf(lst[r], c[r]);
    merge_desc<R>(lst, lane);
    th = element<R>(lst, k - 1);
  }

  // Fold the queued values q[from, from + K) into the list (-inf past qn).
  __device__ __forceinline__ void fold_queue(int from) {
    __syncwarp();
    float c[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = from + r * 32 + lane;
      c[r] = e < qn ? q[e] : -CUDART_INF_F;
    }
    __syncwarp();
    sort_asc<R>(c, lane);
    fold_ascending(c);
  }

  // Before the warp's first step: each lane's R largest loaded values go
  // straight into the list (and are replaced by -inf in `c`), so the
  // threshold starts high instead of at -inf.
  __device__ __forceinline__ void seed(float (&c)[STEP]) {
    float top[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float best = -CUDART_INF_F;
      int at = -1;
#pragma unroll
      for (int i = 0; i < STEP; ++i) {
        const bool better = c[i] > best;
        best = better ? c[i] : best;
        at = better ? i : at;
      }
#pragma unroll
      for (int i = 0; i < STEP; ++i) c[i] = i == at ? -CUDART_INF_F : c[i];
      top[r] = best;
    }
    sort_asc<R>(top, lane);
    fold_ascending(top);
  }

  // One value a lane, queued if it beats the threshold; every lane calls.
  __device__ __forceinline__ void push(float v) {
    const bool p = v > th;
    const unsigned b = __ballot_sync(FULL, p);
    if (p) q[qn + __popc(b & ((1u << lane) - 1u))] = v;
    qn += __popc(b);
  }

  // Fold whole batches of K off the queue's end until fewer than K are left.
  __device__ __forceinline__ void drain() {
#pragma unroll 1
    while (qn >= K) {
      fold_queue(qn - K);
      qn -= K;
    }
  }

  __device__ __forceinline__ void finish() {
    if (qn > 0) fold_queue(0);
    qn = 0;
  }
};

// Rows of n values, `blocks` blocks a row; out[row, blk, :k] = sign_out *
// the k largest of sign_in * x over the block's span, descending, NaN
// ranking above every value.
template <int R>
__device__ __forceinline__ void select_rows(const float* __restrict__ x, long long n,
                                            int blocks, int k, float sign_in, float sign_out,
                                            float* __restrict__ out) {
  using W = WarpTopK<R>;
  __shared__ float queue[WARPS][W::QCAP];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = (int)(blockIdx.x % blocks);
  const long long row = blockIdx.x / blocks;
  const long long span = ((n + blocks - 1) / blocks + 3) & ~3LL;
  const long long s0 = min(n, blk * span), s1 = min(n, s0 + span);
  const float* xr = x + row * n;

  __shared__ unsigned nans[WARPS];
  W w;
  w.init(queue[warp], k, lane);
  unsigned nan = 0;  // NaNs among the values this lane loaded

  // -inf marks an absent value: it never beats the threshold
  const int off = (int)(((uintptr_t)(xr + s0) & 15) >> 2);  // floats past a 16-byte boundary
  const long long head = min(s1 - s0, (long long)((4 - off) & 3));
  const long long a = s0 + head;
  const long long nvec = (s1 - a) >> 2;
  const long long b = a + 4 * nvec;
  if (warp == 0) {  // at most three single values before the vectors, three after
    const long long i = lane < 3 ? s0 + lane : b + lane - 3;
    const bool in = lane < 3 ? i < a : (lane < 6 && i < s1);
    const float v = in ? sign_in * xr[i] : -CUDART_INF_F;
    nan += v != v;
    w.push(v);
  }
  const float4* xv = reinterpret_cast<const float4*>(xr + a);
  const float gone = -CUDART_INF_F * sign_in;  // an absent value, -inf once signed
  // a step: UNROLL vectors a lane
  auto load = [&](long long v0, float (&c)[STEP]) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = v0 + u * THREADS + tid;
      const float4 q = i < nvec ? __ldcs(xv + i) : make_float4(gone, gone, gone, gone);
      c[4 * u + 0] = sign_in * q.x;
      c[4 * u + 1] = sign_in * q.y;
      c[4 * u + 2] = sign_in * q.z;
      c[4 * u + 3] = sign_in * q.w;
    }
  };
  // the next step's loads go out before this step is offered; past the
  // span a load is all -inf and reads no memory.  (Putting the second
  // step's loads before the seed measured slower on an H100; PERF.md.)
  float c[STEP], nxt[STEP];
  if (nvec > 0) {
    load(0, c);
    w.seed(c);
  }
  for (long long v0 = 0; v0 < nvec; v0 += THREADS * UNROLL) {
    load(v0 + THREADS * UNROLL, nxt);
#pragma unroll
    for (int i0 = 0; i0 < STEP; i0 += BATCH) {
      // one compare a value: above the threshold, or unordered (a NaN: the
      // threshold never is one)
      bool any = false;
#pragma unroll
      for (int i = i0; i < i0 + BATCH; ++i) any |= !(c[i] <= w.th);
      if (__any_sync(FULL, any)) {
#pragma unroll
        for (int i = i0; i < i0 + BATCH; ++i) {
          nan += c[i] != c[i];
          w.push(c[i]);
        }
        w.drain();
      }
    }
#pragma unroll
    for (int i = 0; i < STEP; ++i) c[i] = nxt[i];
  }
  w.finish();
  nan = __reduce_add_sync(FULL, nan);
  if (lane == 0) nans[warp] = nan;

  // the warps' lists fold pairwise in a tree, each read back ascending
  float* mine = queue[warp];
#pragma unroll
  for (int r = 0; r < R; ++r) mine[r * 32 + lane] = w.lst[r];
  __syncthreads();
#pragma unroll
  for (int h = 1; h < WARPS; h <<= 1) {
    if ((warp & (2 * h - 1)) == 0) {
      float other[R];
#pragma unroll
      for (int r = 0; r < R; ++r) other[r] = queue[warp + h][W::K - 1 - (r * 32 + lane)];
      w.fold_ascending(other);
#pragma unroll
      for (int r = 0; r < R; ++r) mine[r * 32 + lane] = w.lst[r];
    }
    __syncthreads();
  }
  if (warp != 0) return;
  // min(count, k) NaNs first (the warps' counts summed in a fixed order),
  // then the largest values; warp 0's list is in queue[0] after the tree
  long long total = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) total += nans[i];
  const int m = (int)min(total, (long long)k);
  float* dst = out + (row * blocks + blk) * (long long)k;
  for (int e = lane; e < k; e += 32) dst[e] = e < m ? CUDART_NAN_F : sign_out * mine[e - m];
}

// launch 1: the spans of each row
template <int R>
__global__ void __launch_bounds__(THREADS)
topk_spans(const float* __restrict__ x, long long n, int blocks, int k, float sign,
           float* __restrict__ part) {
  // the merge may become resident now; it waits for this grid before it
  // reads a winner
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  select_rows<R>(x, n, blocks, k, sign, 1.0f, part);
}

// launch 2 (or the only one): one block a row
template <int R>
__global__ void __launch_bounds__(THREADS)
topk_merge(const float* __restrict__ x, long long n, int k, float sign_in, float sign_out,
           float* __restrict__ out) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  select_rows<R>(x, n, 1, k, sign_in, sign_out, out);
}

template <int R>
int run(const float* x, long long rows, long long n, int k, int blocks, float sign,
        float* part, float* out, cudaStream_t st) {
  if (blocks == 1) {
    topk_merge<R><<<(unsigned)rows, THREADS, 0, st>>>(x, n, k, sign, sign, out);
    return (int)cudaGetLastError();
  }
  topk_spans<R><<<(unsigned)(rows * blocks), THREADS, 0, st>>>(x, n, blocks, k, sign, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // a programmatic dependent launch: it may begin before launch 1 ends
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, topk_merge<R>, (const float*)part,
                                 (long long)blocks * k, k, 1.0f, sign, out);
}

}  // namespace

// x: f32[rows, n], contiguous, any 4-byte aligned start.  blocks: blocks a
// row of launch 1 (1: one launch).  part: f32[rows * blocks * k] scratch,
// any 4-byte aligned address (unused when blocks == 1).  out: f32[rows, k].
// sign: 1 for the largest, -1 for the smallest (then out is ascending).
REPRO_EXPORT int repro_topk(const void* x, long long rows, long long n, int k, int blocks,
                            float sign, void* part, void* out, void* stream) {
  if (rows <= 0 || n <= 0 || k < 1 || k > 128 || blocks < 1 || rows * blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* xs = (const float*)x;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 32) return run<1>(xs, rows, n, k, blocks, sign, (float*)part, (float*)out, st);
  if (k <= 64) return run<2>(xs, rows, n, k, blocks, sign, (float*)part, (float*)out, st);
  return run<4>(xs, rows, n, k, blocks, sign, (float*)part, (float*)out, st);
}
