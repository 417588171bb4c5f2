// filter_compact: stable compaction of each row by a keep mask; the kept
// elements fill the prefix in their original order, the rest of the row is
// `fill`, and the number kept is returned per row.
//
// Replaces the Pallas kernel `_compact_kernel` / `filter_compact` in
// src/repro/kernels/filter_compact.py (pallas_call at line 67), as called by
// `ops.filter_compact_padded`, its `*_parts` batch and the fused filter->
// reduce composites.  The reference moved float32 through a permutation
// matmul; this kernel moves raw 1-, 4- or 8-byte elements, so bool masks,
// int32 codes, float64 and int64 columns pass through bit for bit.
//
// Bound on an H100 SXM: device memory.  A row of n elements of e bytes
// reads n * e bytes of data and n keep bytes and writes n * e bytes:
// n * (2e + 1) bytes at 3.35 TB/s (12.4 µs at 2,449,813 float64).  The
// count pass reads the keep mask once more.
//
// Design, two launches, no atomics (so the output order is fixed):
//  1. tile_counts: one warp per (keep row, tile of TILE elements) counts
//     the kept bytes, reading the mask in 16-byte vectors (single bytes
//     where the row does not start on a 16-byte boundary);
//  2. scatter_tiles: one block of THREADS threads per (row, tile), launched
//     as a programmatic dependent launch, so its blocks start while pass 1
//     runs.  Each thread loads its ITEMS elements (indices tile base + k
//     THREADS + tid, k < ITEMS) and their keep bytes first, so ITEMS loads
//     of each are in flight; then it waits for pass 1 (griddepcontrol.wait)
//     and the block sums the counts of the tiles before its own, and of all
//     the row's tiles, in tile order (at most a few thousand integers, from
//     L2): that is the tile's output offset and the row's total.  A ballot
//     per item gives each warp its kept count and each element its rank in
//     the warp; one warp scans the ITEMS x WARPS counts in (item, warp)
//     order, which is element order, so a whole tile is ranked with two
//     barriers.  Kept elements go to offset + rank, a warp's to consecutive
//     slots; the block writes `fill` to the slots of its own index range at
//     or past the row's total.
// On an H100 the scatter moves its bytes near a copy's rate, and a
// one-pass design with a decoupled look-back in place of the count pass
// measured slower (PERF.md).
// A keep mask may be shared by every row (keep_rows == 1): the counts are
// then taken once.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // == FC_TILE in filter_compact.py
constexpr int COUNT_WARPS = 8;          // tiles a block of tile_counts takes
static_assert(ITEMS * WARPS == 64, "the rank scan gives each lane two (item, warp) counts");
static_assert(TILE % 16 == 0, "tiles start on 16-byte boundaries of the row");

// kept (non-zero) bytes of a 4-byte word
__device__ __forceinline__ int kept4(unsigned w) { return __popc(__vcmpne4(w, 0u)) >> 3; }

__global__ void __launch_bounds__(COUNT_WARPS * 32)
tile_counts(const uint8_t* __restrict__ keep, long long n, int ntiles, long long work,
            int* __restrict__ counts) {
  // the scatter may start now: its blocks load their elements while this
  // grid counts, and wait for it before they read a count
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const long long id = (long long)blockIdx.x * COUNT_WARPS + (threadIdx.x >> 5);
  if (id >= work) return;
  const int lane = threadIdx.x & 31;
  const long long kr = id / ntiles, base = (id % ntiles) * (long long)TILE;
  const uint8_t* k = keep + kr * n + base;
  const int len = (int)min((long long)TILE, n - base);
  int c = 0, i = lane;
  if (((uintptr_t)k & 15) == 0) {
    const int nv = len >> 4;
    const uint4* kv = reinterpret_cast<const uint4*>(k);
#pragma unroll 4
    for (int v = lane; v < nv; v += 32) {
      const uint4 q = __ldg(kv + v);
      c += kept4(q.x) + kept4(q.y) + kept4(q.z) + kept4(q.w);
    }
    i = 16 * nv + lane;
  }
  for (; i < len; i += 32) c += k[i] != 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if (lane == 0) counts[id] = c;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
scatter_tiles(const T* __restrict__ src, T* __restrict__ dst,
              const uint8_t* __restrict__ keep, int keep_rows, long long n, int ntiles,
              const int* __restrict__ counts, long long* __restrict__ totals, T fill) {
  __shared__ long long before_w[WARPS], all_w[WARPS], total;
  __shared__ long long rank[ITEMS * WARPS];  // (item, warp) kept counts, then output slots
  const int t = (int)(blockIdx.x % ntiles);
  const long long row = blockIdx.x / ntiles;
  const long long kr = keep_rows == 1 ? 0 : row;
  const uint8_t* k = keep + kr * n;
  const T* s = src + row * n;
  T* d = dst + row * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)t * TILE;

  T v[ITEMS];
  bool kp[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const long long i = base + q * THREADS + tid;
    kp[q] = i < n && k[i] != 0;
    v[q] = i < n ? s[i] : fill;
  }

  // the tile's offset and the row's total, summed in tile order, once the
  // count grid has finished and its counts are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int* rc = counts + kr * ntiles;
  long long before = 0, all = 0;
  for (int j = tid; j < ntiles; j += THREADS) {
    const int c = rc[j];
    all += c;
    before += j < t ? c : 0;
  }
  before = repro::warp_reduce_ll(before);
  all = repro::warp_reduce_ll(all);
  unsigned bal[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) bal[q] = __ballot_sync(0xffffffffu, kp[q]);
  if (lane == 0) {
    before_w[warp] = before;
    all_w[warp] = all;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) rank[q * WARPS + warp] = __popc(bal[q]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the (item, warp) counts, in element order
    long long off = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      off += before_w[w];
      tot += all_w[w];
    }
    const long long a = rank[2 * lane], b = rank[2 * lane + 1];
    long long incl = a + b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    rank[2 * lane] = off + incl - a - b;
    rank[2 * lane + 1] = off + incl - b;
    if (lane == 0) total = tot;
  }
  __syncthreads();
  const long long row_total = total;
  if (t == 0 && tid == 0 && (keep_rows > 1 || row == 0)) totals[kr] = row_total;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const long long i = base + q * THREADS + tid;
    if (kp[q]) d[rank[q * WARPS + warp] + __popc(bal[q] & below)] = v[q];
    if (i < n && i >= row_total) d[i] = fill;
  }
}

template <typename T>
int launch_scatter(const void* src, void* dst, const void* keep, int keep_rows,
                   long long rows, long long n, long long ntiles, const int* counts,
                   long long* totals, unsigned long long fill_bits, cudaStream_t st) {
  T fill;
  static_assert(sizeof(T) <= sizeof(fill_bits), "element too wide");
  memcpy(&fill, &fill_bits, sizeof(T));
  // a programmatic dependent launch: it may begin before tile_counts ends
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * ntiles));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, scatter_tiles<T>, (const T*)src, (T*)dst,
                                 (const uint8_t*)keep, keep_rows, n, (int)ntiles, counts,
                                 totals, fill);
}

}  // namespace

REPRO_EXPORT int repro_filter_compact_tile() { return TILE; }

// src, dst: elem_size-byte elements [rows, n]; keep: bool [keep_rows, n] with
// keep_rows == rows or 1 (shared).  scratch: the totals i64[keep_rows] (the
// output: kept elements per keep row), then the tile counts
// i32[keep_rows * ceil(n / TILE)].  fill_bits: the fill element's bytes,
// low-order first.
REPRO_EXPORT int repro_filter_compact(const void* src, void* dst, const void* keep,
                                      long long keep_rows, long long rows, long long n,
                                      int elem_size, unsigned long long fill_bits,
                                      void* scratch, void* stream) {
  if (rows <= 0 || n <= 0 || !(keep_rows == 1 || keep_rows == rows))
    return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + TILE - 1) / TILE;
  if (rows * ntiles > 0x7fffffffLL || keep_rows * ntiles > 0x7fffffffLL * COUNT_WARPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  long long* totals = (long long*)scratch;
  int* counts = (int*)(totals + keep_rows);
  const long long work = keep_rows * ntiles;
  tile_counts<<<(unsigned)((work + COUNT_WARPS - 1) / COUNT_WARPS), COUNT_WARPS * 32, 0, st>>>(
      (const uint8_t*)keep, n, (int)ntiles, work, counts);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  switch (elem_size) {
    case 1:
      return launch_scatter<uint8_t>(src, dst, keep, (int)keep_rows, rows, n, ntiles, counts,
                                     totals, fill_bits, st);
    case 4:
      return launch_scatter<uint32_t>(src, dst, keep, (int)keep_rows, rows, n, ntiles, counts,
                                      totals, fill_bits, st);
    case 8:
      return launch_scatter<unsigned long long>(src, dst, keep, (int)keep_rows, rows, n, ntiles,
                                                counts, totals, fill_bits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
