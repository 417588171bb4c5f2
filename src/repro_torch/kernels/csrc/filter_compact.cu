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
// n * (2e + 1) bytes at 3.35 TB/s.  Passes 1-2 read the keep mask once more.
//
// Design, three passes (no atomics, so the output order is fixed):
//  1. per (keep row, tile): integer count of kept elements;
//  2. one block per keep row: exclusive scan of the tile counts in tile
//     order, giving each tile's output offset and the row's total;
//  3. per (row, tile): chunks of THREADS elements; within a warp,
//     __ballot_sync + __popc give each kept element its rank, the block's
//     warp totals are summed in warp order, and the element is scattered to
//     offset + rank.  The same block writes `fill` to the slots of its own
//     index range that lie at or past the row's total.
// A keep mask may be shared by every row (keep_rows == 1): passes 1-2 then
// run once.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int TILE = 4096;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
tile_counts(const uint8_t* __restrict__ keep, long long n, int ntiles,
            int* __restrict__ counts) {
  __shared__ long long scr[32];
  const int t = (int)(blockIdx.x % ntiles);
  const long long kr = blockIdx.x / ntiles;
  const uint8_t* k = keep + kr * n;
  const long long base = (long long)t * TILE;
  long long c = 0;
  for (int j = threadIdx.x; j < TILE; j += THREADS) {
    const long long i = base + j;
    c += (i < n && k[i]) ? 1 : 0;
  }
  c = repro::block_reduce_ll(c, scr);
  if (threadIdx.x == 0) counts[kr * ntiles + t] = (int)c;
}

__global__ void __launch_bounds__(1024)
scan_tiles(const int* __restrict__ counts, int ntiles,
           long long* __restrict__ offsets, long long* __restrict__ totals) {
  __shared__ long long buf[1024];
  const long long kr = blockIdx.x;
  const int* c = counts + kr * ntiles;
  long long* o = offsets + kr * ntiles;
  long long carry = 0;
  for (int start = 0; start < ntiles; start += 1024) {
    const int i = start + threadIdx.x;
    const long long v = i < ntiles ? c[i] : 0;
    buf[threadIdx.x] = v;
    __syncthreads();
    // Hillis-Steele inclusive scan over the chunk (integers: exact)
    for (int s = 1; s < 1024; s <<= 1) {
      const long long add = threadIdx.x >= s ? buf[threadIdx.x - s] : 0;
      __syncthreads();
      buf[threadIdx.x] += add;
      __syncthreads();
    }
    if (i < ntiles) o[i] = carry + buf[threadIdx.x] - v;
    carry += buf[1023];
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[kr] = carry;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
scatter_tiles(const T* __restrict__ src, T* __restrict__ dst,
              const uint8_t* __restrict__ keep, int keep_rows, long long n,
              int ntiles, const long long* __restrict__ offsets,
              const long long* __restrict__ totals, T fill) {
  __shared__ int wtot[WARPS];
  const int t = (int)(blockIdx.x % ntiles);
  const long long row = blockIdx.x / ntiles;
  const long long kr = keep_rows == 1 ? 0 : row;
  const uint8_t* k = keep + kr * n;
  const T* s = src + row * n;
  T* d = dst + row * n;
  const long long total = totals[kr];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long pos = offsets[kr * ntiles + t];
  const long long base = (long long)t * TILE;
  for (int c = 0; c < TILE; c += THREADS) {
    const long long i = base + c + threadIdx.x;
    const bool in = i < n;
    const bool kp = in && k[i];
    const unsigned bal = __ballot_sync(0xffffffffu, kp);
    if (lane == 0) wtot[warp] = __popc(bal);
    __syncthreads();
    int before = 0, chunk = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int v = wtot[w];
      before += w < warp ? v : 0;
      chunk += v;
    }
    if (kp) d[pos + before + __popc(bal & ((1u << lane) - 1u))] = s[i];
    if (in && i >= total) d[i] = fill;
    pos += chunk;
    __syncthreads();  // wtot is rewritten by the next chunk
  }
}

template <typename T>
int launch_scatter(const void* src, void* dst, const void* keep, int keep_rows,
                   long long rows, long long n, long long ntiles,
                   const long long* offsets, const long long* totals,
                   unsigned long long fill_bits, cudaStream_t st) {
  T fill;
  static_assert(sizeof(T) <= sizeof(fill_bits), "element too wide");
  memcpy(&fill, &fill_bits, sizeof(T));
  scatter_tiles<T><<<(unsigned)(rows * ntiles), THREADS, 0, st>>>(
      (const T*)src, (T*)dst, (const uint8_t*)keep, keep_rows, n, (int)ntiles,
      offsets, totals, fill);
  return (int)cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int repro_filter_compact_tile() { return TILE; }

// src, dst: elem_size-byte elements [rows, n]; keep: bool [keep_rows, n] with
// keep_rows == rows or 1 (shared).  Scratch: counts i32[keep_rows * ntiles],
// offsets i64[keep_rows * ntiles] (ntiles = ceil(n / TILE)).  Output totals
// i64[keep_rows].  fill_bits: the fill element's bytes, low-order first.
REPRO_EXPORT int repro_filter_compact(const void* src, void* dst,
                                      const void* keep, long long keep_rows,
                                      long long rows, long long n,
                                      int elem_size,
                                      unsigned long long fill_bits,
                                      void* counts, void* offsets,
                                      void* totals, void* stream) {
  if (rows <= 0 || n <= 0 || !(keep_rows == 1 || keep_rows == rows))
    return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + TILE - 1) / TILE;
  if (rows * ntiles > 0x7fffffffLL || keep_rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  tile_counts<<<(unsigned)(keep_rows * ntiles), THREADS, 0, st>>>(
      (const uint8_t*)keep, n, (int)ntiles, (int*)counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_tiles<<<(unsigned)keep_rows, 1024, 0, st>>>(
      (const int*)counts, (int)ntiles, (long long*)offsets, (long long*)totals);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long* off = (const long long*)offsets;
  const long long* tot = (const long long*)totals;
  switch (elem_size) {
    case 1:
      return launch_scatter<uint8_t>(src, dst, keep, (int)keep_rows, rows, n,
                                     ntiles, off, tot, fill_bits, st);
    case 4:
      return launch_scatter<uint32_t>(src, dst, keep, (int)keep_rows, rows, n,
                                      ntiles, off, tot, fill_bits, st);
    case 8:
      return launch_scatter<unsigned long long>(src, dst, keep, (int)keep_rows,
                                                rows, n, ntiles, off, tot,
                                                fill_bits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
