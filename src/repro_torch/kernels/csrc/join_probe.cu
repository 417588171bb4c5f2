// join_probe: for each left key, its searchsorted-left position in the
// ascending, unique right keys and whether an exact match exists.
//
// Replaces the Pallas kernel `_probe_kernel` / `join_probe` in
// src/repro/kernels/join_probe.py (pallas_call at line 89), as wrapped by
// `ops.join_probe_padded`.  The reference counts `r < l` over every right
// block because a TPU has no cheap data-dependent gather; here one thread per
// left key runs a lower-bound binary search, log2(m) dependent loads.
//
// Semantics (those of the counting formulation):
//   pos[i] = #{ j : right[j] < left[i] },  hit[i] = any(right[j] == left[i]).
// NaN compares false, so a NaN left key gives pos 0 and no hit, and NaN right
// keys (sorted last) never count or match.  The predicate `right[j] < key` is
// true on a prefix and false after it even with NaNs at the end, so the
// search needs no count of them.  ±inf compare exactly, -0.0 == +0.0.
//
// Keys stay native: float32, float64, int32 or int64 (left and right share
// one type, chosen by the caller).
//
// Bound on an H100 SXM: device memory, n * (sizeof(key) + 4 + 1) bytes for
// the left keys read and pos / hit written (the right side is read once
// into cache).  Each search is a chain of dependent loads, so latency bounds
// a thread; the grid keeps enough of them in flight.  When the right side
// fits one block's shared memory (<= 227 KB) each block stages it there and
// walks a grid-stride range of left keys; otherwise searches read it through
// the 50 MB L2 (900,000 int64 keys are 7.2 MB).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long SMEM_MAX = 227 * 1024;

template <typename K>
__global__ void __launch_bounds__(THREADS)
probe(const K* __restrict__ left, long long n, const K* __restrict__ right,
      long long m, bool staged, int* __restrict__ pos, uint8_t* __restrict__ hit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const K* r = right;
  if (staged) {
    K* sr = reinterpret_cast<K*>(smem);
    for (long long j = threadIdx.x; j < m; j += THREADS) sr[j] = right[j];
    __syncthreads();
    r = sr;
  }
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const K key = left[i];
    long long lo = 0, hi = m;  // invariant: r[< lo] < key, r[>= hi] not < key
    while (lo < hi) {
      const long long mid = lo + ((hi - lo) >> 1);
      if (r[mid] < key) lo = mid + 1;
      else hi = mid;
    }
    pos[i] = (int)lo;
    hit[i] = (lo < m && r[lo] == key) ? 1 : 0;
  }
}

template <typename K>
int launch(const void* left, long long n, const void* right, long long m,
           void* pos, void* hit, cudaStream_t st) {
  const long long bytes = m * (long long)sizeof(K);
  const bool staged = bytes <= SMEM_MAX;
  const long long blocks_needed = (n + THREADS - 1) / THREADS;
  long long blocks = blocks_needed;
  size_t smem = 0;
  if (staged) {
    // a staged block pays one load of the right side: give each block a
    // grid-stride share of the left keys instead of one key per thread
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const long long cap = 4LL * sms;
    blocks = blocks_needed < cap ? blocks_needed : cap;
    smem = (size_t)bytes;
    e = cudaFuncSetAttribute(probe<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  probe<K><<<(unsigned)blocks, THREADS, smem, st>>>(
      (const K*)left, n, (const K*)right, m, staged, (int*)pos, (uint8_t*)hit);
  return (int)cudaGetLastError();
}

}  // namespace

// left K[n], right K[m] ascending (NaN last), K by `dtype`: 0 float32,
// 1 float64, 2 int32, 3 int64.  Outputs pos i32[n] (unclipped, in [0, m]),
// hit u8[n].
REPRO_EXPORT int repro_join_probe(const void* left, long long n, const void* right,
                                  long long m, int dtype, void* pos, void* hit,
                                  void* stream) {
  if (n <= 0 || m <= 0 || m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(left, n, right, m, pos, hit, st);
    case 1: return launch<double>(left, n, right, m, pos, hit, st);
    case 2: return launch<int>(left, n, right, m, pos, hit, st);
    case 3: return launch<long long>(left, n, right, m, pos, hit, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
