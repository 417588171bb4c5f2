// join_probe: for each left key, its searchsorted-left position in the
// ascending, unique right keys and whether an exact match exists.
//
// Replaces the Pallas kernel `_probe_kernel` / `join_probe` in
// src/repro/kernels/join_probe.py (pallas_call at line 89), as wrapped by
// `ops.join_probe_padded`.  The reference counts `r < l` over every right
// block because a TPU has no cheap data-dependent gather; here each key runs
// a lower-bound search whose top levels lie in shared memory.
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
// the left keys read and pos / hit written, plus the right side once.  What
// holds a search back is not those bytes but its scattered loads: each level
// that reads device memory is one 32-byte sector a key from the L2, and the
// 32 lanes of a load fall on 32 different lines.  The earlier design
// (one thread a key, a binary search over the whole right side in device
// memory) ran ceil(log2(m + 1)) such levels, the top ones served by the L1.
// On an H100 the same left keys searched wholly in shared memory (a right
// side staged whole) take a fraction of the time of a search that also walks
// a few device levels (chip_smoke.py's join_probe timing), so the design
// moves levels into shared memory.
//
// Design (`probe_sampled`):
// - the sample: every s-th right key (s a power of two, chosen by the
//   wrapper so that the sample takes at most 64 KB), gathered once into a
//   contiguous array by `gather_sample`, then staged in shared memory once
//   per block of a persistent grid-stride grid: two blocks of 512 threads an
//   SM (one of 1,024 for a sample over 112 KB), 1,024 threads being what the
//   registers allow.  The search over the sample runs there, where 32
//   scattered addresses cost a few bank cycles, not 32 sector fetches;
// - only the last log2(s) levels read device memory, and they fall inside
//   the s keys between two sample points: the binary levels stop at one
//   32-byte sector (W = 32 / sizeof(key) keys), which is read whole with two
//   16-byte vector loads and counted;
// - each thread searches KPT keys together, level by level, so their loads
//   are in flight at once;
// - a right side that fits shared memory (<= 227 KB) is staged whole
//   (s = 1): the search never leaves shared memory.
// No atomics; each key's answer is a function of the key and the right side.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 1024;             // probe_sampled's largest block
constexpr int KPT = 4;                        // keys a thread, searched together
constexpr long long STAGE_MAX = 227 * 1024;   // shared memory a block can take

// sample[k] = right[k << log_s], k < ns
template <typename K>
__global__ void gather_sample(const K* __restrict__ right, int ns, int log_s,
                              K* __restrict__ sample) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < ns) sample[k] = right[(long long)k << log_s];
}

// The W = 32 / sizeof(K) keys at right[idx, idx + W), idx a multiple of W:
// two 16-byte loads when the whole sector lies below m and the array is
// 16-byte aligned, else one guarded load each.
template <typename K, bool VEC>
__device__ __forceinline__ void load_sector(const K* right, long long idx, long long m,
                                            K (&out)[32 / sizeof(K)]) {
  constexpr int W = 32 / sizeof(K);
  if (VEC && idx + W <= m) {
    const uint4* p = reinterpret_cast<const uint4*>(right + idx);
    const uint4 a = __ldg(p), b = __ldg(p + 1);
    const K* ka = reinterpret_cast<const K*>(&a);
    const K* kb = reinterpret_cast<const K*>(&b);
#pragma unroll
    for (int w = 0; w < W / 2; ++w) {
      out[w] = ka[w];
      out[W / 2 + w] = kb[w];
    }
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) out[w] = idx + w < m ? __ldg(right + idx + w) : K(0);
  }
}

// The search.  `sample` holds ns keys: the whole right side when log_s == 0
// (ns == m), else right[k << log_s].  With c = #{sample < key}: c == 0 means
// pos 0; otherwise right[(c - 1) s] < key and the answer lies in
// ((c - 1) s, min(c s, m)], so the device levels walk that segment down to
// one sector.  hv keeps the value at the segment's current right end (the
// last probe that was not < key, or sample[c]), which the hit test needs
// when the answer is the sector's end.
template <typename K, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
probe_sampled(const K* __restrict__ left, long long n, const K* __restrict__ right,
              long long m, const K* __restrict__ sample, int ns, int log_s,
              int* __restrict__ pos, uint8_t* __restrict__ hit) {
  constexpr int W = 32 / sizeof(K);
  extern __shared__ __align__(16) unsigned char smem[];
  K* ss = reinterpret_cast<K*>(smem);
  const int threads = blockDim.x;
  for (int j = threadIdx.x; j < ns; j += threads) ss[j] = sample[j];
  __syncthreads();

  const long long per_block = (long long)threads * KPT;
  const long long stride = (long long)gridDim.x * per_block;
  for (long long i0 = (long long)blockIdx.x * per_block + threadIdx.x; i0 < n;
       i0 += stride) {
    K key[KPT];
    int c[KPT];
#pragma unroll
    for (int q = 0; q < KPT; ++q) {
      const long long i = i0 + (long long)q * threads;
      key[q] = i < n ? left[i] : K(0);
    }
    // shared levels: every key of the thread, one level at a time
    {
      int base[KPT];
#pragma unroll
      for (int q = 0; q < KPT; ++q) base[q] = 0;
      int len = ns;
      while (len > 1) {
        const int half = len >> 1;
#pragma unroll
        for (int q = 0; q < KPT; ++q)
          base[q] = (ss[base[q] + half] < key[q]) ? base[q] + half : base[q];
        len -= half;
      }
#pragma unroll
      for (int q = 0; q < KPT; ++q) c[q] = base[q] + (ss[base[q]] < key[q] ? 1 : 0);
    }
    if (log_s == 0) {
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        const long long i = i0 + (long long)q * threads;
        if (i < n) {
          pos[i] = c[q];
          hit[i] = (c[q] < ns && ss[c[q]] == key[q]) ? 1 : 0;
        }
      }
      continue;
    }
    // device levels: from the segment of s keys down to one sector
    long long idx[KPT];
    K hv[KPT];
#pragma unroll
    for (int q = 0; q < KPT; ++q) {
      idx[q] = c[q] > 0 ? (long long)(c[q] - 1) << log_s : 0;
      hv[q] = c[q] < ns ? ss[c[q]] : K(0);  // unused when c == ns: the end is >= m
    }
    for (long long step = (1LL << log_s) >> 1; step >= W; step >>= 1) {
      K v[KPT];
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        const long long j = idx[q] + step;
        v[q] = (c[q] > 0 && j < m) ? __ldg(right + j) : K(0);
      }
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        const long long j = idx[q] + step;
        if (c[q] > 0 && j < m) {
          if (v[q] < key[q]) idx[q] = j;
          else hv[q] = v[q];
        }
      }
    }
    // the last sector: count its keys below the key (right[idx] is one)
#pragma unroll
    for (int q = 0; q < KPT; ++q) {
      const long long i = i0 + (long long)q * threads;
      if (i >= n) continue;
      if (c[q] == 0) {
        pos[i] = 0;
        hit[i] = ss[0] == key[q] ? 1 : 0;
        continue;
      }
      K sec[W];
      load_sector<K, VEC>(right, idx[q], m, sec);
      int cnt = 0;
      K at = hv[q];
#pragma unroll
      for (int w = 0; w < W; ++w) cnt += (idx[q] + w < m && sec[w] < key[q]) ? 1 : 0;
#pragma unroll
      for (int w = 0; w < W; ++w)
        if (w == cnt) at = sec[w];
      const long long p = idx[q] + cnt;
      pos[i] = (int)p;
      hit[i] = (p < m && at == key[q]) ? 1 : 0;
    }
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

template <typename K, bool VEC>
int launch_sampled(const K* left, long long n, const K* right, long long m, int log_s,
                   K* scratch, long long scratch_bytes, int* pos, uint8_t* hit,
                   cudaStream_t st) {
  constexpr long long W = 32 / sizeof(K);
  const long long s = 1LL << log_s;
  const long long ns = (m + s - 1) >> log_s;
  const long long smem = ns * (long long)sizeof(K);
  if (smem > STAGE_MAX || (log_s > 0 && (s < W || smem > scratch_bytes || log_s > 31)))
    return (int)cudaErrorInvalidValue;
  const K* sample = right;
  if (log_s > 0) {
    gather_sample<K><<<(unsigned)((ns + 255) / 256), 256, 0, st>>>(right, (int)ns, log_s,
                                                                  scratch);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    sample = scratch;
  }
  auto kernel = probe_sampled<K, VEC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)STAGE_MAX);
  // 1,024 threads an SM (what the registers allow): two blocks of 512 while
  // two samples fit, else one of 1,024
  const int threads = smem > 112 * 1024 ? 1024 : 512;
  int sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = (cudaError_t)sm_count(&sms);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  const long long needed = (n + (long long)threads * KPT - 1) / ((long long)threads * KPT);
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long blocks = needed < cap ? needed : cap;
  kernel<<<(unsigned)blocks, threads, (size_t)smem, st>>>(left, n, right, m, sample, (int)ns,
                                                          log_s, pos, hit);
  return (int)cudaGetLastError();
}

template <typename K>
int launch(const void* left, long long n, const void* right, long long m, int log_s,
           void* scratch, long long scratch_bytes, void* pos, void* hit, cudaStream_t st) {
  const bool vec = ((uintptr_t)right & 15) == 0;
  if (vec)
    return launch_sampled<K, true>((const K*)left, n, (const K*)right, m, log_s, (K*)scratch,
                                   scratch_bytes, (int*)pos, (uint8_t*)hit, st);
  return launch_sampled<K, false>((const K*)left, n, (const K*)right, m, log_s, (K*)scratch,
                                  scratch_bytes, (int*)pos, (uint8_t*)hit, st);
}

}  // namespace

// left K[n], right K[m] ascending (NaN last), K by `dtype`: 0 float32,
// 1 float64, 2 int32, 3 int64.  log_s: 0 stages the right side whole (m
// keys within 227 KB), else the sample takes every 2^log_s-th key (2^log_s
// >= 32 / sizeof(K), ceil(m / 2^log_s) keys within 227 KB) and is gathered
// into `scratch` (scratch_bytes long) first.  Outputs pos i32[n]
// (unclipped, in [0, m]), hit u8[n].  Two launches on `stream`.
REPRO_EXPORT int repro_join_probe(const void* left, long long n, const void* right,
                                  long long m, int dtype, int log_s, void* scratch,
                                  long long scratch_bytes, void* pos, void* hit,
                                  void* stream) {
  if (n <= 0 || m <= 0 || m > 0x7fffffffLL || log_s < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(left, n, right, m, log_s, scratch, scratch_bytes, pos, hit, st);
    case 1: return launch<double>(left, n, right, m, log_s, scratch, scratch_bytes, pos, hit, st);
    case 2: return launch<int>(left, n, right, m, log_s, scratch, scratch_bytes, pos, hit, st);
    case 3:
      return launch<long long>(left, n, right, m, log_s, scratch, scratch_bytes, pos, hit, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
