// segment_reduce: per-bucket sum / min / max of S value rows keyed by int32
// codes under V validity rows, plus V rows of per-bucket valid counts.
//
// Replaces the Pallas kernel `_segment_kernel` / `segment_reduce` in
// src/repro/kernels/segment_reduce.py (pallas_call at line 103), as batched
// by `ops.segment_reduce_batch`.  The reference's one-hot matmul was a way
// round the TPU's lack of scatter and atomics; it is not carried over.
//
// Bound on an H100 SXM: device memory for the inputs (4-byte key, S 4-byte
// values and V 1-byte valids per row: n * (4 + 4S + V) bytes at 3.35 TB/s).
// In practice the bucket walk below is bound by issue rate instead: every
// thread of a block reads every key of its tile from shared memory.
//
// Design (deterministic, no float atomics), for any B < 2^24:
//  * pass 1, grid (tiles, bucket ranges).  A tile is `tile` rows (chosen by
//    the wrapper, `segment_reduce.tile_rows`); a bucket range is the widest
//    run of buckets whose (S + V) accumulators fit one block's shared memory
//    beside a STAGE-row staging buffer (all B when they fit).  The block
//    stages its tile STAGE rows at a time (keys and validity bytes) and
//    thread `tid` owns the buckets r0 + tid, r0 + tid + THREADS, ... of its
//    range: it walks the staged rows in row order and updates the shared
//    accumulators of the buckets it owns, skipping keys outside the range.
//    So every bucket sums its rows in row order with no race.  Counts are
//    integers.  The block writes its tile's partials of its range.
//  * pass 2, one thread per (row, bucket): folds the tile partials in tile
//    order.  Padded rows (valid False) touch nothing, and an extra all-
//    padding tile contributes exact neutrals (+0.0, +inf, -inf, 0).
//  * with one range and tile == STAGE (every B whose accumulators fit one
//    block) this is the single-range kernel bit for bit.
//
// Scratch bound: part_f / part_c hold ceil(n / tile) * (S + V) * B * 4
// bytes.  `tile` is STAGE * 2^k, the least with B * 4 <= 128 * tile, a
// function of B only, so a value row's fold order does not depend on how
// many rows share the call (batched == per-row for every B), and every
// B <= 65,536 keeps tile == STAGE.  The scratch is at most 128 * (S + V)
// bytes per input row plus one tile's partials ((S + V) * B * 4 bytes): at
// B = 100,000, S + V = 2 over 2.45M rows, tile = 4,096 and 480 MB.
#include "common.cuh"

namespace {

constexpr int STAGE = 2048;  // == repro_torch.kernels.segment_reduce.SEG_TILE
constexpr int THREADS = 256;
constexpr long long SMEM_MAX = 227 * 1024;  // one H100 block's dynamic smem

enum Mode { kSum = 0, kMin = 1, kMax = 2 };

long long staging_bytes(int V) { return (long long)STAGE * 4 + (long long)V * STAGE; }

// Buckets per range: all B when their accumulators fit beside the staging.
int range_width(int S, int V, int B) {
  const long long room = (SMEM_MAX - staging_bytes(V)) / ((long long)(S + V) * 4);
  return (int)(room < B ? room : B);
}

__global__ void __launch_bounds__(THREADS)
segment_tiles(const int* __restrict__ keys, const float* __restrict__ values,
              const uint8_t* __restrict__ valids, const int* __restrict__ plan,
              int S, int V, int B, long long n, int tile, int width,
              float* __restrict__ part_f, int* __restrict__ part_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r0 = blockIdx.y * width;
  const int nb = min(width, B - r0);
  float* acc_f = reinterpret_cast<float*>(smem);               // S * nb
  int* acc_c = reinterpret_cast<int*>(acc_f + (size_t)S * nb);  // V * nb
  int* skeys = acc_c + (size_t)V * nb;                          // STAGE
  uint8_t* svalid = reinterpret_cast<uint8_t*>(skeys + STAGE);  // V * STAGE

  const long long t = blockIdx.x;
  const long long start = t * tile;
  const long long end = min(start + tile, n);

  for (int i = threadIdx.x; i < S * nb; i += THREADS) {
    const int mode = plan[i / nb];
    acc_f[i] = mode == kSum ? 0.0f : (mode == kMin ? CUDART_INF_F : -CUDART_INF_F);
  }
  for (int i = threadIdx.x; i < V * nb; i += THREADS) acc_c[i] = 0;

  for (long long base = start; base < end; base += STAGE) {
    const int len = (int)min((long long)STAGE, end - base);
    __syncthreads();  // the previous stage has been consumed
    for (int r = threadIdx.x; r < len; r += THREADS) skeys[r] = keys[base + r];
    for (int v = 0; v < V; ++v)
      for (int r = threadIdx.x; r < len; r += THREADS)
        svalid[v * STAGE + r] = valids[(long long)v * n + base + r];
    __syncthreads();

    for (int r = 0; r < len; ++r) {
      const int k = skeys[r] - r0;
      if (k < 0 || k >= nb || (k % THREADS) != threadIdx.x) continue;
      for (int v = 0; v < V; ++v) acc_c[v * nb + k] += svalid[v * STAGE + r] ? 1 : 0;
      for (int s = 0; s < S; ++s) {
        if (!svalid[plan[S + s] * STAGE + r]) continue;
        const float x = values[(long long)s * n + base + r];
        float* a = &acc_f[s * nb + k];
        const int mode = plan[s];
        *a = mode == kSum ? *a + x : (mode == kMin ? fminf(*a, x) : fmaxf(*a, x));
      }
    }
  }
  __syncthreads();

  float* pf = part_f + (size_t)t * S * B + r0;
  int* pc = part_c + (size_t)t * V * B + r0;
  for (int i = threadIdx.x; i < S * nb; i += THREADS)
    pf[(size_t)(i / nb) * B + i % nb] = acc_f[i];
  for (int i = threadIdx.x; i < V * nb; i += THREADS)
    pc[(size_t)(i / nb) * B + i % nb] = acc_c[i];
}

__global__ void segment_merge(const float* __restrict__ part_f,
                              const int* __restrict__ part_c,
                              const int* __restrict__ plan, int S, int V, int B,
                              long long ntiles, float* __restrict__ reds,
                              int* __restrict__ cnts) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nf = (long long)S * B, nc = (long long)V * B;
  if (o < nf) {
    const int mode = plan[o / B];
    float a = mode == kSum ? 0.0f : (mode == kMin ? CUDART_INF_F : -CUDART_INF_F);
    for (long long t = 0; t < ntiles; ++t) {
      const float x = part_f[t * nf + o];
      a = mode == kSum ? a + x : (mode == kMin ? fminf(a, x) : fmaxf(a, x));
    }
    reds[o] = a;
  } else if (o < nf + nc) {
    const long long c = o - nf;
    int a = 0;
    for (long long t = 0; t < ntiles; ++t) a += part_c[t * nc + c];
    cnts[c] = a;
  }
}

}  // namespace

// keys i32[n]; values f32[S, n]; valids bool[V, n]; plan i32[2S] on the
// device: plan[s] = mode of value row s (0 sum, 1 min, 2 max), plan[S + s] =
// the validity row value row s reads.  `tile` rows per tile, a multiple of
// STAGE.  Scratch part_f f32[ntiles, S, B], part_c i32[ntiles, V, B] with
// ntiles = ceil(n / tile).  Outputs reds f32[S, B], cnts i32[V, B].
REPRO_EXPORT int repro_segment_reduce(const void* keys, const void* values,
                                      const void* valids, const void* plan,
                                      int S, int V, int B, long long n, int tile,
                                      void* part_f, void* part_c, void* reds,
                                      void* cnts, void* stream) {
  if (n <= 0 || B <= 0 || B >= (1 << 24) || V <= 0 || S < 0 || tile <= 0 ||
      tile % STAGE != 0)
    return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + tile - 1) / tile;
  const int width = range_width(S, V, B);
  if (width < 1) return (int)cudaErrorInvalidValue;
  const long long nranges = (B + width - 1) / width;
  if (ntiles > 0x7fffffffLL || nranges > 65535) return (int)cudaErrorInvalidValue;
  const long long smem = (long long)(S + V) * width * 4 + staging_bytes(V);
  cudaError_t e = cudaFuncSetAttribute(
      segment_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  segment_tiles<<<dim3((unsigned)ntiles, (unsigned)nranges), THREADS, (size_t)smem, st>>>(
      (const int*)keys, (const float*)values, (const uint8_t*)valids,
      (const int*)plan, S, V, B, n, tile, width, (float*)part_f, (int*)part_c);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long outs = (long long)(S + V) * B;
  const int mt = 256;
  segment_merge<<<(unsigned)((outs + mt - 1) / mt), mt, 0, st>>>(
      (const float*)part_f, (const int*)part_c, (const int*)plan, S, V, B,
      ntiles, (float*)reds, (int*)cnts);
  return (int)cudaGetLastError();
}
