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
// Design (deterministic, no float atomics):
//  * pass 1, one block per TILE rows: the block stages its tile's keys and
//    validity bytes in shared memory.  Thread `tid` owns the buckets
//    b = tid, tid + THREADS, ... and walks the tile in row order, updating
//    the shared accumulators of the buckets it owns, so every bucket sums
//    its rows in row order with no race.  Counts are integers.  The block
//    writes its tile's partials: tiles x (S + V) x B.
//  * pass 2, one thread per (row, bucket): folds the tile partials in tile
//    order.  Padded rows (valid False) touch nothing, and an extra all-
//    padding tile contributes exact neutrals (+0.0, +inf, -inf, 0).
//  * shared memory holds (S + V) * B accumulators; the frame layer routes
//    plans above SEG_MAX_ACC words to numpy ahead of time
//    (`frame.backend._groupby_supported`).
#include "common.cuh"

namespace {

constexpr int TILE = 2048;  // == repro_torch.kernels.segment_reduce.SEG_TILE
constexpr int THREADS = 256;

enum Mode { kSum = 0, kMin = 1, kMax = 2 };

__global__ void __launch_bounds__(THREADS)
segment_tiles(const int* __restrict__ keys, const float* __restrict__ values,
              const uint8_t* __restrict__ valids, const int* __restrict__ plan,
              int S, int V, int B, long long n, float* __restrict__ part_f,
              int* __restrict__ part_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc_f = reinterpret_cast<float*>(smem);          // S * B
  int* acc_c = reinterpret_cast<int*>(acc_f + (size_t)S * B);  // V * B
  int* skeys = acc_c + (size_t)V * B;                      // TILE
  uint8_t* svalid = reinterpret_cast<uint8_t*>(skeys + TILE);  // V * TILE

  const int t = blockIdx.x;
  const long long base = (long long)t * TILE;
  const int len = (int)min((long long)TILE, n - base);

  for (int i = threadIdx.x; i < S * B; i += THREADS) {
    const int mode = plan[i / B];
    acc_f[i] = mode == kSum ? 0.0f : (mode == kMin ? CUDART_INF_F : -CUDART_INF_F);
  }
  for (int i = threadIdx.x; i < V * B; i += THREADS) acc_c[i] = 0;
  for (int r = threadIdx.x; r < len; r += THREADS) skeys[r] = keys[base + r];
  for (int v = 0; v < V; ++v)
    for (int r = threadIdx.x; r < len; r += THREADS)
      svalid[v * TILE + r] = valids[(long long)v * n + base + r];
  __syncthreads();

  for (int r = 0; r < len; ++r) {
    const int k = skeys[r];
    if (k < 0 || k >= B || (k % THREADS) != threadIdx.x) continue;
    for (int v = 0; v < V; ++v) acc_c[v * B + k] += svalid[v * TILE + r] ? 1 : 0;
    for (int s = 0; s < S; ++s) {
      if (!svalid[plan[S + s] * TILE + r]) continue;
      const float x = values[(long long)s * n + base + r];
      float* a = &acc_f[s * B + k];
      const int mode = plan[s];
      *a = mode == kSum ? *a + x : (mode == kMin ? fminf(*a, x) : fmaxf(*a, x));
    }
  }
  __syncthreads();

  float* pf = part_f + (size_t)t * S * B;
  int* pc = part_c + (size_t)t * V * B;
  for (int i = threadIdx.x; i < S * B; i += THREADS) pf[i] = acc_f[i];
  for (int i = threadIdx.x; i < V * B; i += THREADS) pc[i] = acc_c[i];
}

__global__ void segment_merge(const float* __restrict__ part_f,
                              const int* __restrict__ part_c,
                              const int* __restrict__ plan, int S, int V, int B,
                              int ntiles, float* __restrict__ reds,
                              int* __restrict__ cnts) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nf = (long long)S * B, nc = (long long)V * B;
  if (o < nf) {
    const int mode = plan[o / B];
    float a = mode == kSum ? 0.0f : (mode == kMin ? CUDART_INF_F : -CUDART_INF_F);
    for (int t = 0; t < ntiles; ++t) {
      const float x = part_f[(long long)t * nf + o];
      a = mode == kSum ? a + x : (mode == kMin ? fminf(a, x) : fmaxf(a, x));
    }
    reds[o] = a;
  } else if (o < nf + nc) {
    const long long c = o - nf;
    int a = 0;
    for (int t = 0; t < ntiles; ++t) a += part_c[(long long)t * nc + c];
    cnts[c] = a;
  }
}

}  // namespace

REPRO_EXPORT long long repro_segment_smem_bytes(int S, int V, int B) {
  return (long long)(S + V) * B * 4 + (long long)TILE * 4 + (long long)V * TILE;
}

// keys i32[n]; values f32[S, n]; valids bool[V, n]; plan i32[2S] on the
// device: plan[s] = mode of value row s (0 sum, 1 min, 2 max), plan[S + s] =
// the validity row value row s reads.  Scratch part_f f32[ntiles, S, B],
// part_c i32[ntiles, V, B] with ntiles = ceil(n / TILE).  Outputs reds
// f32[S, B], cnts i32[V, B].
REPRO_EXPORT int repro_segment_reduce(const void* keys, const void* values,
                                      const void* valids, const void* plan,
                                      int S, int V, int B, long long n,
                                      void* part_f, void* part_c, void* reds,
                                      void* cnts, void* stream) {
  if (n <= 0 || B <= 0 || V <= 0 || S < 0) return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + TILE - 1) / TILE;
  const long long smem = repro_segment_smem_bytes(S, V, B);
  if (ntiles > 0x7fffffffLL || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      segment_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  segment_tiles<<<(unsigned)ntiles, THREADS, (size_t)smem, st>>>(
      (const int*)keys, (const float*)values, (const uint8_t*)valids,
      (const int*)plan, S, V, B, n, (float*)part_f, (int*)part_c);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long outs = (long long)(S + V) * B;
  const int mt = 256;
  segment_merge<<<(unsigned)((outs + mt - 1) / mt), mt, 0, st>>>(
      (const float*)part_f, (const int*)part_c, (const int*)plan, S, V, B,
      (int)ntiles, (float*)reds, (int*)cnts);
  return (int)cudaGetLastError();
}

REPRO_EXPORT int repro_segment_tile() { return TILE; }
