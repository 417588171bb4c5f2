// ssd_chunk: the Mamba-2 SSD intra-chunk pass.  Per (batch, chunk, head)
// cell, with chunk length L, state size N and head size P:
//
//   cum      = inclusive cumsum of log_a over the chunk           (L,)
//   M[i, j]  = (C Bᵀ)[i, j] * exp(cum_i - cum_j)  for j <= i, else 0
//   y_intra  = M X                        (L, P), written in X's type
//   state    = (B ⊙ exp(cum_{L-1} - cum))ᵀ X   (N, P), float32
//
// Replaces the Pallas kernel `_ssd_kernel` in src/repro/kernels/ssd_chunk.py
// (pallas_call at line 103).  The reference always calls it with zero
// inbound states, so the `h_in` terms are exactly 0 and are not computed;
// the inter-chunk scan and the inbound-state correction stay in the wrapper
// (`kernels.ops.ssd_scan`), as they lie outside the pallas_call there too.
//
// Bound on an H100 SXM: bytes.  The function needs, per cell, C Bᵀ and M X
// over the causal triangle only (T = L (L + 1) / 2 entries, the rest is
// masked to 0) and the chunk state in full: 2 (T N + T P + N L P) flops,
// 5.27 MFLOP at L = N = 128, P = 64.  For 1,024 bf16 tokens x 80 heads that
// is 3.4 GFLOP, 3.4 µs at the bf16 tensor-core rate (989 TFLOP/s), while
// the bytes (about 43 MB) take 12.8 µs at 3.35 TB/s.  In float32 FMA on the
// CUDA cores (67 TFLOP/s), as this kernel computes, the same flops take
// 50 µs: the kernel's own arithmetic, not the card, sets its floor.
// This first kernel does not use the tensor cores and computes the masked
// upper half of C Bᵀ's diagonal blocks too.  B and C are shared by all heads
// of a chunk, yet every head's cell recomputes C Bᵀ, as the reference does:
// the first thing for a later redesign is to compute it once per chunk.
//
// Design: one block of 256 threads per cell.  C, B (rows padded to N + 1
// floats against bank conflicts) and X are staged in shared memory as
// float32; M is built there (the masked half never exponentiates, since
// exp(cum_i - cum_j) overflows for j > i).  Each product runs over 64 x 64
// output blocks, each thread holding a 4 x 4 register tile (rows ty + 16a,
// columns tx + 16b), so one shared load feeds four FMAs.  Sums run over the
// contraction index in order; y_intra is rounded to X's type once, as the
// reference rounds it before its float32 correction.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long SMEM_MAX = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_cells(const T* __restrict__ x, const float* __restrict__ log_a,
          const T* __restrict__ b, const T* __restrict__ c, int S, int H, int P,
          int N, int L, T* __restrict__ y, float* __restrict__ state) {
  extern __shared__ __align__(16) float sm[];
  const int NP = N + 1, LP = L + 1;
  float* cs = sm;                          // C (L, N + 1), later X (L, P)
  float* bs = cs + (size_t)L * max(NP, P);  // B (L, N + 1)
  float* ms = bs + (size_t)L * NP;          // M (L, L + 1)
  float* cum = ms + (size_t)L * LP;         // (L,)
  float* w = cum + L;                       // exp(cum_{L-1} - cum)  (L,)

  const int chunk = blockIdx.x, h = blockIdx.y, bt = blockIdx.z;
  const int nc = S / L;
  const long long row0 = (long long)bt * S + (long long)chunk * L;  // (b, t) row
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int e = tid; e < L * N; e += THREADS) {
    const int i = e / N, n = e % N;
    cs[i * NP + n] = to_f(c[(row0 + i) * N + n]);
    bs[i * NP + n] = to_f(b[(row0 + i) * N + n]);
  }
  for (int e = tid; e < L * LP; e += THREADS) ms[e] = 0.0f;
  if (tid == 0) {
    float acc = 0.0f;
    for (int i = 0; i < L; ++i) {
      acc += log_a[(row0 + i) * H + h];
      cum[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < L; i += THREADS) w[i] = expf(cum[L - 1] - cum[i]);

  // M = (C Bᵀ) ⊙ decay mask, lower-triangular 64 x 64 blocks only
  for (int ib = 0; ib < L; ib += 64) {
    for (int jb = 0; jb <= ib; jb += 64) {
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ib + ty + 16 * a, j = jb + tx + 16 * a;
          cv[a] = i < L ? cs[i * NP + n] : 0.0f;
          bv[a] = j < L ? bs[j * NP + n] : 0.0f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(cv[a], bv[q], acc[a][q]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = ib + ty + 16 * a, j = jb + tx + 16 * q;
          if (i < L && j <= i) ms[i * LP + j] = acc[a][q] * expf(cum[i] - cum[j]);
        }
    }
  }
  __syncthreads();

  // X replaces C in shared memory
  for (int e = tid; e < L * P; e += THREADS) {
    const int j = e / P, p = e % P;
    cs[j * P + p] = to_f(x[((row0 + j) * H + h) * P + p]);
  }
  __syncthreads();
  const float* xs = cs;

  // y_intra = M X: row i needs columns j <= i only
  for (int ib = 0; ib < L; ib += 64) {
    for (int pb = 0; pb < P; pb += 64) {
      float acc[4][4] = {};
      const int jend = min(L, ib + 64);
      for (int j = 0; j < jend; ++j) {
        float mv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ib + ty + 16 * a, p = pb + tx + 16 * a;
          mv[a] = i < L ? ms[i * LP + j] : 0.0f;
          xv[a] = p < P ? xs[j * P + p] : 0.0f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(mv[a], xv[q], acc[a][q]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = ib + ty + 16 * a, p = pb + tx + 16 * q;
          if (i < L && p < P) y[((row0 + i) * H + h) * P + p] = from_f<T>(acc[a][q]);
        }
    }
  }

  // state = (B ⊙ w)ᵀ X
  float* out = state + (((long long)bt * nc + chunk) * H + h) * (long long)N * P;
  for (int nb = 0; nb < N; nb += 64) {
    for (int pb = 0; pb < P; pb += 64) {
      float acc[4][4] = {};
      for (int j = 0; j < L; ++j) {
        float bv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int n = nb + ty + 16 * a, p = pb + tx + 16 * a;
          bv[a] = n < N ? bs[j * NP + n] * w[j] : 0.0f;
          xv[a] = p < P ? xs[j * P + p] : 0.0f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(bv[a], xv[q], acc[a][q]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = nb + ty + 16 * a, p = pb + tx + 16 * q;
          if (n < N && p < P) out[(long long)n * P + p] = acc[a][q];
        }
    }
  }
}

long long smem_bytes(int L, int N, int P) {
  const long long np = N + 1, first = (long long)L * (np > P ? np : P);
  return 4 * (first + (long long)L * np + (long long)L * (L + 1) + 2LL * L);
}

template <typename T>
int launch(const void* x, const void* log_a, const void* b, const void* c, int batch,
           int S, int H, int P, int N, int L, void* y, void* state, cudaStream_t st) {
  const long long smem = smem_bytes(L, N, P);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_cells<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(S / L), (unsigned)H, (unsigned)batch);
  ssd_cells<T><<<grid, THREADS, (size_t)smem, st>>>(
      (const T*)x, (const float*)log_a, (const T*)b, (const T*)c, S, H, P, N, L,
      (T*)y, (float*)state);
  return (int)cudaGetLastError();
}

}  // namespace

// x T[batch, S, H, P]; log_a f32[batch, S, H]; b, c T[batch, S, N]; T by
// `dtype` (0 float32, 1 bfloat16); L divides S.  Outputs y_intra
// T[batch, S, H, P] and the chunk states f32[batch, S / L, H, N, P].
REPRO_EXPORT int repro_ssd_chunk(const void* x, const void* log_a, const void* b,
                                 const void* c, int batch, int S, int H, int P, int N,
                                 int L, int dtype, void* y, void* state, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || L <= 0 || S % L != 0 ||
      batch > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, log_a, b, c, batch, S, H, P, N, L, y, state, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, log_a, b, c, batch, S, H, P, N, L, y, state, st);
  return (int)cudaErrorInvalidValue;
}
