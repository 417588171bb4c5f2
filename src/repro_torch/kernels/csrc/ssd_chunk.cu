// ssd_chunk: the Mamba-2 SSD by chunks.  The intra-chunk pass, per (batch,
// chunk, head) cell, with chunk length L, state size N and head size P:
//
//   cum      = inclusive cumsum of log_a over the chunk           (L,)
//   M[i, j]  = (C Bᵀ)[i, j] * exp(cum_i - cum_j)  for j <= i, else 0
//   y_intra  = M X                        (L, P), written in X's type
//   state    = (B ⊙ exp(cum_{L-1} - cum))ᵀ X   (N, P), float32
//
// Replaces the Pallas kernel `_ssd_kernel` in src/repro/kernels/ssd_chunk.py
// (pallas_call at line 103).  The reference always calls it with zero
// inbound states, so the `h_in` terms are exactly 0 and are not computed.
// The inter-chunk scan and the inbound-state correction, which the
// reference runs after its pallas_call (lines 128-150, a lax.scan and an
// einsum), are a fourth kernel here, `ssd_scan`; at one-token chunks a
// fifth, `ssd_recur`, runs the whole function in one launch and no chunk
// state reaches device memory.  Both are described below the other three's
// entry points (repro_ssd_scan, repro_ssd_recur).
//
// Bound on an H100 SXM: bytes.  The function needs, per cell, C Bᵀ and M X
// over the causal triangle only (T = L (L + 1) / 2 entries, the rest is
// masked to 0) and the chunk state in full: 2 (T N + T P + N L P) flops,
// 5.27 MFLOP at L = N = 128, P = 64.  For 1,024 bf16 tokens x 80 heads that
// is 3.4 GFLOP, 3.4 µs at the bf16 tensor-core rate (989 TFLOP/s), while
// the bytes (about 43 MB) take 12.8 µs at 3.35 TB/s.
//
// Three kernels, chosen by the wrapper from type and sizes alone
// (`ssd_chunk.ssd_route`):
//
//   ssd_wgmma  bf16 with L in {64, 128}, N in {64, 128}, P <= 128 and
//            P % 8 == 0 (TMA needs 16-byte row strides), on the tensor
//            cores.  One block per (batch, chunk, group of G heads), G
//            chosen by the wrapper so that the grid fills the SMs (5 at the
//            serving shape: 8 chunks x 16 groups = 128 blocks).  Two
//            consumer warpgroups and one producer warpgroup (it hands its
//            registers to the consumers with setmaxnreg).  The producer's lane
//            0 loads C and B of the chunk once (TMA, 128-byte swizzle), then
//            each head's X through a ring of two slots, while the warp loads
//            the head's log_a and runs the cumsum into the slot in the plain
//            version's sequential order (each lane adds its L / 32 values to
//            the running sum handed on by the lane before), with w =
//            exp(cum_{L-1} - cum).  C Bᵀ is computed once per block (wgmma,
//            both operands K-major, as attention's Q Kᵀ) and stays in the
//            consumers' registers for every head: warpgroup wg holds rows
//            64 wg .. 64 wg + 63 over the column tiles j < 64 (wg + 1); the
//            tile above the diagonal is never computed.  Per head:
//            - M = C Bᵀ ⊙ exp(cum_i - cum_j) on the accumulator fragments,
//              hidden entries (j > i) set to 0 without being exponentiated;
//              M is float32, so it is written as three bf16 register A
//              operands (hi + mid + lo), and y_intra = Σ M_t X accumulates
//              in float32 (X read N-major from shared memory, as attention's
//              P V); y is rounded to bf16 once.
//            - state = Bᵀ (w ⊙ X): computed transposed, stateᵀ = (w ⊙ X)ᵀ B,
//              so that w ⊙ X is the register A operand: X is read with
//              ldmatrix.trans from its slot, scaled by w in float32 and
//              written as three bf16 terms, each a product with B read
//              N-major; the sum is float32.
//            No float32 operand is rounded to one bf16 term, and nothing
//            runs in TF32.  Why three terms, and the plain version's own
//            cumsum order and expf, where two terms of each already meet
//            check_ssd's limits (tests/test_torch_ssd.py): each layer's y
//            of the served model then differs from the plain version's in
//            about 0.01% of its entries, by one bf16 ulp, the floor that
//            summing in the tensor cores' order leaves (chip_smoke.py phase
//            4b prints it).
//   ssd_short  float32 and bf16 with L <= 16 (SHORT_MAX_L), any N and P (as
//            far as one head's staging fits in shared memory): chunks of
//            2-16 tokens, and one-token chunks when the pass runs alone
//            (ssd_chunk_scan takes ssd_recur there).  At L = 1 the pass is
//            y = (c·b) x and state = b xᵀ, one N x P float32 outer product
//            a (token, head): 32 KB at N 128, P 64, 2.6 GB a launch at the
//            1,000-token shape, so the launch is bound by its writes.  One block of 256 threads
//            per (batch, chunk, group of G heads), G chosen by the wrapper
//            (`short_heads`: about 16 blocks an SM, 27 heads at the serving
//            shape).  The block stages the chunk's B and C once, and X,
//            the cumsum (sequential, in the plain version's order) and w
//            for its heads; C Bᵀ once (one warp a visible entry, n in a
//            fixed order: each lane its n = lane + 32 k, then the shuffle
//            tree), M per head.  Its heads' states are one contiguous run
//            of G N P floats, written in whole 16-byte vectors with
//            streaming stores (`__stcs`), so a warp writes 512 contiguous
//            bytes; rows whose P is no multiple of 4, or a base off a
//            16-byte boundary, take single floats at the run's ends and
//            vectors assembled across rows in between.  Float32 FMA; at L
//            = 1, w = exp(0) = 1, so each state entry is the one rounding
//            of b_n x_p, the plain version's bit for bit.
//   ssd_cells  float32 with L > 16 and bf16 shapes outside both other
//            routes: one block of 256 threads per (batch, chunk, head)
//            cell, float32 FMA on the CUDA cores, as follows.  Reachable
//            through its own entry point, so that the other kernels can be
//            timed against it on the same inputs.
//
// ssd_cells stages C, B (rows padded to N + 1 floats against bank
// conflicts) and X in shared memory as float32; M is built there (the
// masked half never exponentiates, since exp(cum_i - cum_j) overflows for
// j > i).  Each product runs over 64 x 64 output blocks, each thread holding
// a 4 x 4 register tile (rows ty + 16a, columns tx + 16b), so one shared load
// feeds four FMAs.  Sums run over the contraction index in order; y_intra is
// rounded to X's type once, as the reference rounds it before its float32
// correction.  Its floor is its own arithmetic: 50 µs in float32 FMA at the
// serving shape, against 12.8 µs of bytes.
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------------------------------ //
// Short chunks (L <= SHORT_MAX_L), float32 FMA.                              //
// ------------------------------------------------------------------------ //

// the longest chunk ssd_short takes: on an H100 it is 2.2x under ssd_cells at
// L 16 and 1.3x over it at L 32 (PERF.md)
constexpr int SHORT_MAX_L = 16;  // == SHORT_MAX_L in ssd_chunk.py
constexpr int WARPS = THREADS / 32;

// floats of shared memory a block of ssd_short takes for G heads
// (== the formula of short_heads in ssd_chunk.py)
long long short_floats(int L, int N, int P, int G) {
  return (long long)G * L * (P + L + 2) + (long long)L * (2LL * N + L);
}

// a flat index of a block's state region as (head g, row n, column p)
struct Cursor {
  int g, n, p;
};

__device__ __forceinline__ Cursor locate(long long f, long long NP, int P) {
  const long long r = f % NP;
  return {(int)(f / NP), (int)(r / P), (int)(r % P)};
}

// moves a cursor on by the flat step `at` stands for (see `locate`):
// at.n < N and at.p < P, so each carry is at most one
__device__ __forceinline__ void advance(Cursor& c, Cursor at, int N, int P) {
  c.p += at.p;
  c.n += at.n;
  if (c.p >= P) {
    c.p -= P;
    ++c.n;
  }
  c.g += at.g;
  if (c.n >= N) {
    c.n -= N;
    ++c.g;
  }
}

// state[n, p] of head g: Σ_j (b_j[n] w_j) x_j[p] over j in order, b_j[n] w_j
// rounded first, as the plain version forms B ⊙ w before its product
__device__ __forceinline__ float state_at(const float* bs, const float* w, const float* xs,
                                          int L, int N, int P, Cursor c) {
  float s = 0.0f;
  for (int j = 0; j < L; ++j)
    s = fmaf(bs[j * N + c.n] * w[c.g * L + j], xs[(c.g * L + j) * P + c.p], s);
  return s;
}

// One block: the chunk `blockIdx.x` of sequence `blockIdx.z`, heads
// blockIdx.y * G .. + G - 1 (the last group may be smaller).  ROW4: P % 4 ==
// 0 and `state` 16-byte aligned, so every float4 of the state lies in one row.
template <typename T, bool ROW4>
__global__ void __launch_bounds__(THREADS)
ssd_short(const T* __restrict__ x, const float* __restrict__ log_a, const T* __restrict__ b,
          const T* __restrict__ c, int S, int H, int P, int N, int L, int G,
          T* __restrict__ y, float* __restrict__ state) {
  extern __shared__ __align__(16) float sm[];
  const int chunk = blockIdx.x, h0 = blockIdx.y * G, bt = blockIdx.z, nc = gridDim.x;
  const int heads = min(G, H - h0), GP = heads * P;
  const long long row0 = (long long)bt * S + (long long)chunk * L;  // (b, t) row
  float* xs = sm;                        // X of the block's heads  [g][j][p]
  float* bs = xs + (size_t)G * L * P;    // B  [j][n]
  float* cs = bs + (size_t)L * N;        // C  [i][n]
  float* cb = cs + (size_t)L * N;        // C Bᵀ  [i][j], j <= i
  float* cum = cb + (size_t)L * L;       // [g][i]
  float* w = cum + (size_t)G * L;        // exp(cum_{L-1} - cum_j)  [g][j]
  float* ms = w + (size_t)G * L;         // M  [g][i][j], j <= i
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < L * N; e += THREADS) {
    bs[e] = to_f(b[row0 * N + e]);
    cs[e] = to_f(c[row0 * N + e]);
  }
  for (int e = tid; e < L * GP; e += THREADS) {  // per token j the heads' X lie together
    const int j = e / GP, q = e - j * GP, g = q / P, p = q - g * P;
    xs[(g * L + j) * P + p] = to_f(x[((row0 + j) * H + h0) * P + q]);
  }
  for (int e = tid; e < L * heads; e += THREADS) {  // log_a, cumulated below
    const int i = e / heads, g = e - i * heads;
    cum[g * L + i] = log_a[(row0 + i) * H + h0 + g];
  }
  __syncthreads();

  for (int g = tid; g < heads; g += THREADS) {  // the cumsum in the plain version's order
    float acc = 0.0f;
    for (int i = 0; i < L; ++i) cum[g * L + i] = acc += cum[g * L + i];
    for (int j = 0; j < L; ++j) w[g * L + j] = expf(acc - cum[g * L + j]);
  }
  // C Bᵀ once for every head: one warp a visible entry, n in a fixed order
  // (each lane its n = lane + 32 k in turn, then the shuffle tree)
  for (int e = warp; e < L * L; e += WARPS) {
    const int i = e / L, j = e - i * L;
    if (j > i) continue;
    float s = 0.0f;
#pragma unroll 4
    for (int n = lane; n < N; n += 32) s = fmaf(cs[i * N + n], bs[j * N + n], s);
    s = repro::warp_reduce<repro::SumF>(s);
    if (lane == 0) cb[e] = s;
  }
  __syncthreads();
  for (int e = tid; e < heads * L * L; e += THREADS) {  // hidden entries never exponentiated
    const int g = e / (L * L), r = e - g * L * L, i = r / L, j = r - i * L;
    if (j <= i) ms[e] = cb[r] * expf(cum[g * L + i] - cum[g * L + j]);
  }
  __syncthreads();

  // y_intra = M X, rounded to T once
  for (int e = tid; e < L * GP; e += THREADS) {
    const int i = e / GP, q = e - i * GP, g = q / P, p = q - g * P;
    float acc = 0.0f;
    for (int j = 0; j <= i; ++j) acc = fmaf(ms[(g * L + i) * L + j], xs[(g * L + j) * P + p], acc);
    y[((row0 + i) * H + h0) * P + q] = from_f<T>(acc);
  }

  // the heads' states lie together: one run of heads * N * P floats, written
  // in whole 16-byte vectors with streaming stores, a warp 512 bytes at a time
  const long long NP = (long long)N * P, total = heads * NP;
  float* out = state + (((long long)bt * nc + chunk) * H + h0) * NP;
  const Cursor stride = locate(4LL * THREADS, NP, P);
  if constexpr (ROW4) {
    Cursor at = locate(4LL * tid, NP, P);
    for (long long f = 4LL * tid; f < total; f += 4 * THREADS) {
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        const float bw = bs[j * N + at.n] * w[at.g * L + j];
        const float4 xv = *reinterpret_cast<const float4*>(xs + (at.g * L + j) * P + at.p);
        s.x = fmaf(bw, xv.x, s.x);
        s.y = fmaf(bw, xv.y, s.y);
        s.z = fmaf(bw, xv.z, s.z);
        s.w = fmaf(bw, xv.w, s.w);
      }
      __stcs(reinterpret_cast<float4*>(out + f), s);
      advance(at, stride, N, P);
    }
  } else {
    // any P or alignment: single floats before the first 16-byte boundary
    // and after the last whole vector, vectors in between
    const long long lead = min(total, (long long)(((16 - ((uintptr_t)out & 15)) & 15) >> 2));
    const long long body_end = lead + ((total - lead) & ~3LL);
    const int loose = (int)(lead + total - body_end);
    for (int k = tid; k < loose; k += THREADS) {
      const long long f = k < lead ? k : body_end + (k - lead);
      __stcs(out + f, state_at(bs, w, xs, L, N, P, locate(f, NP, P)));
    }
    const Cursor one = locate(1, NP, P);
    Cursor at = locate(lead + 4LL * tid, NP, P);
    for (long long f = lead + 4LL * tid; f < body_end; f += 4 * THREADS) {
      Cursor e = at;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = state_at(bs, w, xs, L, N, P, e);
        advance(e, one, N, P);
      }
      __stcs(reinterpret_cast<float4*>(out + f), make_float4(v[0], v[1], v[2], v[3]));
      advance(at, stride, N, P);
    }
  }
}

template <typename T>
int launch_short(const void* x, const void* log_a, const void* b, const void* c, int batch,
                 int S, int H, int P, int N, int L, int G, void* y, void* state,
                 cudaStream_t st) {
  const long long smem = 4 * short_floats(L, N, P, G);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const bool row4 = P % 4 == 0 && ((uintptr_t)state & 15) == 0;
  auto kernel = row4 ? ssd_short<T, true> : ssd_short<T, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(S / L), (unsigned)((H + G - 1) / G), (unsigned)batch);
  kernel<<<grid, THREADS, (size_t)smem, st>>>((const T*)x, (const float*)log_a, (const T*)b,
                                               (const T*)c, S, H, P, N, L, G, (T*)y,
                                               (float*)state);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------ //
// The bf16 pass on Hopper's tensor cores: TMA loads, wgmma products.         //
// ------------------------------------------------------------------------ //

// two consumer warpgroups and a producer warpgroup, which keeps 40 registers
// a thread and gives the rest to the consumers (C Bᵀ takes 64 float32 of
// the second warpgroup's threads across the whole head loop)
constexpr int STHREADS = 384, PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int STAGES = 2;                   // X slots in the ring

template <int L, int N, int DP>
struct SsdShape {
  static constexpr int NT = L / 64;                  // 64-row tiles of the chunk
  static constexpr int PT = DP / 64;                 // 64-column atoms of X
  static constexpr int CB_BYTES = N / 64 * L * ATOM_ROW;  // C or B: N / 64 atoms of L rows
  static constexpr int X_BYTES = NT * PT * TILE_BYTES;    // one head's X: [row tile][atom]
  static constexpr int SMEM = 2 * CB_BYTES + STAGES * X_BYTES + 1024;  // + alignment slack
};

// M's register A operands for one 64 x 64 tile of C Bᵀ: register 2k + e of
// `cb` is row i0 + 8 (k & 1), column j0 + 8 (k >> 1) + 2 t + e.  M = C Bᵀ ⊙
// exp(cum_i - cum_j) with the plain version's expf, written as three bf16
// terms.  On the diagonal tile a hidden entry (j > i) is 0 and is not
// exponentiated.
template <bool DIAG>
__device__ __forceinline__ void decay_split(const float (&cb)[32], const float* cum, int j0,
                                            int i0, const float (&ci)[2], int t,
                                            uint32_t (&m)[3][16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int r = k & 1, col = j0 + 8 * (k >> 1) + 2 * t;
    const float2 cj = *reinterpret_cast<const float2*>(cum + col);
    float d0 = ci[r] - cj.x, d1 = ci[r] - cj.y;
    if (DIAG) {  // exp(-inf) = 0: the hidden exponent is never taken
      const int i = i0 + 8 * r;
      if (col > i) d0 = -CUDART_INF_F;
      if (col + 1 > i) d1 = -CUDART_INF_F;
    }
    split3(cb[2 * k] * expf(d0), cb[2 * k + 1] * expf(d1), m[0][k], m[1][k], m[2][k]);
  }
}

// One block: the chunk `chunk` of sequence `bt`, heads h0 .. h0 + G - 1.
// Warps 0-7 are two consumer warpgroups, warps 8-11 the producer
// warpgroup, of which warp 8 works.  X of head g
// sits in slot g % STAGES as [64-row tile][64-column atom][64][128 bytes],
// C and B as [atom][L][128 bytes], all in the 128-byte swizzle that TMA
// writes; the slot's cum and w arrays come from the producer warp.
template <int L, int N, int DP>
__global__ void __launch_bounds__(STHREADS, 1)
ssd_wgmma(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
          const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ log_a, int S,
          int H, int P, int G, __nv_bfloat16* __restrict__ y, float* __restrict__ state) {
  using W = SsdShape<L, N, DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bc_full, full[STAGES], empty[STAGES];
  __shared__ __align__(16) float cums[STAGES][L], ws[STAGES][L];
  uint8_t* base = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* cs = base;
  uint8_t* bs = cs + W::CB_BYTES;
  uint8_t* xs = bs + W::CB_BYTES;

  const int chunk = blockIdx.y, bt = blockIdx.z, nc = gridDim.y;
  const int h0 = blockIdx.x * G, heads = min(G, H - h0);
  const int row0 = bt * S + chunk * L;  // the chunk's first (b, t) row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(&bc_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA bytes, then every producer lane's cumsum
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup; warp 8 loads and scans
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp > 8) return;
    if (lane == 0) {
      mbar_expect_tx(&bc_full, 2 * W::CB_BYTES);
      for (int a = 0; a < N / 64; ++a) {
        tma_load(cs + a * L * ATOM_ROW, &tm_c, &bc_full, 64 * a, chunk * L, bt);
        tma_load(bs + a * L * ATOM_ROW, &tm_b, &bc_full, 64 * a, chunk * L, bt);
      }
    }
    constexpr int PER = L / 32;  // cumsum values a lane
    for (int g = 0; g < heads; ++g) {
      const int s = g % STAGES, h = h0 + g;
      mbar_wait(&empty[s], ((g / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], W::X_BYTES);
        for (int rt = 0; rt < W::NT; ++rt)
          for (int a = 0; a < W::PT; ++a)
            tma_load(xs + s * W::X_BYTES + (rt * W::PT + a) * TILE_BYTES, &tm_x, &full[s],
                     64 * a, h, row0 + 64 * rt);
      }
      // the cumsum in the plain version's order, c_t = c_{t-1} + a_t from 0:
      // each lane loads its PER values, then the running sum passes lane to lane
      float v[PER];
      const float* la = log_a + (long long)(row0 + lane * PER) * H + h;
#pragma unroll
      for (int k = 0; k < PER; ++k) v[k] = la[(long long)k * H];
      float run = 0.0f;
      for (int l = 0; l < 32; ++l) {
        if (lane == l) {
#pragma unroll
          for (int k = 0; k < PER; ++k) v[k] = run = run + v[k];
        }
        run = __shfl_sync(0xffffffffu, run, l);
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        cums[s][lane * PER + k] = v[k];
        ws[s][lane * PER + k] = expf(run - v[k]);
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // consumers: warp w4 of warpgroup wg; this thread's accumulator rows are
  // lq and lq + 8 of the warp's 16, its columns 2 t, 2 t + 1 of every 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2, w4 = warp & 3, t = lane & 3, lq = lane >> 2;
  const bool has_rows = 64 * wg < L;
  const int i0 = 64 * wg + 16 * w4 + lq;  // rows i0 and i0 + 8 of y and C Bᵀ
  float cb[W::NT][32];
  mbar_wait(&bc_full, 0);
  if (has_rows) {
#pragma unroll
    for (int jt = 0; jt < W::NT; ++jt) {
      if (jt > wg) continue;
      fence_regs(cb[jt]);
      wgmma_fence();
      product_ss<N>(cb[jt], cs + 64 * wg * ATOM_ROW, L * ATOM_ROW, bs + 64 * jt * ATOM_ROW,
                    L * ATOM_ROW);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(cb[jt]);
    }
  }

  constexpr int ITEMS = W::PT * (N / 64);  // 64 x 64 tiles of stateᵀ (p rows, n columns)
  for (int g = 0; g < heads; ++g) {
    const int s = g % STAGES, h = h0 + g;
    mbar_wait(&full[s], (g / STAGES) & 1);
    const uint8_t* xt = xs + s * W::X_BYTES;
    const float* cum = cums[s];
    const float* wv = ws[s];

    // y_intra = (M_hi + M_mid + M_lo) X over the visible column tiles
    if (has_rows) {
      const float ci[2] = {cum[i0], cum[i0 + 8]};
      float yacc[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) yacc[i] = 0.0f;
#pragma unroll
      for (int jt = 0; jt < W::NT; ++jt) {
        if (jt > wg) continue;
        uint32_t mt[3][16];
        if (jt == wg) decay_split<true>(cb[jt], cum, 64 * jt, i0, ci, t, mt);
        else decay_split<false>(cb[jt], cum, 64 * jt, i0, ci, t, mt);
        const uint8_t* xj = xt + jt * W::PT * TILE_BYTES;
        fence_regs(yacc);
        wgmma_fence();
#pragma unroll
        for (int term = 0; term < 3; ++term) product_rs<DP>(yacc, mt[term], xj);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(yacc);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        __nv_bfloat16* yr = y + ((long long)(row0 + i0 + 8 * r) * H + h) * P;
#pragma unroll
        for (int nb = 0; nb < DP / 8; ++nb) {
          const int p = 8 * nb + 2 * t;
          if (p < P)
            *reinterpret_cast<__nv_bfloat162*>(yr + p) =
                __floats2bfloat162_rn(yacc[4 * nb + 2 * r], yacc[4 * nb + 2 * r + 1]);
        }
      }
    }

    // stateᵀ = (w ⊙ X)ᵀ B, tile by tile: p rows pt * 64 .., n columns nt * 64 ..
    for (int item = wg; item < ITEMS; item += 2) {
      const int pt = item / (N / 64), nt = item % (N / 64);
      float sacc[32];
      state_product<L, W::PT>(sacc, xt, bs + nt * L * ATOM_ROW, wv, pt, w4, lane);
      float* out = state + (((long long)bt * nc + chunk) * H + h) * (long long)N * P;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int p = pt * 64 + 16 * w4 + lq + 8 * ((i >> 1) & 1);
        const int n = nt * 64 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (p < P) out[(long long)n * P + p] = sacc[i];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

template <int L, int N, int DP>
int run_wgmma(const void* x, const void* log_a, const void* b, const void* c, int batch, int S,
              int H, int P, int G, void* y, void* state, cudaStream_t st) {
  using W = SsdShape<L, N, DP>;
  auto kernel = ssd_wgmma<L, N, DP>;
  // a runtime call first: the encoder needs the context current in this thread
  int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM);
  if (e != 0) return e;
  CUtensorMap tx, tb, tc;
  const cuuint64_t xdims[3] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)batch * S};
  const cuuint64_t xstrides[2] = {(cuuint64_t)P * 2, (cuuint64_t)H * P * 2};
  const cuuint32_t xbox[3] = {64, 1, 64};
  const cuuint64_t bdims[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)batch};
  const cuuint64_t bstrides[2] = {(cuuint64_t)N * 2, (cuuint64_t)S * N * 2};
  const cuuint32_t bbox[3] = {64, (cuuint32_t)L, 1};
  if ((e = encode_bf16(&tx, x, xdims, xstrides, xbox)) != 0) return e;
  if ((e = encode_bf16(&tb, b, bdims, bstrides, bbox)) != 0) return e;
  if ((e = encode_bf16(&tc, c, bdims, bstrides, bbox)) != 0) return e;
  const dim3 grid((unsigned)((H + G - 1) / G), (unsigned)(S / L), (unsigned)batch);
  kernel<<<grid, STHREADS, (size_t)W::SMEM, st>>>(tx, tb, tc, (const float*)log_a, S, H, P, G,
                                                  (__nv_bfloat16*)y, (float*)state);
  return (int)cudaGetLastError();
}

template <int L, int N>
int by_width(const void* x, const void* log_a, const void* b, const void* c, int batch, int S,
             int H, int P, int G, void* y, void* state, cudaStream_t st) {
  if (P <= 64) return run_wgmma<L, N, 64>(x, log_a, b, c, batch, S, H, P, G, y, state, st);
  return run_wgmma<L, N, 128>(x, log_a, b, c, batch, S, H, P, G, y, state, st);
}


// --------------------------------------------------------------------------- //
// The inter-chunk stage: ssd_scan (h_k = D_k h_{k-1} + S_k from h = 0 and     //
// y = y_intra + exp(cum) C h_in, chunk-parallel) and ssd_recur (the whole    //
// function at one-token chunks, no chunk state).                              //
// --------------------------------------------------------------------------- //

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_PS = 64;  // P columns a block: four a thread, sixteen threads a row

// The product on the tensor cores: mma.sync m16n8k16, bf16 operands, float32
// sums.  ldsm4 loads the four 8 x 8 bf16 matrices whose rows lanes 8 m ..
// 8 m + 7 point at (A fragments of a 16 x 16 tile); ldsm4t the same
// transposed (B fragments of two 16 x 8 tiles from a [k][n] array).
__device__ __forceinline__ void ldsm4(uint32_t (&d)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&d)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v as three bf16 terms whose sum is v to about 2^-24 of |v|
__device__ __forceinline__ void split_terms(float v, __nv_bfloat16 (&t)[3]) {
  t[0] = __float2bfloat16(v);
  const float r = v - __bfloat162float(t[0]);
  t[1] = __float2bfloat16(r);
  t[2] = __float2bfloat16(r - __bfloat162float(t[1]));
}
__device__ __forceinline__ uint32_t bits2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
// two neighbouring values of y_intra or y
__device__ __forceinline__ void load_pair(const float* p, float (&v)[2]) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  v[0] = f.x, v[1] = f.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, __nv_bfloat16 (&v)[2]) {
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(p);
  v[0] = b.x, v[1] = b.y;
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The shape of a block's product: C tiles of LT rows as CT bf16 terms (one:
// bf16 values are exact; three for float32), h_in as three.  Warps (WR x
// WC of the eight) take 16 rows and NT n-tiles of 8 columns each.
template <int NJ, int LT, int CT>
struct ScanShape {
  static constexpr int WR = LT / 16, WC = LT == 16 ? 4 : 8 / WR, NT = 8 / WC;
  static constexpr int HK = 16 * NJ;           // h rows (n) a block holds: N <= HK
  static constexpr int HS = SCAN_PS + 8;       // an h_in term's row: 144 bytes, rows 4 banks apart
  static constexpr int CS = HK + 8;            // a C term's row: HK + 8 bf16
  static constexpr int H_ELEMS = 3 * HK * HS;  // h_in: [term][n][p]
  static constexpr int C_ELEMS = CT * LT * CS; // C: [term][row][n]
  // + y_intra [LT][HS] in its type, then exp(cum) [LT] in float32
  static constexpr int SMEM = 2 * (H_ELEMS + C_ELEMS) + (CT == 1 ? 2 : 4) * LT * HS + 4 * LT;
};

// One block: sequence bt, head h, columns p0 .. p0 + 63 (slab blockIdx.x %
// slabs) and chunks k0 .. k1 - 1 (segment blockIdx.x / slabs, cpb chunks a
// segment).  Thread (ty, tx) = (tid / 16, tid % 16) owns h[n, p] for n = ty
// + 16 jj (jj < NJ) and p = p0 + 4 tx + i (i < 4), in registers.  The
// first tile of C rows, y_intra and exp(cum) is copied (cp.async in
// 16-byte pieces where rows allow; otherwise loaded, and C split) while the
// thread walks chunks 0 .. k0 - 1, h = D_k h + S_k (__fmul_rn, then
// __fadd_rn), its state slab of each in registers.
// Per chunk k of the segment it writes h_in to hs as three bf16 terms and
// takes the chunk in tiles of LT rows, each staged as the first: Σ_n
// C[l, n] h_in[n, p] as the sum of the term products whose orders add up
// to at most 2 (bf16: C h_hi + C h_mid + C h_lo), each an mma.sync chain
// over n in steps of 16, and y = y_intra + exp(cum) * sum, a multiply,
// then an add.  Then h = D_k h + S_k, unless nothing needs it (a segment's
// last chunk before the sequence's end).  Places past N or P hold 0.
template <int NJ, int LT, typename T>
__global__ void __launch_bounds__(SCAN_THREADS, 2)
ssd_scan(const T* __restrict__ y_intra, const float* __restrict__ state,
         const float* __restrict__ ecum, const T* __restrict__ c, int S, int H, int P, int N,
         int L, int cpb, T* __restrict__ y, float* __restrict__ h_final) {
  constexpr int CT = sizeof(T) == 2 ? 1 : 3;
  using W = ScanShape<NJ, LT, CT>;
  constexpr int NT = W::NT, HS = W::HS, CS = W::CS;
  extern __shared__ __align__(16) __nv_bfloat16 scan_sm[];
  __nv_bfloat16* hs = scan_sm;               // h_in terms [3][HK][HS]
  __nv_bfloat16* cs = hs + W::H_ELEMS;       // C terms [CT][LT][CS], zero past N
  T* ys = reinterpret_cast<T*>(cs + W::C_ELEMS);       // y_intra [LT][HS]
  float* es = reinterpret_cast<float*>(ys + LT * HS);  // exp(cum) [LT]

  const int slabs = (P + SCAN_PS - 1) / SCAN_PS;
  const int p0 = (blockIdx.x % slabs) * SCAN_PS, seg = blockIdx.x / slabs;
  const int h = blockIdx.y, bt = blockIdx.z;
  const int nc = S / L, k0 = seg * cpb, k1 = min(nc, k0 + cpb);
  const int N16 = (N + 15) & ~15;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, pc = p0 + 4 * tx;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int wr = warp % W::WR, wc = warp / W::WR;  // this warp's 16 rows and NT n-tiles
  const bool mma_warp = warp < W::WR * W::WC;
  const long long row0 = (long long)bt * S, hp = (long long)H * P, NP = (long long)N * P;
  const bool svec = P % 4 == 0 && ((uintptr_t)state & 15) == 0;  // whole 16-byte state pieces
  const bool cvec = CT == 1 && N % 8 == 0 && ((uintptr_t)c & 15) == 0;  // C rows by cp.async
  constexpr int YV = 16 / sizeof(T);  // y_intra values a 16-byte piece holds
  const int pw = min(SCAN_PS, P - p0);  // live columns of the slab
  const bool yvec = P % YV == 0 && ((uintptr_t)y_intra & 15) == 0;  // y_intra by cp.async
  const bool ypair = P % 2 == 0 && ((uintptr_t)y % (2 * sizeof(T))) == 0;
  const float* s_mine = state + ((long long)bt * nc * H + h) * NP + (long long)ty * P + pc;

  // rows r0 .. r0 + rows - 1 of chunk k, one cp.async group: C into cs (bf16
  // rows by cp.async, else loaded and split into CT terms), the slab's
  // y_intra into ys, exp(cum) into es
  auto stage_c = [&](int k, int r0) {
    const int rows = min(LT, L - r0);
    const long long t0 = row0 + (long long)k * L + r0;
    const T* cr = c + t0 * N;
    const T* yr = y_intra + t0 * hp + (long long)h * P + p0;
    if (yvec) {
      const int q = pw / YV;
      for (int e = tid; e < rows * q; e += SCAN_THREADS) {
        const int l = e / q, v = e - l * q;
        cp_async16(ys + l * HS + YV * v, yr + l * hp + YV * v);
      }
    } else {
      for (int e = tid; e < rows * pw; e += SCAN_THREADS) {
        const int l = e / pw, p = e - l * pw;
        ys[l * HS + p] = yr[l * hp + p];
      }
    }
    if (tid < rows) cp_async4(es + tid, ecum + (t0 + tid) * H + h);
    if (cvec) {
      const int q8 = N / 8;
      for (int e = tid; e < rows * q8; e += SCAN_THREADS) {
        const int l = e / q8, q = e - l * q8;
        cp_async16(cs + l * CS + 8 * q, cr + (long long)l * N + 8 * q);
      }
    } else {
      for (int e = tid; e < rows * N; e += SCAN_THREADS) {
        const int l = e / N, n = e - l * N;
        __nv_bfloat16 tt[3];
        split_terms(to_f(cr[(long long)l * N + n]), tt);
#pragma unroll
        for (int q = 0; q < CT; ++q) cs[(q * LT + l) * CS + n] = tt[q];
      }
    }
    cp_async_commit();
  };
  for (int e = tid; e < CT * LT * (N16 - N); e += SCAN_THREADS) {  // no copy writes these
    const int r = e / (N16 - N);
    cs[r * CS + N + e % (N16 - N)] = __float2bfloat16(0.0f);
  }
  stage_c(k0, 0);

  // this thread's places of S_k
  auto load_slab = [&](int k, float4 (&v)[NJ]) {
    const float* sk = s_mine + (long long)k * H * NP;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      v[jj] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float* src = sk + (long long)(16 * jj) * P;
      if (ty + 16 * jj < N && pc < P) {
        if (svec) {
          v[jj] = *reinterpret_cast<const float4*>(src);
        } else {
          v[jj].x = src[0];
          if (pc + 1 < P) v[jj].y = src[1];
          if (pc + 2 < P) v[jj].z = src[2];
          if (pc + 3 < P) v[jj].w = src[3];
        }
      }
    }
  };
  float hr[NJ][4];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int i = 0; i < 4; ++i) hr[jj][i] = 0.0f;
  // h = D_k h + S_k: no contraction
  auto update = [&](int k, const float4 (&v)[NJ]) {
    const float d = ecum[(row0 + (long long)k * L + L - 1) * H + h];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float sa[4] = {v[jj].x, v[jj].y, v[jj].z, v[jj].w};
      if (ty + 16 * jj < N) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (pc + i < P) hr[jj][i] = __fadd_rn(__fmul_rn(d, hr[jj][i]), sa[i]);
      }
    }
  };

  // the walk to the segment's first chunk
  for (int k = 0; k < k0; ++k) {
    float4 sv[NJ];
    load_slab(k, sv);
    update(k, sv);
  }

  bool first = true;
  for (int k = k0; k < k1; ++k) {
    for (int r0 = 0; r0 < L; r0 += LT) {
      const int rows = min(LT, L - r0);
      const long long t0 = row0 + (long long)k * L + r0;
      if (!first) {
        __syncthreads();  // cs (and hs) free: every product before has ended
        stage_c(k, r0);
      }
      first = false;
      if (r0 == 0) {  // h_in as three bf16 terms, this thread's places
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          __nv_bfloat16 tt[4][3];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_terms(hr[jj][i], tt[i]);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            __nv_bfloat16* row = hs + (q * W::HK + ty + 16 * jj) * HS + 4 * tx;
            *reinterpret_cast<uint2*>(row) =
                make_uint2(bits2(tt[0][q], tt[1][q]), bits2(tt[2][q], tt[3][q]));
          }
        }
      }
      cp_async_wait<0>();  // this thread's copies of the tile have landed
      __syncthreads();     // everyone's, and h_in
      if (mma_warp && 16 * wr < rows) {
        float acc[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
        // ldmatrix rows: A (C) rows 16 wr + (lane & 15), columns + 8 (lane >> 4);
        // B (h_in) rows k + (lane & 15), columns 8 (lane >> 4) of each n-tile pair
        const __nv_bfloat16* arow = cs + (16 * wr + (lane & 15)) * CS + 8 * (lane >> 4);
        const __nv_bfloat16* brow =
            hs + (lane & 15) * HS + (SCAN_PS / W::WC) * wc + 8 * (lane >> 4);
        for (int k16 = 0; k16 < N16; k16 += 16) {
          uint32_t a[CT][4];
#pragma unroll
          for (int q = 0; q < CT; ++q) ldsm4(a[q], arow + q * LT * CS + k16);
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp) {
#pragma unroll
            for (int qh = 0; qh < 3; ++qh) {
              uint32_t bfr[4];  // b0, b1 of n-tile 2 jp, then of 2 jp + 1
              ldsm4t(bfr, brow + (qh * W::HK + k16) * HS + 16 * jp);
#pragma unroll
              for (int qc = 0; qc < CT && qc + qh <= 2; ++qc) {
                mma16816(acc[2 * jp], a[qc], bfr[0], bfr[1]);
                mma16816(acc[2 * jp + 1], a[qc], bfr[2], bfr[3]);
              }
            }
          }
        }
        // this lane's rows 16 wr + g (+ 8) and columns 64 / WC wc + 8 j + 2 t4 (+ 1)
        const int ra = 16 * wr + g, cl = (SCAN_PS / W::WC) * wc + 2 * t4;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int l = ra + 8 * rr;
          if (l < rows) {
            const long long at = (t0 + l) * hp + (long long)h * P + p0;
            const float e = es[l];
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int p = cl + 8 * j;
              T yi[2];
              load_pair(ys + l * HS + p, yi);
              const float o0 = __fadd_rn(to_f(yi[0]), __fmul_rn(e, acc[j][2 * rr]));
              const float o1 = __fadd_rn(to_f(yi[1]), __fmul_rn(e, acc[j][2 * rr + 1]));
              if (ypair && p < pw) {
                store_pair(y + at + p, o0, o1);
              } else {
                if (p < pw) y[at + p] = from_f<T>(o0);
                if (p + 1 < pw) y[at + p + 1] = from_f<T>(o1);
              }
            }
          }
        }
      }
    }
    if (k + 1 < k1 || k1 == nc) {  // h_in of the next chunk, or h_final
      float4 sv[NJ];
      load_slab(k, sv);
      update(k, sv);
    }
  }

  if (k1 == nc) {
    float* hf = h_final + ((long long)bt * H + h) * NP + (long long)ty * P + pc;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      if (ty + 16 * jj < N) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (pc + i < P) hf[(long long)(16 * jj) * P + i] = hr[jj][i];
      }
  }
}

template <int NJ, int LT, typename T>
int run_scan(const void* y_intra, const void* state, const void* ecum, const void* c, int batch,
             int S, int H, int P, int N, int L, int cpb, void* y, void* h_final,
             cudaStream_t st) {
  constexpr int smem = ScanShape<NJ, LT, sizeof(T) == 2 ? 1 : 3>::SMEM;
  static_assert(smem <= SMEM_MAX, "ssd_scan: the tiles do not fit in shared memory");
  auto kernel = ssd_scan<NJ, LT, T>;
  int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != 0) return e;
  const int slabs = (P + SCAN_PS - 1) / SCAN_PS, segs = (S / L + cpb - 1) / cpb;
  const dim3 grid((unsigned)(slabs * segs), (unsigned)H, (unsigned)batch);
  kernel<<<grid, SCAN_THREADS, smem, st>>>((const T*)y_intra, (const float*)state,
                                           (const float*)ecum, (const T*)c, S, H, P, N, L, cpb,
                                           (T*)y, (float*)h_final);
  return (int)cudaGetLastError();
}

// By state size (NJ: 8 for N <= 128, 16 for N <= 256) and chunk (tiles of
// 16 rows for chunks of at most 16, else 64: on an H100 128-row tiles were
// no faster at chunks of 128, PERF.md).
template <typename T>
int scan_by_size(const void* y_intra, const void* state, const void* ecum, const void* c,
                 int batch, int S, int H, int P, int N, int L, int cpb, void* y, void* h_final,
                 cudaStream_t st) {
#define REPRO_SCAN(NJ, LT) \
  return run_scan<NJ, LT, T>(y_intra, state, ecum, c, batch, S, H, P, N, L, cpb, y, h_final, st)
  if (N <= 128) {
    if (L <= 16) REPRO_SCAN(8, 16);
    REPRO_SCAN(8, 64);
  }
  if (L <= 16) REPRO_SCAN(16, 16);
  REPRO_SCAN(16, 64);
#undef REPRO_SCAN
}

// ------------------------------------------------------------------------- //
// ssd_recur: the whole ssd_chunk_scan at one-token chunks, one launch.       //
// ------------------------------------------------------------------------- //

constexpr int RECUR_THREADS = 128;
constexpr int RECUR_PB = 16;  // P columns a block: four a warp (== RECUR_PB in ssd_chunk.py)

// K: n places a lane holds a column, in fours (N <= 32 K).  A tile is T
// tokens, staged as float32: c and b ([T][32 K] each, zero past N), x
// ([T][16]), exp(log_a) ([T]) and c·b ([T]).  A thread loads PF values of c
// and b and XF of x for the next tile.
template <int K>
struct Recur {
  static constexpr int NS = 32 * K;
  static constexpr int T = 64 / K;
  static constexpr int PF = T * NS / RECUR_THREADS;
  static constexpr int XF = T * RECUR_PB / RECUR_THREADS;
  static constexpr int BUF = T * (2 * NS + RECUR_PB + 2);
};

// One block: sequence bt, head h, columns col0 .. col0 + 15.  Lane (j, q) =
// (lane / 4, lane % 4) of warp w owns column p = col0 + 4 w + q and holds
// h[n, p] in registers for n = 4 j + 32 k + i (k < K, i < 4), from h = 0 over
// the tokens in order:
//   s_j  = Σ_{k, i} c_t[n] h[n, p], in that order with fmaf (h = h_{t-1})
//   h    = __fadd_rn(__fmul_rn(d_t, h), __fmul_rn(b_t[n], x_t[p]))
// Each lane keeps its partial sums of 8 tokens; then three shuffle stages
// (lane offsets 16, 8, 4) add the eight groups' sums in the fixed tree
// ((s0 + s4) + (s2 + s6)) + ((s1 + s5) + (s3 + s7)) and leave token g + j's
// sum in group j, which writes y = round(round(c·b x) + e * sum).  Tiles of
// T tokens go through two shared-memory buffers, loaded into registers a
// tile ahead and stored after the walk: two barriers a tile, none a token.
// FULL: N == 32 K, no place is past N.
template <int K, bool FULL, typename T>
__global__ void __launch_bounds__(RECUR_THREADS)
ssd_recur(const T* __restrict__ x, const float* __restrict__ ecum, const T* __restrict__ b,
          const T* __restrict__ c, int S, int H, int P, int N, T* __restrict__ y,
          float* __restrict__ h_final) {
  using R = Recur<K>;
  constexpr int NS = R::NS, TT = R::T, PF = R::PF, XF = R::XF, PB = RECUR_PB;
  constexpr int WARPS_R = RECUR_THREADS / 32;
  extern __shared__ __align__(16) float rec_sm[];
  const int col0 = blockIdx.x * PB, h = blockIdx.y, bt = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = lane >> 2, wc = warp * 4 + (lane & 3), p = col0 + wc;
  const long long row0 = (long long)bt * S, hp = (long long)H * P;
  const int tiles = (S + TT - 1) / TT;

  // the next tile's inputs, loaded before the walk and stored after it
  T cv[PF], bv[PF], xv[XF];
  float ev = 1.0f;
  auto load = [&](int tile) {
    const int t0 = tile * TT;
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int s = tid + RECUR_THREADS * i, t = t0 + s / NS, n = s % NS;
      cv[i] = bv[i] = from_f<T>(0.0f);
      if (t < S && (FULL || n < N)) {
        const long long at = (row0 + t) * N + n;
        cv[i] = c[at];
        bv[i] = b[at];
      }
    }
#pragma unroll
    for (int i = 0; i < XF; ++i) {
      const int s = tid + RECUR_THREADS * i, t = t0 + s / PB, col = col0 + s % PB;
      xv[i] = from_f<T>(0.0f);
      if (t < S && col < P) xv[i] = x[(row0 + t) * hp + (long long)h * P + col];
    }
    if (tid < TT && t0 + tid < S) ev = ecum[(row0 + t0 + tid) * H + h];
  };
  auto stage = [&](int buf) {
    float* F = rec_sm + buf * R::BUF;
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      F[tid + RECUR_THREADS * i] = to_f(cv[i]);
      F[TT * NS + tid + RECUR_THREADS * i] = to_f(bv[i]);
    }
#pragma unroll
    for (int i = 0; i < XF; ++i) F[2 * TT * NS + tid + RECUR_THREADS * i] = to_f(xv[i]);
    if (tid < TT) F[2 * TT * NS + TT * PB + tid] = ev;
  };

  float hr[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) hr[k][i] = 0.0f;

  load(0);
  stage(0);
  for (int tile = 0; tile < tiles; ++tile) {
    float* F = rec_sm + (tile & 1) * R::BUF;
    const float* cs = F;
    const float* bs = F + TT * NS;
    const float* xs = F + 2 * TT * NS;
    const float* es = xs + TT * PB;
    float* cbs = F + 2 * TT * NS + TT * PB + TT;
    __syncthreads();  // this tile's buffer is complete, the other one free
    // c·b, a warp a token: lane l sums n = l + 32 k in order, then the shuffle tree
    for (int t = warp; t < TT; t += WARPS_R) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) s = fmaf(cs[t * NS + lane + 32 * k], bs[t * NS + lane + 32 * k], s);
      s = repro::warp_reduce<repro::SumF>(s);
      if (lane == 0) cbs[t] = s;
    }
    if (tile + 1 < tiles) load(tile + 1);
    __syncthreads();  // c·b visible

    const int live = min(TT, S - tile * TT);
    for (int g = 0; g < live; g += 8) {
      float part[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = g + u;
        part[u] = 0.0f;
        if (t < live) {
          const float d = es[t], xp = xs[t * PB + wc];
          float s = 0.0f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float4 c4 = *reinterpret_cast<const float4*>(cs + t * NS + 32 * k + 4 * j);
            const float4 b4 = *reinterpret_cast<const float4*>(bs + t * NS + 32 * k + 4 * j);
            const float cc[4] = {c4.x, c4.y, c4.z, c4.w}, bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              s = fmaf(cc[i], hr[k][i], s);
              const float nh = __fadd_rn(__fmul_rn(d, hr[k][i]), __fmul_rn(bb[i], xp));
              hr[k][i] = (FULL || 32 * k + 4 * j + i < N) ? nh : 0.0f;
            }
          }
          part[u] = s;
        }
      }
      // the groups' sums: each stage keeps the half of the tokens whose bit
      // matches the lane's, adding its partner's sums of them
      const bool b2 = j & 4, b1 = j & 2, b0 = j & 1;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float send = b2 ? part[u] : part[u + 4], keep = b2 ? part[u + 4] : part[u];
        part[u] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float send = b1 ? part[u] : part[u + 2], keep = b1 ? part[u + 2] : part[u];
        part[u] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
      }
      const float send = b0 ? part[0] : part[1], keep = b0 ? part[1] : part[0];
      const float sum = keep + __shfl_xor_sync(0xffffffffu, send, 4);
      const int t = g + j;
      if (t < live && p < P) {
        const float yi = to_f(from_f<T>(__fmul_rn(cbs[t], xs[t * PB + wc])));
        y[(row0 + (long long)tile * TT + t) * hp + (long long)h * P + p] =
            from_f<T>(__fadd_rn(yi, __fmul_rn(es[t], sum)));
      }
    }
    if (tile + 1 < tiles) stage((tile + 1) & 1);
  }

  if (p < P) {
    float* hf = h_final + ((long long)bt * H + h) * N * P + p;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 32 * k + 4 * j + i;
        if (FULL || n < N) hf[(long long)n * P] = hr[k][i];
      }
  }
}

template <int K, bool FULL, typename T>
int run_recur(const void* x, const void* ecum, const void* b, const void* c, int batch, int S,
              int H, int P, int N, void* y, void* h_final, cudaStream_t st) {
  const int smem = 2 * Recur<K>::BUF * 4;  // under 48 KB at every K
  const dim3 grid((unsigned)((P + RECUR_PB - 1) / RECUR_PB), (unsigned)H, (unsigned)batch);
  ssd_recur<K, FULL, T><<<grid, RECUR_THREADS, (size_t)smem, st>>>(
      (const T*)x, (const float*)ecum, (const T*)b, (const T*)c, S, H, P, N, (T*)y,
      (float*)h_final);
  return (int)cudaGetLastError();
}

template <typename T>
int recur_by_size(const void* x, const void* ecum, const void* b, const void* c, int batch,
                  int S, int H, int P, int N, void* y, void* h_final, cudaStream_t st) {
#define REPRO_RECUR(K)                                                                         \
  return N == 32 * K ? run_recur<K, true, T>(x, ecum, b, c, batch, S, H, P, N, y, h_final, st) \
                     : run_recur<K, false, T>(x, ecum, b, c, batch, S, H, P, N, y, h_final, st)
  if (N <= 32) REPRO_RECUR(1);
  if (N <= 64) REPRO_RECUR(2);
  if (N <= 128) REPRO_RECUR(4);
  REPRO_RECUR(8);
#undef REPRO_RECUR
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

// Short chunks (ssd_short): the arguments of repro_ssd_chunk for L <=
// SHORT_MAX_L, and G heads a block, 1 <= G <= H.
REPRO_EXPORT int repro_ssd_chunk_short(const void* x, const void* log_a, const void* b,
                                       const void* c, int batch, int S, int H, int P, int N,
                                       int L, int dtype, int G, void* y, void* state,
                                       void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || L <= 0 || L > SHORT_MAX_L ||
      S % L != 0 || batch > 65535 || G <= 0 || G > H || (H + G - 1) / G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_short<float>(x, log_a, b, c, batch, S, H, P, N, L, G, y, state, st);
  if (dtype == 1)
    return launch_short<__nv_bfloat16>(x, log_a, b, c, batch, S, H, P, N, L, G, y, state, st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 pass on the tensor cores (ssd_wgmma): the arguments of
// repro_ssd_chunk for bfloat16, L in {64, 128}, N in {64, 128}, P <= 128
// with P % 8 == 0, and x, b, c 16-byte aligned (TMA reads them); G heads a
// block, 1 <= G <= H.
REPRO_EXPORT int repro_ssd_chunk_wgmma(const void* x, const void* log_a, const void* b,
                                       const void* c, int batch, int S, int H, int P, int N,
                                       int L, int G, void* y, void* state, void* stream) {
  const bool aligned = (((uintptr_t)x | (uintptr_t)b | (uintptr_t)c) & 15) == 0;
  if (batch <= 0 || batch > 65535 || S <= 0 || H <= 0 || P <= 0 || P > 128 || P % 8 != 0 ||
      (L != 64 && L != 128) || (N != 64 && N != 128) || S % L != 0 || S / L > 65535 ||
      G <= 0 || G > H || (H + G - 1) / G > 65535 || !aligned)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (L == 64 && N == 64) return by_width<64, 64>(x, log_a, b, c, batch, S, H, P, G, y, state, st);
  if (L == 64) return by_width<64, 128>(x, log_a, b, c, batch, S, H, P, G, y, state, st);
  if (N == 64) return by_width<128, 64>(x, log_a, b, c, batch, S, H, P, G, y, state, st);
  return by_width<128, 128>(x, log_a, b, c, batch, S, H, P, G, y, state, st);
}

// The inter-chunk scan (ssd_scan), after the intra-chunk pass: y_intra
// T[batch, S, H, P] and the chunk states f32[batch, S / L, H, N, P] from it,
// ecum f32[batch, S, H] (exp of the inclusive cumsum of log_a within each
// chunk; a chunk's last row is its decay D) and c T[batch, S, N]; T by
// `dtype` (0 float32, 1 bfloat16).  N <= 256; a block takes `cpb` chunks of
// one sequence, head and 64 columns.  Outputs y T[batch, S, H, P] and
// h_final f32[batch, H, N, P].
//
// Replaces the code after the pallas_call of `ssd_chunk_scan` in
// src/repro/kernels/ssd_chunk.py (lines 128-150): the lax.scan h_k = D_k
// h_{k-1} + S_k (line 140) and the correction einsum.  Bound on an H100 SXM
// at chunks of 128: float32 operations (2 S H N P for C h_in, 1.34 GFLOP at
// 1,024 tokens x 80 heads x N 128 x P 64: 20 µs at 67 TFLOP/s).
//
// Design.  Once h_in of a chunk is known, its y is an independent (L x N)
// (N x P) product, so the chunks run in parallel: one block of 256 threads
// per (sequence, head, 64 columns of P, segment of cpb chunks).  A block
// first walks the chunks before its segment, h = D_k h + S_k over its
// slab, while its first tile of C arrives (the walk is nc elementwise
// steps, and every block repeats it in the same order, so every h_in has
// the same bits); then, per chunk of the segment, it writes h_in to shared
// memory as three bf16 terms and runs the product on the tensor cores
// (mma.sync m16n8k16, float32 sums), as ssd_wgmma does with its float32
// operands: C is exact in bf16 for bf16 inputs (three terms for float32),
// and only term products of orders up to 2 are taken, so the product is
// that of h_in to about 2^-24; nothing is rounded to one bf16 term, and
// nothing runs in TF32.  `ssd_chunk.scan_chunks` picks cpb: one chunk a
// block for chunks of 64 rows or more (640 blocks at the serving shape),
// else the fewest segments that give each SM a block.  h matches the
// plain version bit for bit on the card: exp(cum) comes in from the same
// torch ops, and each step is a rounded multiply, then a rounded add,
// chunk by chunk from h = 0.  The sum over N runs in 16-row steps in order,
// each the tensor core's fixed sum, so its order depends on N alone, never
// on batch or grid; no float atomics.
REPRO_EXPORT int repro_ssd_scan(const void* y_intra, const void* state, const void* ecum,
                                const void* c, int batch, int S, int H, int P, int N, int L,
                                int cpb, int dtype, void* y, void* h_final, void* stream) {
  if (batch <= 0 || batch > 65535 || S <= 0 || H <= 0 || H > 65535 || P <= 0 || N <= 0 ||
      N > 256 || L <= 0 || S % L != 0 || cpb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return scan_by_size<float>(y_intra, state, ecum, c, batch, S, H, P, N, L, cpb, y, h_final,
                               st);
  if (dtype == 1)
    return scan_by_size<__nv_bfloat16>(y_intra, state, ecum, c, batch, S, H, P, N, L, cpb, y,
                                       h_final, st);
  return (int)cudaErrorInvalidValue;
}

// The whole ssd_chunk_scan at one-token chunks (ssd_recur): x T[batch, S,
// H, P], ecum f32[batch, S, H] (exp(log_a), as chunk_decays gives it at L =
// 1), b, c T[batch, S, N]; T by `dtype` (0 float32, 1 bfloat16); N <= 256.
// Outputs y T[batch, S, H, P] and h_final f32[batch, H, N, P].
//
// Replaces, at one-token chunks, the whole of `ssd_chunk_scan` in
// src/repro/kernels/ssd_chunk.py: the pallas_call (line 103) and the scan
// after it (lines 128-150).  At L = 1 the chunk state is b xᵀ and the pair
// ssd_short + ssd_scan wrote and read it back (2.62 GB a layer at 1,000
// tokens x 80 heads x N 128 x P 64); the function itself reads x, log_a, b
// and c and writes y and h_final (about 24 MB), and does 5 S H N P float32
// operations (c·h, the update and b xᵀ): 3.3 GFLOP, 0.049 ms at 67 TFLOP/s.
// Bound: operations.
//
// Design.  For each (head, column p) the recurrence h_t[n] = d_t h_{t-1}[n]
// + b_t[n] x_t[p] is independent, and only y's sum c_t·h_{t-1} couples the
// n of one column; so a warp owns four columns of one head, eight lanes a
// column, each lane 4 K values of n in registers, and the sum over n is a
// lane's fmaf chain, then a fixed shuffle tree over the eight lanes, taken
// for eight tokens at once (stages of 4, 2 and 1 shuffles).  No barrier a
// token: a block of four warps (16 columns: 320 blocks at the serving
// shape, over all 132 SMs) stages tiles of T tokens of c, b, x and
// exp(log_a) as float32 through two buffers, loaded a tile ahead, with c·b
// of each token reduced once a block.  y rounds where the plain version
// rounds: y_intra = round((c·b) x) to x's type, then y = round(y_intra + e
// (c·h)).  h_final equals the plain version's bit for bit: each step is
// the plain loop's round(round(d h) + round(b x)), d from the same torch
// expression.  No float atomics; the sums' orders depend on N alone.
REPRO_EXPORT int repro_ssd_recur(const void* x, const void* ecum, const void* b, const void* c,
                                 int batch, int S, int H, int P, int N, int dtype, void* y,
                                 void* h_final, void* stream) {
  if (batch <= 0 || batch > 65535 || S <= 0 || H <= 0 || H > 65535 || P <= 0 || N <= 0 ||
      N > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return recur_by_size<float>(x, ecum, b, c, batch, S, H, P, N, y, h_final, st);
  if (dtype == 1)
    return recur_by_size<__nv_bfloat16>(x, ecum, b, c, batch, S, H, P, N, y, h_final, st);
  return (int)cudaErrorInvalidValue;
}
