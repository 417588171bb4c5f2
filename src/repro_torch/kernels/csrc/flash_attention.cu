// flash_attention: blocked online-softmax attention with grouped-query heads,
// causal and sliding-window masks and a query offset, and its backward.
//
// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), all of one type T (float32 or
// bfloat16); q-head h reads kv-head h / (Hq / Hkv).  q is cast to float32
// and multiplied by `scale` before the product; logits, the running max and
// denominator and the accumulator are float32.  Key j is visible from query
// row i (position p = i + q_offset) when j < Skv, j <= p if causal, and
// j > p - window if a window is given.
//
// Replaces the Pallas kernel `_attn_kernel` in
// src/repro/kernels/flash_attention.py (pallas_call at line 133).  The
// reference has no backward kernel (its Pallas call cannot be
// differentiated); the two backward kernels here compute the gradient of the
// same function, as XLA's autodiff of `ref.attention_xla_chunked` does.
//
// Three kernels, all in IEEE float32 FMA on the CUDA cores (no TF32, no
// tensor cores), with no atomics, so every result has one summation order
// and a training step is reproducible bit for bit:
//
//   forward  one block per (b, q-head, 64-row q block) walks the visible kv
//            blocks in order: S = Qs Kᵀ, online softmax, O += P V.  Writes
//            O (type T), optionally O in float32, and the per-row
//            log-sum-exp L = m + log l.
//   dQ       one block per (b, q-head, q block): Δ = rowsum(dO ∘ O) from
//            the float32 O (written out for the dK/dV kernel), then over
//            the kv blocks P = exp(S − L), dS = P ∘ (dO Vᵀ − Δ),
//            dQ += scale · dS K.
//   dK / dV  one block per (b, kv-head, kv block) walks the q-heads of its
//            group in order and, for each, the q blocks that see it:
//            dV += Pᵀ dO, dK += dSᵀ Qs (Qs = scale · q).  Summing the group
//            inside the block is what makes it atomic-free.
//
// Masking: a hidden entry has p = 0 exactly (its logit is −inf, never
// exponentiated against a −inf max), and a 64 x 64 tile that no row can see
// is skipped.  For every row that sees at least one key this is the
// reference's function (its −1e30 fill gives exp(−1e30 − m) = 0 once a
// visible key has set m, and alpha = 0 wipes what the fill added before).  A
// row that sees no key at all gets O = 0 here; the reference's value for it
// depends on its block size, and no model path produces such a row.
//
// Bound on an H100 SXM at the training shape (B 4, Hq 15, Hkv 5, S 4,096,
// D 64, bf16, causal): the forward's 128.9 GFLOP over the causal triangle
// take 0.130 ms at the bf16 tensor-core rate (989 TFLOP/s); its bytes
// (about 85 MB) 0.025 ms.  So the function is bound by operations.  This
// first kernel computes them in float32 FMA (67 TFLOP/s peak), with a 4 x 4
// register tile per thread fed from shared memory (two FMAs per shared
// load), so its own floor is about 15x the bound; moving the products to
// wgmma in bf16 is the redesign's work.
//
// Layout: 256 threads as 16 x 16; thread (ty, tx) owns tile rows ty + 16a
// and columns tx + 16c (a, c < 4) of a 64 x 64 logit tile, and columns
// tx + 16c (c < DC = ceil(D / 16)) of a D-wide output row.  Tiles of q, k, v
// and dO are staged in shared memory as float32 with rows padded to D + 1
// floats, so the 16 threads of a half-warp reading 16 rows at one column hit
// 16 banks.  D ≤ 128: the dK/dV kernel's six tiles take 166 KB there.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256, PS = BK + 1;
constexpr long long SMEM_MAX = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Mask {
  int causal, window, q_offset, Sq, Skv;  // window <= 0: none

  __device__ __forceinline__ bool visible(int i, int j) const {
    if (i >= Sq || j >= Skv) return false;
    const int p = i + q_offset;
    if (causal && j > p) return false;
    if (window > 0 && j <= p - window) return false;
    return true;
  }
  // can any row of the q tile at q0 see any key of the kv tile at k0?
  __device__ __forceinline__ bool tile_needed(int q0, int k0) const {
    const int first_q = q0 + q_offset, last_q = min(q0 + BQ, Sq) - 1 + q_offset;
    const int last_k = min(k0 + BK, Skv) - 1;
    if (causal && k0 > last_q) return false;
    if (window > 0 && last_k <= first_q - window) return false;
    return true;
  }
};

// rows [0, avail) of a (rows, D) tile of T → float32 shared rows of DP
// floats, multiplied by `mul`; rows past `avail` are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int avail, int D, int DP,
                                      float mul) {
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    dst[r * DP + c] = r < avail ? to_f(src[(long long)r * D + c]) * mul : 0.0f;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s[a][c] = Σ_d A[ty + 16a][d] B[tx + 16c][d] over two shared tiles
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A, const float* B,
                                         int D, int DP, int tx, int ty) {
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      av[a] = A[(ty + 16 * a) * DP + d];
      bv[a] = B[(tx + 16 * a) * DP + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = fmaf(av[a], bv[c], s[a][c]);
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, int Hq,
         int Hkv, int D, float scale, Mask mk, T* __restrict__ o, float* __restrict__ o32,
         float* __restrict__ lse) {
  extern __shared__ __align__(16) float sm[];
  const int DP = D + 1, Sq = mk.Sq, Skv = mk.Skv;
  float* qs = sm;
  float* ks = qs + BQ * DP;
  float* vs = ks + BK * DP;
  float* ps = vs + BK * DP;  // (BQ, PS)

  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long qrow0 = ((long long)b * Hq + h) * Sq + q0;
  const T* kg = k + ((long long)b * Hkv + hk) * Skv * D;
  const T* vg = v + ((long long)b * Hkv + hk) * Skv * D;
  stage(qs, q + qrow0 * D, Sq - q0, D, DP, scale);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -CUDART_INF_F;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.0f;
  }

  const int nk = (Skv + BK - 1) / BK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    if (!mk.tile_needed(q0, k0)) continue;  // the same for the whole block
    __syncthreads();  // the previous tile's reads are done
    stage(ks, kg + (long long)k0 * D, Skv - k0, D, DP, 1.0f);
    stage(vs, vg + (long long)k0 * D, Skv - k0, D, DP, 1.0f);
    __syncthreads();

    float s[4][4] = {};
    tile_dot(s, qs, ks, D, DP, tx, ty);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty + 16 * a;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!mk.visible(i, k0 + tx + 16 * c)) s[a][c] = -CUDART_INF_F;
        mx = fmaxf(mx, s[a][c]);
      }
      mx = half_warp_max(mx);  // the 16 threads of row i share a half-warp
      const float mnew = fmaxf(m[a], mx);
      float alpha = 1.0f, rs = 0.0f;
      if (mnew != -CUDART_INF_F) {
        alpha = expf(m[a] - mnew);  // 0 while m is still −inf
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] = expf(s[a][c] - mnew);  // hidden: exp(−inf) = 0
          rs += s[a][c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
      }
      rs = half_warp_sum(rs);
      l[a] = l[a] * alpha + rs;
      m[a] = mnew;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= alpha;
#pragma unroll
      for (int c = 0; c < 4; ++c) ps[(ty + 16 * a) * PS + tx + 16 * c] = s[a][c];
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = ps[(ty + 16 * a) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < D ? vs[j * DP + d] : 0.0f;
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pv[a], vv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (q0 + r >= Sq) continue;
    const long long row = qrow0 + r;
    const float den = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d >= D) continue;
      const float val = acc[a][c] / den;
      o[row * D + d] = from_f<T>(val);
      if (o32 != nullptr) o32[row * D + d] = val;
    }
    if (tx == 0) lse[row] = l[a] > 0.0f ? m[a] + logf(l[a]) : CUDART_INF_F;
  }
}

// S and dP of one (q tile, kv tile) pair → P and dS in registers
__device__ __forceinline__ void probs_and_dscores(float (&p)[4][4], float (&ds)[4][4],
                                                  const float* qs, const float* dos,
                                                  const float* ks, const float* vs,
                                                  const float* ls, const float* dl,
                                                  const Mask& mk, int q0, int k0, int D,
                                                  int DP, int tx, int ty) {
  float dp[4][4] = {};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) p[a][c] = 0.0f;
  tile_dot(p, qs, ks, D, DP, tx, ty);
  tile_dot(dp, dos, vs, D, DP, tx, ty);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool vis = mk.visible(q0 + r, k0 + tx + 16 * c);
      p[a][c] = vis ? expf(p[a][c] - ls[r]) : 0.0f;
      ds[a][c] = p[a][c] * (dp[a][c] - dl[r]);
    }
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ o32, const T* __restrict__ dout,
            const float* __restrict__ lse, int Hq, int Hkv, int D, float scale, Mask mk,
            float* __restrict__ delta, T* __restrict__ dq) {
  extern __shared__ __align__(16) float sm[];
  const int DP = D + 1, Sq = mk.Sq, Skv = mk.Skv;
  float* qs = sm;
  float* dos = qs + BQ * DP;
  float* ks = dos + BQ * DP;
  float* vs = ks + BK * DP;
  float* dss = vs + BK * DP;  // (BQ, PS)
  float* ls = dss + BQ * PS;
  float* dl = ls + BQ;

  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long qrow0 = ((long long)b * Hq + h) * Sq + q0;
  const T* kg = k + ((long long)b * Hkv + hk) * Skv * D;
  const T* vg = v + ((long long)b * Hkv + hk) * Skv * D;
  stage(qs, q + qrow0 * D, Sq - q0, D, DP, scale);
  stage(dos, dout + qrow0 * D, Sq - q0, D, DP, 1.0f);
  if (tid < BQ) {  // Δ_i = Σ_d dO_id O_id in order, from the float32 O
    float acc = 0.0f;
    if (q0 + tid < Sq) {
      const float* orow = o32 + (qrow0 + tid) * D;
      const T* drow = dout + (qrow0 + tid) * D;
      for (int d = 0; d < D; ++d) acc = fmaf(to_f(drow[d]), orow[d], acc);
      delta[qrow0 + tid] = acc;
    }
    dl[tid] = acc;
    ls[tid] = q0 + tid < Sq ? lse[qrow0 + tid] : CUDART_INF_F;
  }

  float acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.0f;

  const int nk = (Skv + BK - 1) / BK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    if (!mk.tile_needed(q0, k0)) continue;
    __syncthreads();
    stage(ks, kg + (long long)k0 * D, Skv - k0, D, DP, 1.0f);
    stage(vs, vg + (long long)k0 * D, Skv - k0, D, DP, 1.0f);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs_and_dscores(p, ds, qs, dos, ks, vs, ls, dl, mk, q0, k0, D, DP, tx, ty);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) dss[(ty + 16 * a) * PS + tx + 16 * c] = ds[a][c];
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float dv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dv[a] = dss[(ty + 16 * a) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = tx + 16 * c;
        const float kv = d < D ? ks[j * DP + d] : 0.0f;
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(dv[a], kv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (q0 + r >= Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dq[(qrow0 + r) * D + d] = from_f<T>(scale * acc[a][c]);
    }
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, int Hq, int Hkv, int D, float scale, Mask mk,
              T* __restrict__ dk, T* __restrict__ dv) {
  extern __shared__ __align__(16) float sm[];
  const int DP = D + 1, Sq = mk.Sq, Skv = mk.Skv;
  float* qs = sm;
  float* dos = qs + BQ * DP;
  float* ks = dos + BQ * DP;
  float* vs = ks + BK * DP;
  float* pss = vs + BK * DP;   // P (BQ, PS)
  float* dss = pss + BQ * PS;  // dS (BQ, PS)
  float* ls = dss + BQ * PS;
  float* dl = ls + BQ;

  const int hk = blockIdx.y, b = blockIdx.z, group = Hq / Hkv;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long krow0 = ((long long)b * Hkv + hk) * Skv + k0;
  stage(ks, k + krow0 * D, Skv - k0, D, DP, 1.0f);
  stage(vs, v + krow0 * D, Skv - k0, D, DP, 1.0f);

  float gk[4][DC], gv[4][DC];  // rows k0 + ty + 16a, columns tx + 16c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) gk[a][c] = gv[a][c] = 0.0f;

  const int nq = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qb = 0; qb < nq; ++qb) {
      const int q0 = qb * BQ;
      if (!mk.tile_needed(q0, k0)) continue;
      const long long qrow0 = ((long long)b * Hq + h) * Sq + q0;
      __syncthreads();
      stage(qs, q + qrow0 * D, Sq - q0, D, DP, scale);
      stage(dos, dout + qrow0 * D, Sq - q0, D, DP, 1.0f);
      if (tid < BQ) {
        const bool in = q0 + tid < Sq;
        ls[tid] = in ? lse[qrow0 + tid] : CUDART_INF_F;
        dl[tid] = in ? delta[qrow0 + tid] : 0.0f;
      }
      __syncthreads();
      float p[4][4], ds[4][4];
      probs_and_dscores(p, ds, qs, dos, ks, vs, ls, dl, mk, q0, k0, D, DP, tx, ty);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pss[(ty + 16 * a) * PS + tx + 16 * c] = p[a][c];
          dss[(ty + 16 * a) * PS + tx + 16 * c] = ds[a][c];
        }
      __syncthreads();
      // dV_j += Σ_i P_ij dO_i, dK_j += Σ_i dS_ij Qs_i, i in order
      for (int i = 0; i < BQ; ++i) {
        float pj[4], dj[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pj[a] = pss[i * PS + ty + 16 * a];
          dj[a] = dss[i * PS + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = tx + 16 * c;
          const float ov = d < D ? dos[i * DP + d] : 0.0f;
          const float qv = d < D ? qs[i * DP + d] : 0.0f;
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            gv[a][c] = fmaf(pj[a], ov, gv[a][c]);
            gk[a][c] = fmaf(dj[a], qv, gk[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (k0 + r >= Skv) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d >= D) continue;
      dk[(krow0 + r) * D + d] = from_f<T>(gk[a][c]);
      dv[(krow0 + r) * D + d] = from_f<T>(gv[a][c]);
    }
  }
}

long long fwd_smem(int D) { return 4LL * ((BQ + 2 * BK) * (D + 1) + BQ * PS); }
long long dq_smem(int D) { return 4LL * ((2 * BQ + 2 * BK) * (D + 1) + BQ * PS + 2 * BQ); }
long long dkdv_smem(int D) {
  return 4LL * ((2 * BQ + 2 * BK) * (D + 1) + 2 * BQ * PS + 2 * BQ);
}

template <typename K>
int prepare(K kernel, long long smem) {
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

struct Args {
  const void *q, *k, *v, *o32, *dout, *lse;
  int B, Hq, Hkv, D;
  float scale;
  Mask mk;
  void *o, *o32_out, *lse_out, *delta, *dq, *dk, *dv;
  cudaStream_t st;
};

template <typename T, int DC>
int run(int which, const Args& a) {
  int e;
  if (which == 0) {
    const long long smem = fwd_smem(a.D);
    if ((e = prepare(attn_fwd<T, DC>, smem)) != 0) return e;
    const dim3 grid((unsigned)((a.mk.Sq + BQ - 1) / BQ), (unsigned)a.Hq, (unsigned)a.B);
    attn_fwd<T, DC><<<grid, THREADS, (size_t)smem, a.st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.Hq, a.Hkv, a.D, a.scale, a.mk,
        (T*)a.o, (float*)a.o32_out, (float*)a.lse_out);
  } else if (which == 1) {
    const long long smem = dq_smem(a.D);
    if ((e = prepare(attn_bwd_dq<T, DC>, smem)) != 0) return e;
    const dim3 grid((unsigned)((a.mk.Sq + BQ - 1) / BQ), (unsigned)a.Hq, (unsigned)a.B);
    attn_bwd_dq<T, DC><<<grid, THREADS, (size_t)smem, a.st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.o32,
        (const T*)a.dout, (const float*)a.lse, a.Hq, a.Hkv, a.D, a.scale, a.mk,
        (float*)a.delta, (T*)a.dq);
  } else {
    const long long smem = dkdv_smem(a.D);
    if ((e = prepare(attn_bwd_dkdv<T, DC>, smem)) != 0) return e;
    const dim3 grid((unsigned)((a.mk.Skv + BK - 1) / BK), (unsigned)a.Hkv, (unsigned)a.B);
    attn_bwd_dkdv<T, DC><<<grid, THREADS, (size_t)smem, a.st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, a.Hq, a.Hkv, a.D, a.scale, a.mk,
        (T*)a.dk, (T*)a.dv);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int by_width(int which, const Args& a) {
  if (a.D <= 16) return run<T, 1>(which, a);
  if (a.D <= 32) return run<T, 2>(which, a);
  if (a.D <= 64) return run<T, 4>(which, a);
  return run<T, 8>(which, a);
}

int dispatch(int which, int dtype, const Args& a) {
  if (a.B <= 0 || a.Hq <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.D <= 0 || a.D > 128 ||
      a.mk.Sq <= 0 || a.mk.Skv <= 0 || a.B > 65535 || a.Hq > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return by_width<float>(which, a);
  if (dtype == 1) return by_width<__nv_bfloat16>(which, a);
  return (int)cudaErrorInvalidValue;
}

Mask make_mask(int Sq, int Skv, int causal, int window, int q_offset) {
  Mask m;
  m.causal = causal;
  m.window = window;
  m.q_offset = q_offset;
  m.Sq = Sq;
  m.Skv = Skv;
  return m;
}

}  // namespace

// Types by `dtype`: 0 float32, 1 bfloat16 (q, k, v, o, dout, dq, dk, dv);
// lse, delta and o32 are float32.  window <= 0: no window.  o32 may be null
// in the forward (no backward to follow).
REPRO_EXPORT int repro_flash_fwd(const void* q, const void* k, const void* v, int B, int Hq,
                                 int Hkv, int Sq, int Skv, int D, float scale, int causal,
                                 int window, int q_offset, int dtype, void* o, void* o32,
                                 void* lse, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.D = D; a.scale = scale;
  a.mk = make_mask(Sq, Skv, causal, window, q_offset);
  a.o = o; a.o32_out = o32; a.lse_out = lse;
  a.st = (cudaStream_t)stream;
  return dispatch(0, dtype, a);
}

// Writes delta (B, Hq, Sq) float32 and dq; run it before repro_flash_bwd_dkdv,
// which reads delta.
REPRO_EXPORT int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* o32, const void* dout, const void* lse, int B,
                                    int Hq, int Hkv, int Sq, int Skv, int D, float scale,
                                    int causal, int window, int q_offset, int dtype,
                                    void* delta, void* dq, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o32 = o32; a.dout = dout; a.lse = lse;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.D = D; a.scale = scale;
  a.mk = make_mask(Sq, Skv, causal, window, q_offset);
  a.delta = delta; a.dq = dq;
  a.st = (cudaStream_t)stream;
  return dispatch(1, dtype, a);
}

REPRO_EXPORT int repro_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                      float scale, int causal, int window, int q_offset,
                                      int dtype, void* dk, void* dv, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.D = D; a.scale = scale;
  a.mk = make_mask(Sq, Skv, causal, window, q_offset);
  a.delta = const_cast<void*>(delta); a.dk = dk; a.dv = dv;
  a.st = (cudaStream_t)stream;
  return dispatch(2, dtype, a);
}
