// ssd_bwd: the gradient of the Mamba-2 SSD by chunks (ssd_chunk.cu's
// forward).  Per sequence b, head h and chunk k of L tokens, with cum the
// inclusive cumsum of log_a in the chunk, e_i = exp(cum_i), w_j =
// exp(cum_{L-1} - cum_j), D_k = exp(cum_{L-1}), M_ij = (c_i·b_j)
// exp(cum_i - cum_j) for j <= i, S_k = Σ_j w_j b_j x_jᵀ, h_in_0 = 0 and
// h_in_{k+1} = D_k h_in_k + S_k, and given dy and dh_final:
//
//   Q_k    = Σ_i e_i c_i dy_iᵀ                         (N, P)
//   g      : g_{nc-1} = dh_final, g_{k-1} = Q_k + D_k g_k   (the gradient
//            of the state after chunk k)
//   dx_j   = Σ_{i>=j} M_ij dy_i + w_j g_kᵀ b_j
//   Z_ij   = exp(cum_i - cum_j)(dy_i·x_j),  A_ij = (c_i·b_j) Z_ij  (j <= i)
//   db_j   = Σ_h [Σ_{i>=j} Z_ij c_i + w_j g_k x_j]
//   dc_i   = Σ_h [Σ_{j<=i} Z_ij b_j + e_i h_in_k dy_i]
//   dcum_i = Σ_j A_ij - Σ_j A_ji + e_i c_i·(h_in_k dy_i) - w_i b_i·(g_k x_i)
//            (+ Σ_j w_j b_j·(g_k x_j) + D_k ⟨g_k, h_in_k⟩ at i = L - 1)
//   dlog_a = the reverse cumsum of dcum in the chunk
//
// (ssd_chunk.py's ssd_chunk_scan_bwd_plain writes the same in torch ops.)
// Replaces no TPU kernel: the reference differentiates ref.ssd_xla_chunked
// with XLA (src/repro/kernels/ops.py:119-123, ref.py:241-285); the Pallas
// kernel it stands beside (src/repro/kernels/ssd_chunk.py:103) has no
// backward.  Three kernels, launched in this order by
// ssd_chunk.ssd_chunk_scan_bwd:
//
//   ssd_bwd_state  one block per (64 x 64 tile of the N x P state, head,
//                  sequence).  It walks the chunks forward to each h_in_k
//                  (S_k computed in the block, K = L), then backward to
//                  each g_k (Q_k likewise), the tile in registers, and
//                  writes h_in and g, (batch, nc, H, N, P) float32 each.
//   ssd_bwd_chunk  one block per (chunk, head, sequence): C Bᵀ and dY Xᵀ
//                  over the causal triangle into shared memory, M and Z
//                  from them, then dx, dcum and dlog_a, and the head's own
//                  terms of db and dc into float32 scratch (batch, nc, H,
//                  L, N).
//   ssd_bwd_sum    db and dc: each (token, n) sums its heads' terms in head
//                  order and rounds once to b's type.
//
// The per-head scratch buys parallelism: a block per (sequence, chunk) that
// walked its heads would give 32 blocks at the training shape (1 x 4,096
// tokens, chunk 128) for 132 SMs; a block per head gives 2,560.
//
// Every product is IEEE float32 FMA on the CUDA cores (never TF32), summed
// over its contraction index in increasing order; every other sum (the
// partial dot products of dcum, ⟨g, h_in⟩, the heads' sum) has one fixed
// order.  No atomics: two runs give the same bits.  Shapes: L <= 128 (the
// chunk kernel keeps two L x L matrices in shared memory), N <= 256, P <=
// 128; float32 and bf16.
//
// Bound on an H100 SXM at the training shape (1 x 4,096 x 80 x 64, N 128,
// L 128, bf16): operations (launch/roofline.py:ssd_bwd_work): the gradient
// needs about 43.5 GFLOP of float32 work, 0.65 ms at 67 TFLOP/s, against
// about 1.2 GB of bytes, scratch included (0.37 ms at 3.35 TB/s).  The
// design is the simple one: each product stages 32-deep slices of its
// operands in shared memory and each thread keeps a 4 x 4 tile of the
// output in registers; C Bᵀ is recomputed for every head (5.3 GFLOP more
// at that shape than the bound counts).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;       // output tile: 64 x 64, 4 x 4 a thread
constexpr int KS = 32;         // depth of a staged slice
constexpr int SP = TILE + 1;   // a staged slice's row: odd, so no bank conflicts
constexpr int MAX_L = 128;
constexpr int MAX_N = 256;
constexpr int MAX_P = 128;
constexpr long long SMEM_MAX = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// acc[a][q] += Σ_{k0 <= k < k1} A(r0 + ty + 16 a, k) · B(c0 + tx + 16 q, k), k
// in increasing order, where thread (ty, tx) = (tid / 16, tid % 16); A and B
// return 0 outside their matrices.  Each slice of KS values of k is staged
// in sa and sb ([KS][SP] floats each).  KA (KB): A's (B's) neighbouring k
// are neighbours in memory, so the staging threads walk k; otherwise they
// walk the rows.  Called by every thread of the block.
template <bool KA, bool KB, class FA, class FB>
__device__ __forceinline__ void product(float (&acc)[4][4], FA A, FB B, int r0, int c0, int k0,
                                        int k1, float* sa, float* sb) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int kb = k0; kb < k1; kb += KS) {
    const int kn = min(KS, k1 - kb);
    for (int e = tid; e < TILE * KS; e += THREADS) {
      const int ra = KA ? e / KS : e % TILE, ka = KA ? e % KS : e / TILE;
      sa[ka * SP + ra] = ka < kn ? A(r0 + ra, kb + ka) : 0.0f;
      const int rb = KB ? e / KS : e % TILE, kq = KB ? e % KS : e / TILE;
      sb[kq * SP + rb] = kq < kn ? B(c0 + rb, kb + kq) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        av[a] = sa[k * SP + ty + 16 * a];
        bv[a] = sb[k * SP + tx + 16 * a];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(av[a], bv[q], acc[a][q]);
    }
    __syncthreads();
  }
}

// cum[0 .. L-1] = the inclusive cumsum of log_a over rows t0 .. t0 + L - 1
// of head h, summed in order by one thread (as the forward's kernels do).
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ log_a, long long t0,
                                             int H, int h, int L, float* cum) {
  __syncthreads();  // the last readers of cum are done
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int i = 0; i < L; ++i) {
      acc += log_a[(t0 + i) * H + h];
      cum[i] = acc;
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------------------ //
// ssd_bwd_state: h_in and g, one 64 x 64 tile of the state a block.          //
// ------------------------------------------------------------------------ //

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_state(const T* __restrict__ x, const float* __restrict__ log_a,
              const T* __restrict__ b, const T* __restrict__ c, const T* __restrict__ dy,
              const float* __restrict__ dh, int S, int H, int P, int N, int L,
              float* __restrict__ hin, float* __restrict__ gout) {
  extern __shared__ __align__(16) float st_sm[];
  float* sa = st_sm;             // [KS][SP]
  float* sb = sa + KS * SP;      // [KS][SP]
  float* cum = sb + KS * SP;     // [L]
  float* wt = cum + L;           // w (forward walk) or e (backward walk), [L]

  const int tilesP = (P + TILE - 1) / TILE;
  const int n0 = (blockIdx.x / tilesP) * TILE, p0 = (blockIdx.x % tilesP) * TILE;
  const int h = blockIdx.y, bt = blockIdx.z, nc = S / L;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)bt * S, NP = (long long)N * P;
  const long long hp = (long long)H * P;
  auto at = [&](int k) { return (((long long)bt * nc + k) * H + h) * NP; };

  // forward: h_in_0 = 0, h_in_{k+1} = D_k h_in_k + S_k
  float hv[4][4] = {};
  for (int k = 0; k < nc; ++k) {
    float* out = hin + at(k);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + ty + 16 * a, p = p0 + tx + 16 * q;
        if (n < N && p < P) out[(long long)n * P + p] = hv[a][q];
      }
    if (k == nc - 1) break;
    const long long t0 = row0 + (long long)k * L;
    chunk_cumsum(log_a, t0, H, h, L, cum);
    for (int i = tid; i < L; i += THREADS) wt[i] = expf(cum[L - 1] - cum[i]);
    __syncthreads();
    float s[4][4] = {};
    product<false, false>(
        s,
        [&](int n, int j) { return n < N ? wt[j] * to_f(b[(t0 + j) * N + n]) : 0.0f; },
        [&](int p, int j) { return p < P ? to_f(x[(t0 + j) * hp + (long long)h * P + p]) : 0.0f; },
        n0, p0, 0, L, sa, sb);
    const float d = expf(cum[L - 1]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) hv[a][q] = __fadd_rn(__fmul_rn(d, hv[a][q]), s[a][q]);
  }

  // backward: g_{nc-1} = dh_final, g_{k-1} = Q_k + D_k g_k
  float gv[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + ty + 16 * a, p = p0 + tx + 16 * q;
      gv[a][q] = dh != nullptr && n < N && p < P
                     ? dh[((long long)bt * H + h) * NP + (long long)n * P + p] : 0.0f;
    }
  for (int k = nc - 1; k >= 0; --k) {
    float* out = gout + at(k);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + ty + 16 * a, p = p0 + tx + 16 * q;
        if (n < N && p < P) out[(long long)n * P + p] = gv[a][q];
      }
    if (k == 0) break;
    const long long t0 = row0 + (long long)k * L;
    chunk_cumsum(log_a, t0, H, h, L, cum);
    for (int i = tid; i < L; i += THREADS) wt[i] = expf(cum[i]);
    __syncthreads();
    float qv[4][4] = {};
    product<false, false>(
        qv,
        [&](int n, int i) { return n < N ? wt[i] * to_f(c[(t0 + i) * N + n]) : 0.0f; },
        [&](int p, int i) { return p < P ? to_f(dy[(t0 + i) * hp + (long long)h * P + p]) : 0.0f; },
        n0, p0, 0, L, sa, sb);
    const float d = wt[L - 1];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) gv[a][q] = __fadd_rn(qv[a][q], __fmul_rn(d, gv[a][q]));
  }
}

// ------------------------------------------------------------------------ //
// ssd_bwd_chunk: dx, dlog_a and the head's terms of db and dc, a block per  //
// (chunk, head, sequence).                                                   //
// ------------------------------------------------------------------------ //

// the chunk kernel's shared memory in floats: the slices, M and Z (L x (L +
// 1) each), cum, e, w, the row and column sums of A, dcum, and the partial
// dot products of dcum's state and inbound terms ([L][16] each), and the
// block reduction's scratch
long long chunk_smem_floats(int L) {
  return 2LL * KS * SP + 2LL * L * (L + 1) + 6LL * L + 2LL * L * 16 + 32;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk(const T* __restrict__ x, const float* __restrict__ log_a,
              const T* __restrict__ b, const T* __restrict__ c, const T* __restrict__ dy,
              const float* __restrict__ hin, const float* __restrict__ gin, int S, int H, int P,
              int N, int L, T* __restrict__ dx, float* __restrict__ dla,
              float* __restrict__ dbp, float* __restrict__ dcp) {
  extern __shared__ __align__(16) float ch_sm[];
  const int LP = L + 1;
  float* sa = ch_sm;                       // [KS][SP]
  float* sb = sa + KS * SP;                // [KS][SP]
  float* m = sb + KS * SP;                 // C Bᵀ, then M        [L][L + 1]
  float* z = m + (size_t)L * LP;           // dY Xᵀ, then Z       [L][L + 1]
  float* cum = z + (size_t)L * LP;         // [L]
  float* ev = cum + L;                     // e = exp(cum)
  float* wv = ev + L;                      // w = exp(cum_{L-1} - cum)
  float* rowa = wv + L;                    // Σ_j A_ij
  float* cola = rowa + L;                  // Σ_i A_ij
  float* dcum = cola + L;                  // [L]
  float* part_s = dcum + L;                // Σ_p x_jp (g_kᵀ b_j)_p partials   [L][16]
  float* part_i = part_s + (size_t)L * 16; // Σ_n c_in (h_in dy_i)_n partials  [L][16]
  float* red = part_i + (size_t)L * 16;    // [32]

  const int k = blockIdx.x, h = blockIdx.y, bt = blockIdx.z, nc = S / L;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long t0 = (long long)bt * S + (long long)k * L, hp = (long long)H * P;
  const long long NP = (long long)N * P;
  const float* hk = hin + (((long long)bt * nc + k) * H + h) * NP;
  const float* gk = gin + (((long long)bt * nc + k) * H + h) * NP;
  const T* xh = x + t0 * hp + (long long)h * P;    // row i at xh[i * hp]
  const T* dyh = dy + t0 * hp + (long long)h * P;
  const T* bk = b + t0 * N;                          // row j at bk[j * N]
  const T* ck = c + t0 * N;

  chunk_cumsum(log_a, t0, H, h, L, cum);
  for (int i = tid; i < L; i += THREADS) {
    ev[i] = expf(cum[i]);
    wv[i] = expf(cum[L - 1] - cum[i]);
  }

  // C Bᵀ into m and dY Xᵀ into z, the lower-triangular 64 x 64 tiles
  for (int ib = 0; ib < L; ib += TILE)
    for (int jb = 0; jb <= ib; jb += TILE) {
      float acc[4][4] = {};
      product<true, true>(
          acc, [&](int i, int n) { return i < L && n < N ? to_f(ck[(long long)i * N + n]) : 0.0f; },
          [&](int j, int n) { return j < L && n < N ? to_f(bk[(long long)j * N + n]) : 0.0f; },
          ib, jb, 0, N, sa, sb);
      float acc2[4][4] = {};
      product<true, true>(
          acc2, [&](int i, int p) { return i < L && p < P ? to_f(dyh[i * hp + p]) : 0.0f; },
          [&](int j, int p) { return j < L && p < P ? to_f(xh[j * hp + p]) : 0.0f; },
          ib, jb, 0, P, sa, sb);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = ib + ty + 16 * a, j = jb + tx + 16 * q;
          if (i < L && j < L) {
            m[i * LP + j] = acc[a][q];
            z[i * LP + j] = acc2[a][q];
          }
        }
    }
  __syncthreads();

  // column sums of A (rows i >= j in order), before M and Z replace C Bᵀ and dY Xᵀ
  for (int j = tid; j < L; j += THREADS) {
    float s = 0.0f;
    for (int i = j; i < L; ++i) s += (m[i * LP + j] * expf(cum[i] - cum[j])) * z[i * LP + j];
    cola[j] = s;
  }
  __syncthreads();
  // row sums of A (columns j <= i in order); M = C Bᵀ ∘ E and Z = dY Xᵀ ∘ E,
  // 0 above the diagonal (never exponentiated there)
  for (int i = tid; i < L; i += THREADS) {
    float s = 0.0f;
    for (int j = 0; j < L; ++j) {
      if (j <= i) {
        const float ed = expf(cum[i] - cum[j]);
        const float mm = m[i * LP + j] * ed, dd = z[i * LP + j];
        s += mm * dd;
        m[i * LP + j] = mm;
        z[i * LP + j] = dd * ed;
      } else {
        m[i * LP + j] = 0.0f;
        z[i * LP + j] = 0.0f;
      }
    }
    rowa[i] = s;
  }
  __syncthreads();

  // dx_j = Σ_{i>=j} M_ij dy_i + w_j (g_kᵀ b_j); the state term's Σ_p x_jp (g_kᵀ b_j)_p
  for (int jb = 0; jb < L; jb += TILE)
    for (int pb = 0; pb < P; pb += TILE) {
      float acc[4][4] = {}, bg[4][4] = {};
      product<true, false>(
          acc, [&](int j, int i) { return j < L ? m[i * LP + j] : 0.0f; },
          [&](int p, int i) { return p < P ? to_f(dyh[i * hp + p]) : 0.0f; }, jb, pb, jb, L,
          sa, sb);
      product<true, false>(
          bg, [&](int j, int n) { return j < L ? to_f(bk[(long long)j * N + n]) : 0.0f; },
          [&](int p, int n) { return p < P ? gk[(long long)n * P + p] : 0.0f; }, jb, pb, 0, N,
          sa, sb);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = jb + ty + 16 * a;
        if (j >= L) continue;
        float part = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = pb + tx + 16 * q;
          if (p < P) {
            const float xv = to_f(xh[j * hp + p]);
            dx[(t0 + j) * hp + (long long)h * P + p] = from_f<T>(acc[a][q] + wv[j] * bg[a][q]);
            part = fmaf(xv, bg[a][q], part);
          }
        }
        part_s[j * 16 + tx] = pb == 0 ? part : part_s[j * 16 + tx] + part;
      }
    }

  // the head's db_j = Σ_{i>=j} Z_ij c_i + w_j (g_k x_j)
  float* dbh = dbp + (((long long)bt * nc + k) * H + h) * (long long)L * N;
  for (int jb = 0; jb < L; jb += TILE)
    for (int nb = 0; nb < N; nb += TILE) {
      float acc[4][4] = {}, gx[4][4] = {};
      product<true, false>(
          acc, [&](int j, int i) { return j < L ? z[i * LP + j] : 0.0f; },
          [&](int n, int i) { return n < N ? to_f(ck[(long long)i * N + n]) : 0.0f; }, jb, nb,
          jb, L, sa, sb);
      product<true, true>(
          gx, [&](int j, int p) { return j < L ? to_f(xh[j * hp + p]) : 0.0f; },
          [&](int n, int p) { return n < N ? gk[(long long)n * P + p] : 0.0f; }, jb, nb, 0, P,
          sa, sb);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = jb + ty + 16 * a, n = nb + tx + 16 * q;
          if (j < L && n < N) dbh[(long long)j * N + n] = acc[a][q] + wv[j] * gx[a][q];
        }
    }

  // the head's dc_i = Σ_{j<=i} Z_ij b_j + e_i (h_in dy_i); the inbound
  // term's Σ_n c_in (h_in dy_i)_n
  float* dch = dcp + (((long long)bt * nc + k) * H + h) * (long long)L * N;
  for (int ib = 0; ib < L; ib += TILE)
    for (int nb = 0; nb < N; nb += TILE) {
      float acc[4][4] = {}, hd[4][4] = {};
      product<false, false>(
          acc, [&](int i, int j) { return i < L ? z[i * LP + j] : 0.0f; },
          [&](int n, int j) { return n < N ? to_f(bk[(long long)j * N + n]) : 0.0f; }, ib, nb,
          0, min(L, ib + TILE), sa, sb);
      product<true, true>(
          hd, [&](int i, int p) { return i < L ? to_f(dyh[i * hp + p]) : 0.0f; },
          [&](int n, int p) { return n < N ? hk[(long long)n * P + p] : 0.0f; }, ib, nb, 0, P,
          sa, sb);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ib + ty + 16 * a;
        if (i >= L) continue;
        float part = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = nb + tx + 16 * q;
          if (n < N) {
            dch[(long long)i * N + n] = acc[a][q] + ev[i] * hd[a][q];
            part = fmaf(to_f(ck[(long long)i * N + n]), hd[a][q], part);
          }
        }
        part_i[i * 16 + tx] = nb == 0 ? part : part_i[i * 16 + tx] + part;
      }
    }

  // ⟨g_k, h_in_k⟩: each thread its entries in order, then a fixed tree
  float gh = 0.0f;
  for (long long e = tid; e < NP; e += THREADS) gh = fmaf(gk[e], hk[e], gh);
  gh = repro::block_reduce<repro::SumF>(gh, red);  // its syncs order the partials too

  for (int i = tid; i < L; i += THREADS) {
    float ps = 0.0f, pi = 0.0f;
    for (int t = 0; t < 16; ++t) {
      ps += part_s[i * 16 + t];
      pi += part_i[i * 16 + t];
    }
    const float sv = wv[i] * ps;
    part_s[i * 16] = sv;  // w_i b_i·(g_k x_i), summed below
    dcum[i] = rowa[i] - cola[i] + ev[i] * pi - sv;
  }
  __syncthreads();
  if (tid == 0) {
    float last = 0.0f;
    for (int j = 0; j < L; ++j) last += part_s[j * 16];
    dcum[L - 1] += last + ev[L - 1] * gh;
    float acc = 0.0f;
    for (int i = L - 1; i >= 0; --i) {
      acc += dcum[i];
      dla[(t0 + i) * H + h] = acc;
    }
  }
}

// ------------------------------------------------------------------------ //
// ssd_bwd_sum: db and dc, the heads' terms summed in head order.             //
// ------------------------------------------------------------------------ //

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_sum(const float* __restrict__ dbp, const float* __restrict__ dcp, int batch, int S,
            int H, int N, int L, T* __restrict__ db, T* __restrict__ dc) {
  const long long total = (long long)batch * S * N, LN = (long long)L * N;
  const int nc = S / L;
  for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    const long long bt = e / ((long long)S * N), r = e % ((long long)S * N);
    const int t = (int)(r / N), n = (int)(r % N), k = t / L, j = t % L;
    const long long base = ((bt * nc + k) * H) * LN + (long long)j * N + n;
    float sb = 0.0f, sc = 0.0f;
    for (int h = 0; h < H; ++h) {
      sb += dbp[base + h * LN];
      sc += dcp[base + h * LN];
    }
    db[e] = from_f<T>(sb);
    dc[e] = from_f<T>(sc);
  }
}

bool bad_shape(int batch, int S, int H, int P, int N, int L) {
  return batch <= 0 || batch > 65535 || S <= 0 || H <= 0 || H > 65535 || P <= 0 ||
         P > MAX_P || N <= 0 || N > MAX_N || L <= 0 || L > MAX_L || S % L != 0;
}

template <typename T>
int launch_state(const void* x, const void* log_a, const void* b, const void* c, const void* dy,
                 const void* dh, int batch, int S, int H, int P, int N, int L, void* hin,
                 void* g, cudaStream_t st) {
  const long long smem = 4LL * (2 * KS * SP + 2 * L);
  const dim3 grid((unsigned)(((N + TILE - 1) / TILE) * ((P + TILE - 1) / TILE)), (unsigned)H,
                  (unsigned)batch);
  ssd_bwd_state<T><<<grid, THREADS, (size_t)smem, st>>>(
      (const T*)x, (const float*)log_a, (const T*)b, (const T*)c, (const T*)dy,
      (const float*)dh, S, H, P, N, L, (float*)hin, (float*)g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chunk(const void* x, const void* log_a, const void* b, const void* c, const void* dy,
                 const void* hin, const void* g, int batch, int S, int H, int P, int N, int L,
                 void* dx, void* dla, void* dbp, void* dcp, cudaStream_t st) {
  const long long smem = 4 * chunk_smem_floats(L);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_chunk<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(S / L), (unsigned)H, (unsigned)batch);
  ssd_bwd_chunk<T><<<grid, THREADS, (size_t)smem, st>>>(
      (const T*)x, (const float*)log_a, (const T*)b, (const T*)c, (const T*)dy,
      (const float*)hin, (const float*)g, S, H, P, N, L, (T*)dx, (float*)dla, (float*)dbp,
      (float*)dcp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sum(const void* dbp, const void* dcp, int batch, int S, int H, int N, int L, void* db,
               void* dc, cudaStream_t st) {
  const long long total = (long long)batch * S * N;
  const long long blocks = (total + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(blocks < 65536 ? blocks : 65536);
  ssd_bwd_sum<T><<<grid, THREADS, 0, st>>>((const float*)dbp, (const float*)dcp, batch, S, H,
                                           N, L, (T*)db, (T*)dc);
  return (int)cudaGetLastError();
}

}  // namespace

// h_in and g (batch, S / L, H, N, P) float32 from x, log_a, b, c, dy (types
// by dtype: 0 float32, 1 bf16; log_a float32) and dh_final (float32, or
// null for zero).
REPRO_EXPORT int repro_ssd_bwd_state(const void* x, const void* log_a, const void* b,
                                     const void* c, const void* dy, const void* dh, int batch,
                                     int S, int H, int P, int N, int L, int dtype, void* hin,
                                     void* g, void* stream) {
  if (bad_shape(batch, S, H, P, N, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_state<float>(x, log_a, b, c, dy, dh, batch, S, H, P, N, L, hin, g, st);
  if (dtype == 1)
    return launch_state<__nv_bfloat16>(x, log_a, b, c, dy, dh, batch, S, H, P, N, L, hin, g,
                                       st);
  return (int)cudaErrorInvalidValue;
}

// dx (x's type), dlog_a (float32) and the heads' terms of db and dc (batch,
// S / L, H, L, N) float32, from the inputs and ssd_bwd_state's h_in and g.
REPRO_EXPORT int repro_ssd_bwd_chunk(const void* x, const void* log_a, const void* b,
                                     const void* c, const void* dy, const void* hin,
                                     const void* g, int batch, int S, int H, int P, int N,
                                     int L, int dtype, void* dx, void* dla, void* dbp, void* dcp,
                                     void* stream) {
  if (bad_shape(batch, S, H, P, N, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_chunk<float>(x, log_a, b, c, dy, hin, g, batch, S, H, P, N, L, dx, dla, dbp,
                               dcp, st);
  if (dtype == 1)
    return launch_chunk<__nv_bfloat16>(x, log_a, b, c, dy, hin, g, batch, S, H, P, N, L, dx,
                                       dla, dbp, dcp, st);
  return (int)cudaErrorInvalidValue;
}

// db and dc in b's type: ssd_bwd_chunk's terms summed over the heads.
REPRO_EXPORT int repro_ssd_bwd_sum(const void* dbp, const void* dcp, int batch, int S, int H,
                                   int N, int L, int dtype, void* db, void* dc, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || N <= 0 || L <= 0 || S % L != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_sum<float>(dbp, dcp, batch, S, H, N, L, db, dc, st);
  if (dtype == 1) return launch_sum<__nv_bfloat16>(dbp, dcp, batch, S, H, N, L, db, dc, st);
  return (int)cudaErrorInvalidValue;
}
