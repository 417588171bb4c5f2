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
// backward.  Three launches, in this order, by ssd_chunk.ssd_chunk_scan_bwd:
// a state kernel (h_in and g, (batch, nc, H, N, P) float32 each), a chunk
// kernel (dx, dcum and dlog_a, and each head's own terms of db and dc into
// float32 scratch (batch, nc, H, L, N)) and ssd_bwd_sum (db and dc: each
// (token, n) sums its heads' terms in head order and rounds once to b's
// type).  The per-head scratch buys parallelism: b and c are shared by the
// heads, and a block per (sequence, chunk) that summed them would give 32
// blocks at the training shape (1 x 4,096 tokens, chunk 128).  The state
// and chunk kernels have two routes, chosen by the wrapper from type and
// sizes alone (ssd_chunk.bwd_route, the forward's ssd_route rule):
//
//   wgmma  bf16 with L and N in {64, 128}, P <= 128 and P % 8 == 0 (TMA
//          needs 16-byte rows; the wrapper checks x, b, c and dy start on
//          16-byte boundaries).  Every product on the tensor cores (wgmma,
//          bf16 operands, float32 sums, nothing in TF32); a float32 operand
//          (M, Z, g, h_in, w ⊙ X, e ⊙ dY) is a register A operand of three
//          bf16 terms (split3), so only bf16 tiles, as TMA writes them,
//          sit in shared memory.
//     ssd_bwd_state_wgmma  one block per (64 columns of N, head, sequence):
//          one consumer warpgroup per 64 rows of P and a producer warp that
//          loads each step's chunk (X and B's 64 columns forward, dY and C
//          back) through a ring of slots by TMA and runs the cumsum in the
//          plain order (lanes pass the running sum), with expf for w, e and
//          D_k.  The warpgroup holds hᵀ (then gᵀ) in wgmma accumulators and
//          per chunk computes S_kᵀ = (w ⊙ X)ᵀ B (then Q_kᵀ = (e ⊙ dY)ᵀ C),
//          the forward's state product, and h ← fmul(D, h) + S (g ← Q +
//          fmul(D, g)).  160 blocks at the training launch, all resident.
//     ssd_bwd_chunk_wgmma  one block per (chunk, group of G heads, sequence),
//          G from ssd_chunk.heads_per_block (20 at the training launch: 128
//          blocks on 132 SMs).  Two consumer warpgroups, warpgroup w the
//          chunk's rows 64 w .. 64 w + 63, as j (dx, db, A's column sums)
//          and as i (dc); a producer warpgroup whose warp 8 loads C and B
//          once and each head's X and dY through a ring of two slots (one
//          where shared memory allows no more) and runs the cumsum, and
//          whose warp 9 sums dcum's per-row terms and ⟨g, h_in⟩ and writes
//          dlog_a (a reverse cumsum, the running sum passed lane to lane).
//          Per head each product takes the orientation whose float32 side
//          is the A operand: rows j, X dYᵀ and B Cᵀ (recomputed for each
//          head: held across the head loop it takes 64 more registers a
//          thread, in a kernel that already spills), giving Z, M, A and
//          dx's Mᵀ dY,
//          db's Zᵀ C; rows i, dY Xᵀ, giving dc's Z B; the state terms
//          transposed, (g Xᵀ)ᵀ, (gᵀ Bᵀ)ᵀ and (h_in dYᵀ)ᵀ with g and h_in
//          from device memory as the A operand, through a float32 staging
//          buffer of the warpgroup into the accumulators that the L x L
//          products then add to.  exp(cum_i - cum_j) on the accumulator
//          fragments with expf, never taken above the diagonal; the sums of
//          A, of dcum's partial dot products and of ⟨g, h_in⟩ by warp
//          shuffles and per-warp partials in a fixed order.  The tile loops
//          are not unrolled: the unrolled head loop ran slower
//          (tools/ssd_bwd_variants.py and PERF.md give the times).
//   cells  float32, and bf16 shapes outside the wgmma route (L 1-32 or 96,
//          N 17 or 256, P % 8 != 0): ssd_bwd_state, one block per (64 x 64
//          tile of the state, head, sequence) walking the chunks forward
//          then back; ssd_bwd_chunk, one block per (chunk, head, sequence),
//          C Bᵀ and dY Xᵀ over the causal triangle into shared memory.
//          Every product is IEEE float32 FMA on the CUDA cores, 32-deep
//          slices staged in shared memory, a 4 x 4 tile a thread.  Its C
//          entries stay reachable on bf16 inputs too, so that the wgmma
//          route can be timed against them on the same inputs.
//
// Every sum has one fixed order and there are no atomics: two runs give the
// same bits.  Shapes: L <= 128, N <= 256, P <= 128; float32 and bf16.
//
// Bound on an H100 SXM at the training shape (1 x 4,096 x 80 x 64, N 128,
// L 128, bf16; launch/roofline.py:ssd_bwd_work): bytes.  The state kernel
// moves 255 MB (0.076 ms at 3.35 TB/s), the chunk kernel 634 MB with the
// heads' scratch (0.189 ms), ssd_bwd_sum 338 MB (0.101 ms); their 43.5
// GFLOP take 0.044 ms at the bf16 tensor-core rate (989 TFLOP/s), three
// times that with three-term operands, still under the bytes.  Most of
// those bytes are the split's own scratch (h_in, g and the heads' db and dc
// terms, written and read again): the gradient itself reads x, dy, b, c
// and log_a and writes dx, dlog_a, db and dc, 133 MB (0.040 ms), so its
// bound is its operations, 0.044 ms (roofline.ssd_bwd_total).  The cells
// route's float32 FMA is bound by its operations instead (0.65 ms at 67
// TFLOP/s).
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------------------------------ //
// The bf16 route on Hopper's tensor cores (ssd_chunk.bwd_route "wgmma").     //
// ------------------------------------------------------------------------ //

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// p, opaque to the compiler: a wgmma descriptor built from it inside a loop
// is built there, not hoisted out and held in registers across the loop
__device__ __forceinline__ const uint8_t* launder(const uint8_t* p) {
  asm volatile("" : "+l"(p));
  return p;
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// a 64 x 64 float32 accumulator tile as three bf16 register A operands: term
// u's k16 step kk is m[u][4 kk .. 4 kk + 3] (register 2 k + e of v is row lq +
// 8 (k & 1), column 8 (k >> 1) + 2 t + e, as ssd_chunk.cu's decay_split reads)
__device__ __forceinline__ void split_tile(const float (&v)[32], uint32_t (&m)[3][16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) split3(v[2 * k], v[2 * k + 1], m[0][k], m[1][k], m[2][k]);
}

// d += (m_hi + m_mid + m_lo) B over 64 rows of depth: B a 64 x 64 tile read
// N-major (64 rows of 128 bytes from b)
__device__ __forceinline__ void product_rs3(float (&d)[32], const uint32_t (&m)[3][16],
                                            const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = sw128_desc(b + kk * 16 * ATOM_ROW, TILE_BYTES, 1024);
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const uint32_t ak[4] = {m[u][4 * kk], m[u][4 * kk + 1], m[u][4 * kk + 2], m[u][4 * kk + 3]};
      wgmma_rs_n64(d, ak, db);
    }
  }
}

// d = A Bᵀ over DK columns of depth, A 64 rows of float32 from device memory
// as three bf16 terms, B 64 rows K-major in shared memory (its 64-column
// atoms b_atom bytes apart).  at(r, k): A's row r of the warp's 16 (lq or lq
// + 8), columns k and k + 1.  Every load of A is issued before the first
// product, so the tile waits for memory once.  Called by a whole warpgroup.
template <int DK, class F>
__device__ __forceinline__ void product_t(float (&d)[32], F at, const uint8_t* b, int b_atom,
                                          int lq, int t) {
  float2 v[DK / 16][4];
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const int k0 = 16 * kk + 2 * t;
    v[kk][0] = at(lq, k0);
    v[kk][1] = at(lq + 8, k0);
    v[kk][2] = at(lq, k0 + 8);
    v[kk][3] = at(lq + 8, k0 + 8);
  }
  uint32_t fr[DK / 16][3][4];
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split3(v[kk][q].x, v[kk][q].y, fr[kk][0][q], fr[kk][1][q], fr[kk][2][q]);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const uint64_t db = sw128_desc(b + (kk >> 2) * b_atom + (kk & 3) * 32, 16, 1024);
#pragma unroll
    for (int u = 0; u < 3; ++u) wgmma_rs_n64_k(d, fr[kk][u], db);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
}

// d = A Bᵀ, both 64-row tiles K-major over DK columns (bf16 x bf16, exact
// products, float32 sums)
template <int DK>
__device__ __forceinline__ void product_ss_now(float (&d)[32], const uint8_t* a, int a_atom,
                                               const uint8_t* b, int b_atom) {
  fence_regs(d);
  wgmma_fence();
  product_ss<DK>(d, a, a_atom, b, b_atom);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
}

// a transposed product tile into the staging buffer as [tile row][column]:
// its rows (row0 + lq, + 8) are the staged matrix's columns, its columns the
// 64 rows of the warpgroup's tile
__device__ __forceinline__ void stage_put(float* stg, int sn, const float (&v)[32], int row0,
                                          int lq, int t) {
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int col = row0 + lq + 8 * ((q >> 1) & 1), tr = 8 * (q >> 2) + 2 * t + (q & 1);
    stg[tr * sn + col] = v[q];
  }
}

// the two bf16 of row r, columns n and n + 1 (n even) of a [N / 64 atoms][L
// rows][128 bytes] tile in the 128-byte swizzle
__device__ __forceinline__ float2 swz_pair(const uint8_t* base, int L, int r, int n) {
  const uint8_t* p = base + (n >> 6) * L * ATOM_ROW + r * ATOM_ROW +
                     (((((n & 63) >> 3) ^ (r & 7))) << 4) + (n & 7) * 2;
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Phase counters of the chunk kernel's bf16 route, for the "phases counted"
// copy that tools/ssd_bwd_variants.py builds with -DSSD_BWD_PHASES: thread 0
// of each consumer warpgroup w adds the clock64() cycles of each phase k of
// a head to g_phase[w][k] (read by repro_ssd_bwd_phases).  Built without
// the macro, as the package builds it, they are empty statements.
#ifdef SSD_BWD_PHASES
__device__ unsigned long long g_phase[2][16];
#define PHASE_START long long phase_t = clock64()
#define PHASE(k)                                                                        \
  do {                                                                                  \
    const long long now_ = clock64();                                                   \
    if ((threadIdx.x & 127) == 0)                                                       \
      atomicAdd(&g_phase[w][k], (unsigned long long)(now_ - phase_t));                  \
    phase_t = now_;                                                                     \
  } while (0)
#else
#define PHASE_START \
  do {              \
  } while (0)
#define PHASE(k) \
  do {           \
  } while (0)
#endif

// The chunk kernel's bf16 route: consumer warpgroups 0 and 1, producer
// warpgroup 2 (warp 8 loads and scans, warp 9 finishes dlog_a).
constexpr int CTHREADS = 384, PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int SMEM_BUDGET = 227 * 1024 - 256;

template <int L, int N, int DP>
struct ChunkShape {
  static constexpr int RT = L / 64, PT = DP / 64, NA = N / 64;
  static constexpr int CB_BYTES = NA * L * ATOM_ROW;      // C or B: N / 64 atoms of L rows
  static constexpr int XT_BYTES = RT * PT * TILE_BYTES;   // one head's X, or dY
  static constexpr int SN = (N > DP ? N : DP) + 4;        // floats in a staging row
  static constexpr int STAGE_BYTES = 64 * SN * 4;         // one warpgroup's staging
  static constexpr int ROW_BYTES = (6 + 4 * RT) * L * 4 + 32;  // a slot's per-row arrays
  static constexpr int FIXED = 2 * CB_BYTES + RT * STAGE_BYTES + 1024;
  static constexpr int STAGES = FIXED + 2 * (2 * XT_BYTES + ROW_BYTES) <= SMEM_BUDGET ? 2 : 1;
  static constexpr int SMEM = FIXED + STAGES * 2 * XT_BYTES;  // dynamic: + alignment slack
};

// One block: chunk `blockIdx.y` of sequence `blockIdx.z`, heads h0 .. h0 + G
// - 1.  Consumer warpgroup w takes rows 64 w .. 64 w + 63 of the chunk, as j
// (dx, db, A's column sums) and as i (dc); at L = 64 warpgroup 1 has none.
// Shared memory: C and B as [atom][L][128 bytes], then per slot X and dY
// as [64-row tile][64-column atom][64][128 bytes] (all as TMA writes them,
// in the 128-byte swizzle), and a float32 staging buffer of 64 x SN a
// warpgroup for the state terms' transposed products.
template <int L, int N, int DP>
__global__ void __launch_bounds__(CTHREADS, 1)
ssd_bwd_chunk_wgmma(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_dy,
                    const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ log_a,
                    const float* __restrict__ hin, const float* __restrict__ gin, int S, int H,
                    int P, int G, __nv_bfloat16* __restrict__ dx, float* __restrict__ dla,
                    float* __restrict__ dbp, float* __restrict__ dcp) {
  using W = ChunkShape<L, N, DP>;
  constexpr int ST = W::STAGES, RT = W::RT, PT = W::PT, NA = W::NA, SN = W::SN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bc_full, full[ST], empty[ST], rows_full[ST];
  __shared__ __align__(16) float cums[ST][L], es[ST][L], ws[ST][L];
  __shared__ float part[ST][RT][4][L];  // a warp's sums of A over its 16 rows j, by column i
  __shared__ float colas[ST][L], svs[ST][L], pis[ST][L];
  __shared__ float ghs[ST][RT][4];  // a warp's partial of ⟨g_k, h_in_k⟩
  uint8_t* base = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* cs_all = base;
  uint8_t* bs_all = cs_all + W::CB_BYTES;
  float* stage_all = reinterpret_cast<float*>(bs_all + W::CB_BYTES);
  uint8_t* slots = bs_all + W::CB_BYTES + RT * W::STAGE_BYTES;

  const int chunk = blockIdx.y, bt = blockIdx.z, nc = gridDim.y;
  const int h0 = blockIdx.x * G, heads = min(G, H - h0);
  const int row0 = bt * S + chunk * L;  // the chunk's first (b, t) row
  const long long NP = (long long)N * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(&bc_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1 + 32);       // the TMA bytes, then every lane's cumsum
      mbar_init(&empty[s], 1);           // warp 9, after the consumers and dlog_a
      mbar_init(&rows_full[s], 128 * RT);  // every consumer thread with rows
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == 8) {  // TMA loads and the cumsum
      if (lane == 0) {
        mbar_expect_tx(&bc_full, 2 * W::CB_BYTES);
        for (int a = 0; a < NA; ++a) {
          tma_load(cs_all + a * L * ATOM_ROW, &tm_c, &bc_full, 64 * a, chunk * L, bt);
          tma_load(bs_all + a * L * ATOM_ROW, &tm_b, &bc_full, 64 * a, chunk * L, bt);
        }
      }
      constexpr int PER = L / 32;
      for (int g = 0; g < heads; ++g) {
        const int s = g % ST, h = h0 + g;
        mbar_wait(&empty[s], ((g / ST) & 1) ^ 1);
        if (lane == 0) {
          uint8_t* xs = slots + s * 2 * W::XT_BYTES;
          mbar_expect_tx(&full[s], 2 * W::XT_BYTES);
          for (int rt = 0; rt < RT; ++rt)
            for (int a = 0; a < PT; ++a) {
              tma_load(xs + (rt * PT + a) * TILE_BYTES, &tm_x, &full[s], 64 * a, h,
                       row0 + 64 * rt);
              tma_load(xs + W::XT_BYTES + (rt * PT + a) * TILE_BYTES, &tm_dy, &full[s], 64 * a,
                       h, row0 + 64 * rt);
            }
        }
        // the cumsum in the plain order: each lane its PER values, the running
        // sum passed lane to lane
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
          es[s][lane * PER + k] = expf(v[k]);
          ws[s][lane * PER + k] = expf(run - v[k]);
        }
        mbar_arrive(&full[s]);
      }
    } else if (warp == 9) {  // dcum and dlog_a from the consumers' per-row terms
      constexpr int PER = L / 32;
      for (int g = 0; g < heads; ++g) {
        const int s = g % ST, h = h0 + g;
        mbar_wait(&rows_full[s], (g / ST) & 1);
        float gh = 0.0f;  // ⟨g_k, h_in_k⟩: the warps' partials in order
        for (int w = 0; w < RT; ++w)
#pragma unroll
          for (int q = 0; q < 4; ++q) gh += ghs[s][w][q];
        // dcum_i = Σ_j A_ij - Σ_j A_ji + e_i c_i·(h_in dy_i) - w_i b_i·(g x_i)
        float dc[PER], last = 0.0f;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int i = lane * PER + k;
          float ra = 0.0f;
          for (int jt = 0; jt <= i / 64; ++jt)
#pragma unroll
            for (int q = 0; q < 4; ++q) ra += part[s][jt][q][i];
          dc[k] = ra - colas[s][i] + pis[s][i] - svs[s][i];
          last += svs[s][i];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) last += __shfl_xor_sync(0xffffffffu, last, off);
        if (lane == 31) dc[PER - 1] += last + es[s][L - 1] * gh;
        // dlog_a: the reverse cumsum, the running sum passed from lane 31 down
        float run = 0.0f;
        for (int l = 31; l >= 0; --l) {
          if (lane == l) {
#pragma unroll
            for (int k = PER - 1; k >= 0; --k) dc[k] = run = run + dc[k];
          }
          run = __shfl_sync(0xffffffffu, run, l);
        }
#pragma unroll
        for (int k = 0; k < PER; ++k) dla[(long long)(row0 + lane * PER + k) * H + h] = dc[k];
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int w = warp >> 2;
  if (w >= RT) return;  // L = 64: one warpgroup of rows
  const int w4 = warp & 3, t = lane & 3, lq = lane >> 2;
  const int lr = 16 * w4 + lq;  // this thread's rows lr and lr + 8 of the tile
  const int r0 = 64 * w + lr;   // ... of the chunk
  float* stg = stage_all + w * 64 * SN;
  const int bar = 1 + w;

  mbar_wait(&bc_full, 0);
  PHASE_START;

  for (int g = 0; g < heads; ++g) {
    const int s = g % ST, h = h0 + g;
    mbar_wait(&full[s], (g / ST) & 1);
    PHASE(0);  // the wait for X and dY
    const uint8_t* cs = launder(cs_all);  // C and B of the chunk, laundered again at
    const uint8_t* bs = launder(bs_all);  // each phase
    const uint8_t* xs = slots + s * 2 * W::XT_BYTES;
    const uint8_t* ys = xs + W::XT_BYTES;
    const uint8_t* xw = xs + w * PT * TILE_BYTES;  // this warpgroup's 64 rows of X
    const uint8_t* yw = ys + w * PT * TILE_BYTES;  // ... of dY
    const float* cum = cums[s];
    const float cr[2] = {cum[r0], cum[r0 + 8]};
    const float wr[2] = {ws[s][r0], ws[s][r0 + 8]}, er[2] = {es[s][r0], es[s][r0 + 8]};
    const long long cell = ((long long)bt * nc + chunk) * H + h;
    const float* gk = gin + cell * NP;
    const float* hk = hin + cell * NP;

    // ---- db_j = w_j (g_k x_j) + Σ_{i>=j} Z_ij c_i, the head's term ----
    // (g_k x_j) for the tile's j, as (g Xᵀ)ᵀ: rows n, g the register operand
#pragma unroll 1
    for (int mt = 0; mt < NA; ++mt) {
      float tacc[32];
      const float* gr = gk + (long long)(64 * mt + 16 * w4) * P;
      product_t<DP>(tacc, [&](int r, int k) {
        return k < P ? ldg2(gr + (long long)r * P + k) : make_float2(0.0f, 0.0f);
      }, xw, TILE_BYTES, lq, t);
      stage_put(stg, SN, tacc, 64 * mt + 16 * w4, lq, t);
    }
    named_sync(bar, 128);
    PHASE(1);  // g Xᵀ
    float acc[NA][32], sv[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nh = 0; nh < NA; ++nh)
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int r = (q >> 1) & 1, n = 64 * nh + 8 * (q >> 2) + 2 * t + (q & 1);
        const float v = stg[(lr + 8 * r) * SN + n];
        acc[nh][q] = wr[r] * v;
        const float2 bv = swz_pair(bs, L, r0 + 8 * r, n & ~1);
        sv[r] = fmaf((q & 1) ? bv.y : bv.x, v, sv[r]);
      }
    named_sync(bar, 128);
    PHASE(2);  // db's terms from staging
#pragma unroll 1
    for (int it = w; it < RT; ++it) {
      float z[32];  // X_w dY_itᵀ: rows j, columns i; then Z
      product_ss_now<DP>(z, xw, TILE_BYTES, ys + it * PT * TILE_BYTES, TILE_BYTES);
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int r = (q >> 1) & 1, i = 64 * it + 8 * (q >> 2) + 2 * t + (q & 1);
        // exp(-inf) = 0: a hidden entry (i < j) is never exponentiated
        const float d = (it == w && i < r0 + 8 * r) ? -CUDART_INF_F : cum[i] - cr[r];
        z[q] *= expf(d);
      }
      uint32_t m[3][16];
      split_tile(z, m);
#pragma unroll
      for (int nh = 0; nh < NA; ++nh) fence_regs(acc[nh]);
      wgmma_fence();
#pragma unroll
      for (int nh = 0; nh < NA; ++nh)
        product_rs3(acc[nh], m, cs + nh * L * ATOM_ROW + 64 * it * ATOM_ROW);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int nh = 0; nh < NA; ++nh) fence_regs(acc[nh]);
    }
    PHASE(3);  // db's L x L products
    {
      float* out = dbp + cell * L * N;
#pragma unroll
      for (int nh = 0; nh < NA; ++nh)
#pragma unroll
        for (int q = 0; q < 32; q += 2) {
          const int r = (q >> 1) & 1, n = 64 * nh + 8 * (q >> 2) + 2 * t;
          *reinterpret_cast<float2*>(out + (long long)(r0 + 8 * r) * N + n) =
              make_float2(acc[nh][q], acc[nh][q + 1]);
        }
    }
    PHASE(4);  // db's store

    // ---- dx_j = w_j (g_kᵀ b_j) + Σ_{i>=j} M_ij dy_i ----
    cs = launder(cs_all);
    bs = launder(bs_all);
    // (g_kᵀ b_j) as (gᵀ Bᵀ)ᵀ: rows p, gᵀ the register operand
#pragma unroll 1
    for (int pt = 0; pt < PT; ++pt) {
      float tacc[32];
      const int pb = 64 * pt + 16 * w4;
      product_t<N>(tacc, [&](int r, int k) {
        const int p = pb + r;
        return p < P ? make_float2(__ldg(gk + (long long)k * P + p),
                                   __ldg(gk + (long long)(k + 1) * P + p))
                     : make_float2(0.0f, 0.0f);
      }, bs + 64 * w * ATOM_ROW, L * ATOM_ROW, lq, t);
      stage_put(stg, SN, tacc, pb, lq, t);
    }
    named_sync(bar, 128);
    PHASE(5);  // gᵀ Bᵀ
    float dacc[PT][32];
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int r = (q >> 1) & 1, p = 64 * pt + 8 * (q >> 2) + 2 * t + (q & 1);
        dacc[pt][q] = wr[r] * stg[(lr + 8 * r) * SN + p];
      }
    named_sync(bar, 128);
    PHASE(6);  // dx's terms from staging
    float cola[2] = {0.0f, 0.0f};
#pragma unroll 1
    for (int it = w; it < RT; ++it) {
      float mv[32], z[32];  // B_w C_itᵀ, then M; X_w dY_itᵀ: rows j, columns i
      product_ss_now<N>(mv, bs + 64 * w * ATOM_ROW, L * ATOM_ROW, cs + 64 * it * ATOM_ROW,
                        L * ATOM_ROW);
      product_ss_now<DP>(z, xw, TILE_BYTES, ys + it * PT * TILE_BYTES, TILE_BYTES);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int i0 = 64 * it + 8 * nb + 2 * t;
        const float2 ci = *reinterpret_cast<const float2*>(cum + i0);
        float a[2][2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 4 * nb + 2 * r + e;
            const float d = (it == w && i0 + e < r0 + 8 * r) ? -CUDART_INF_F
                                                             : (e ? ci.y : ci.x) - cr[r];
            const float ed = expf(d);
            a[r][e] = mv[q] * (z[q] * ed);  // A_ij = (c_i·b_j) Z_ij
            cola[r] += a[r][e];
            mv[q] *= ed;
          }
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // Σ_j A_ij over the warp's 16 rows j
          float c = a[0][e] + a[1][e];
          c += __shfl_xor_sync(0xffffffffu, c, 4);
          c += __shfl_xor_sync(0xffffffffu, c, 8);
          c += __shfl_xor_sync(0xffffffffu, c, 16);
          if (lq == 0) part[s][w][w4][i0 + e] = c;
        }
      }
      uint32_t m[3][16];
      split_tile(mv, m);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) fence_regs(dacc[pt]);
      wgmma_fence();
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) product_rs3(dacc[pt], m, ys + (it * PT + pt) * TILE_BYTES);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) fence_regs(dacc[pt]);
    }
    PHASE(7);  // dx's L x L products
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int q = 0; q < 32; q += 2) {
        const int r = (q >> 1) & 1, p = 64 * pt + 8 * (q >> 2) + 2 * t;
        if (p < P)
          *reinterpret_cast<__nv_bfloat162*>(dx + ((long long)(row0 + r0 + 8 * r) * H + h) * P +
                                             p) = __floats2bfloat162_rn(dacc[pt][q],
                                                                        dacc[pt][q + 1]);
      }
    PHASE(8);  // dx's store

    // ---- dc_i = e_i (h_in dy_i) + Σ_{j<=i} Z_ij b_j, the head's term ----
    cs = launder(cs_all);
    bs = launder(bs_all);
    // (h_in dy_i) for the tile's i, as (h_in dYᵀ)ᵀ: rows n, h_in the register
    // operand; and ⟨g_k, h_in_k⟩ over the rows n of the m tiles mt % RT == w
    float gh = 0.0f;
#pragma unroll 1
    for (int mt = 0; mt < NA; ++mt) {
      float tacc[32];
      const long long ro = (long long)(64 * mt + 16 * w4) * P;
      const bool dot = mt % RT == w;
      product_t<DP>(tacc, [&](int r, int k) {
        if (k >= P) return make_float2(0.0f, 0.0f);
        const float2 hv = ldg2(hk + ro + (long long)r * P + k);
        if (dot) {
          const float2 gv = ldg2(gk + ro + (long long)r * P + k);
          gh = fmaf(gv.y, hv.y, fmaf(gv.x, hv.x, gh));
        }
        return hv;
      }, yw, TILE_BYTES, lq, t);
      stage_put(stg, SN, tacc, 64 * mt + 16 * w4, lq, t);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) gh += __shfl_xor_sync(0xffffffffu, gh, off);
    if (lane == 0) ghs[s][w][w4] = gh;
    named_sync(bar, 128);
    PHASE(9);  // h_in dYᵀ
    float pi[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nh = 0; nh < NA; ++nh)
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int r = (q >> 1) & 1, n = 64 * nh + 8 * (q >> 2) + 2 * t + (q & 1);
        const float v = stg[(lr + 8 * r) * SN + n];
        acc[nh][q] = er[r] * v;
        const float2 cv = swz_pair(cs, L, r0 + 8 * r, n & ~1);
        pi[r] = fmaf((q & 1) ? cv.y : cv.x, v, pi[r]);
      }
    named_sync(bar, 128);
    PHASE(10);  // dc's terms from staging
#pragma unroll 1
    for (int jt = 0; jt <= w; ++jt) {
      float z[32];  // dY_w X_jtᵀ: rows i, columns j
      product_ss_now<DP>(z, yw, TILE_BYTES, xs + jt * PT * TILE_BYTES, TILE_BYTES);
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int r = (q >> 1) & 1, j = 64 * jt + 8 * (q >> 2) + 2 * t + (q & 1);
        const float d = (jt == w && j > r0 + 8 * r) ? -CUDART_INF_F : cr[r] - cum[j];
        z[q] *= expf(d);
      }
      uint32_t m[3][16];
      split_tile(z, m);
#pragma unroll
      for (int nh = 0; nh < NA; ++nh) fence_regs(acc[nh]);
      wgmma_fence();
#pragma unroll
      for (int nh = 0; nh < NA; ++nh)
        product_rs3(acc[nh], m, bs + nh * L * ATOM_ROW + 64 * jt * ATOM_ROW);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int nh = 0; nh < NA; ++nh) fence_regs(acc[nh]);
    }
    PHASE(11);  // dc's L x L products
    {
      float* out = dcp + cell * L * N;
#pragma unroll
      for (int nh = 0; nh < NA; ++nh)
#pragma unroll
        for (int q = 0; q < 32; q += 2) {
          const int r = (q >> 1) & 1, n = 64 * nh + 8 * (q >> 2) + 2 * t;
          *reinterpret_cast<float2*>(out + (long long)(r0 + 8 * r) * N + n) =
              make_float2(acc[nh][q], acc[nh][q + 1]);
        }
    }

    // the rows' terms of dcum, each summed over its quad in a fixed order
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        cola[r] += __shfl_xor_sync(0xffffffffu, cola[r], off);
        sv[r] += __shfl_xor_sync(0xffffffffu, sv[r], off);
        pi[r] += __shfl_xor_sync(0xffffffffu, pi[r], off);
      }
      if (t == 0) {
        colas[s][r0 + 8 * r] = cola[r];
        svs[s][r0 + 8 * r] = wr[r] * sv[r];
        pis[s][r0 + 8 * r] = er[r] * pi[r];
      }
    }
    mbar_arrive(&rows_full[s]);
    PHASE(12);  // dc's store and the rows' terms
  }
}

// The state kernel's bf16 route: one consumer warpgroup per 64 columns of P,
// then one producer warp.
template <int L, int DP>
struct StateShape {
  static constexpr int RT = L / 64, PT = DP / 64;
  static constexpr int X_BYTES = RT * PT * TILE_BYTES;  // a chunk's X, or dY
  static constexpr int N_BYTES = L * ATOM_ROW;          // 64 columns of its B, or C
  static constexpr int SLOT = X_BYTES + N_BYTES;
  static constexpr int STAGES = 96 * 1024 / SLOT < 2 ? 2 : (96 * 1024 / SLOT > 4 ? 4 : 96 * 1024 / SLOT);
  static constexpr int SMEM = STAGES * SLOT + 1024;
  static constexpr int THREADS = 128 * PT + 32;
};

// One block: columns n0 = 64 blockIdx.x .. n0 + 63 of the state of head
// blockIdx.y, sequence blockIdx.z.  Consumer warpgroup cw holds rows p = 64
// cw .. 64 cw + 63 of hᵀ (then gᵀ) in registers; the producer warp (the
// last) loads each step's chunk (X and B forward, dY and C back) through a
// ring of STAGES slots and its w (or e) and D.
template <int L, int DP>
__global__ void __launch_bounds__(StateShape<L, DP>::THREADS, 1)
ssd_bwd_state_wgmma(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_dy,
                    const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ log_a,
                    const float* __restrict__ dh, int S, int H, int P, int N,
                    float* __restrict__ hin, float* __restrict__ gout) {
  using W = StateShape<L, DP>;
  constexpr int ST = W::STAGES, PT = W::PT;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  __shared__ __align__(16) float vs[ST][L];  // w (forward walk) or e (backward walk)
  __shared__ float decay[ST];
  uint8_t* base = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);

  const int n0 = 64 * blockIdx.x, h = blockIdx.y, bt = blockIdx.z, nc = S / L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int steps = 2 * (nc - 1);  // S_0 .. S_{nc-2}, then Q_{nc-1} .. Q_1
  const long long NP = (long long)N * P;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], 4 * PT);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * PT) {  // the producer warp
    constexpr int PER = L / 32;
    for (int st = 0; st < steps; ++st) {
      const int s = st % ST;
      const bool fwd = st < nc - 1;
      const int k = fwd ? st : 2 * nc - 2 - st;
      const int row0 = bt * S + k * L;
      uint8_t* xs = base + s * W::SLOT;
      mbar_wait(&empty[s], ((st / ST) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], W::SLOT);
        for (int rt = 0; rt < W::RT; ++rt)
          for (int a = 0; a < PT; ++a)
            tma_load(xs + (rt * PT + a) * TILE_BYTES, fwd ? &tm_x : &tm_dy, &full[s], 64 * a, h,
                     row0 + 64 * rt);
        tma_load(xs + W::X_BYTES, fwd ? &tm_b : &tm_c, &full[s], n0, k * L, bt);
      }
      float v[PER];
      const float* la = log_a + (long long)(row0 + lane * PER) * H + h;
#pragma unroll
      for (int q = 0; q < PER; ++q) v[q] = la[(long long)q * H];
      float run = 0.0f;
      for (int l = 0; l < 32; ++l) {
        if (lane == l) {
#pragma unroll
          for (int q = 0; q < PER; ++q) v[q] = run = run + v[q];
        }
        run = __shfl_sync(0xffffffffu, run, l);
      }
#pragma unroll
      for (int q = 0; q < PER; ++q) vs[s][lane * PER + q] = fwd ? expf(run - v[q]) : expf(v[q]);
      if (lane == 0) decay[s] = expf(run);
      mbar_arrive(&full[s]);
    }
    return;
  }

  const int cw = warp >> 2, w4 = warp & 3, t = lane & 3, lq = lane >> 2;
  const int pr = 64 * cw + 16 * w4 + lq;  // this thread's rows pr and pr + 8 (p)
  // register q: p = pr + 8 ((q >> 1) & 1), n = n0 + 8 (q >> 2) + 2 t + (q & 1)
  auto put = [&](float* out, const float (&v)[32]) {
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int p = pr + 8 * ((q >> 1) & 1), n = n0 + 8 * (q >> 2) + 2 * t + (q & 1);
      if (p < P) out[(long long)n * P + p] = v[q];
    }
  };
  auto at = [&](int k) { return (((long long)bt * nc + k) * H + h) * NP; };

  // forward: h_in_0 = 0, h_in_{k+1} = D_k h_in_k + S_k
  float hv[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) hv[q] = 0.0f;
  for (int k = 0; k < nc; ++k) {
    put(hin + at(k), hv);
    if (k == nc - 1) break;
    const int s = k % ST;
    mbar_wait(&full[s], (k / ST) & 1);
    float sv[32];
    state_product<L, PT>(sv, base + s * W::SLOT, base + s * W::SLOT + W::X_BYTES, vs[s], cw, w4,
                         lane);
    const float d = decay[s];
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int q = 0; q < 32; ++q) hv[q] = __fadd_rn(__fmul_rn(d, hv[q]), sv[q]);
  }

  // backward: g_{nc-1} = dh_final, g_{k-1} = Q_k + D_k g_k
  float gv[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int p = pr + 8 * ((q >> 1) & 1), n = n0 + 8 * (q >> 2) + 2 * t + (q & 1);
    gv[q] = dh != nullptr && p < P ? dh[((long long)bt * H + h) * NP + (long long)n * P + p]
                                   : 0.0f;
  }
  for (int k = nc - 1; k >= 0; --k) {
    put(gout + at(k), gv);
    if (k == 0) break;
    const int st = 2 * nc - 2 - k, s = st % ST;
    mbar_wait(&full[s], (st / ST) & 1);
    float qv[32];
    state_product<L, PT>(qv, base + s * W::SLOT, base + s * W::SLOT + W::X_BYTES, vs[s], cw, w4,
                         lane);
    const float d = decay[s];
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int q = 0; q < 32; ++q) gv[q] = __fadd_rn(qv[q], __fmul_rn(d, gv[q]));
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


// what the bf16 route takes (ssd_chunk.bwd_route): L and N in {64, 128}, P
// <= 128 with P % 8 == 0 (TMA needs 16-byte row strides)
bool wgmma_shape_ok(int batch, int S, int H, int P, int N, int L) {
  return batch > 0 && batch <= 65535 && S > 0 && H > 0 && (L == 64 || L == 128) &&
         S % L == 0 && S / L <= 65535 && (N == 64 || N == 128) && P > 0 && P <= 128 &&
         P % 8 == 0;
}

// the tensor maps of x and dy ((batch S) rows x H x P, boxes of 64 rows x 64
// columns of one head) and of b and c (batch x S x N, boxes of `rows` rows x
// 64 columns)
int encode_maps(const void* x, const void* b, const void* c, const void* dy, int batch, int S,
                int H, int P, int N, int rows, CUtensorMap* tx, CUtensorMap* tdy,
                CUtensorMap* tb, CUtensorMap* tc) {
  const cuuint64_t xdims[3] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)batch * S};
  const cuuint64_t xstrides[2] = {(cuuint64_t)P * 2, (cuuint64_t)H * P * 2};
  const cuuint32_t xbox[3] = {64, 1, 64};
  const cuuint64_t bdims[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)batch};
  const cuuint64_t bstrides[2] = {(cuuint64_t)N * 2, (cuuint64_t)S * N * 2};
  const cuuint32_t bbox[3] = {64, (cuuint32_t)rows, 1};
  int e;
  if ((e = encode_bf16(tx, x, xdims, xstrides, xbox)) != 0) return e;
  if ((e = encode_bf16(tdy, dy, xdims, xstrides, xbox)) != 0) return e;
  if ((e = encode_bf16(tb, b, bdims, bstrides, bbox)) != 0) return e;
  return encode_bf16(tc, c, bdims, bstrides, bbox);
}

template <int L, int DP>
int run_state_wgmma(const void* x, const void* log_a, const void* b, const void* c,
                    const void* dy, const void* dh, int batch, int S, int H, int P, int N,
                    void* hin, void* g, cudaStream_t st) {
  using W = StateShape<L, DP>;
  auto kernel = ssd_bwd_state_wgmma<L, DP>;
  // a runtime call first: the encoder needs the context current in this
  // thread (autograd's backward thread may have made none)
  int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM);
  if (e != 0) return e;
  CUtensorMap tx, tdy, tb, tc;
  if ((e = encode_maps(x, b, c, dy, batch, S, H, P, N, L, &tx, &tdy, &tb, &tc)) != 0) return e;
  const dim3 grid((unsigned)(N / 64), (unsigned)H, (unsigned)batch);
  kernel<<<grid, W::THREADS, (size_t)W::SMEM, st>>>(tx, tdy, tb, tc, (const float*)log_a,
                                                    (const float*)dh, S, H, P, N, (float*)hin,
                                                    (float*)g);
  return (int)cudaGetLastError();
}

template <int L, int N, int DP>
int run_chunk_wgmma(const void* x, const void* log_a, const void* b, const void* c,
                    const void* dy, const void* hin, const void* g, int batch, int S, int H,
                    int P, int G, void* dx, void* dla, void* dbp, void* dcp, cudaStream_t st) {
  using W = ChunkShape<L, N, DP>;
  auto kernel = ssd_bwd_chunk_wgmma<L, N, DP>;
  int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM);
  if (e != 0) return e;
  CUtensorMap tx, tdy, tb, tc;
  if ((e = encode_maps(x, b, c, dy, batch, S, H, P, N, L, &tx, &tdy, &tb, &tc)) != 0) return e;
  const dim3 grid((unsigned)((H + G - 1) / G), (unsigned)(S / L), (unsigned)batch);
  kernel<<<grid, CTHREADS, (size_t)W::SMEM, st>>>(
      tx, tdy, tb, tc, (const float*)log_a, (const float*)hin, (const float*)g, S, H, P, G,
      (__nv_bfloat16*)dx, (float*)dla, (float*)dbp, (float*)dcp);
  return (int)cudaGetLastError();
}

template <int L, int N>
int chunk_by_width(const void* x, const void* log_a, const void* b, const void* c,
                   const void* dy, const void* hin, const void* g, int batch, int S, int H,
                   int P, int G, void* dx, void* dla, void* dbp, void* dcp, cudaStream_t st) {
  if (P <= 64)
    return run_chunk_wgmma<L, N, 64>(x, log_a, b, c, dy, hin, g, batch, S, H, P, G, dx, dla, dbp,
                                     dcp, st);
  return run_chunk_wgmma<L, N, 128>(x, log_a, b, c, dy, hin, g, batch, S, H, P, G, dx, dla, dbp,
                                    dcp, st);
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

// h_in and g as repro_ssd_bwd_state, on the bf16 route (bf16 x, b, c, dy
// on 16-byte boundaries; shapes as wgmma_shape_ok)
REPRO_EXPORT int repro_ssd_bwd_state_wgmma(const void* x, const void* log_a, const void* b,
                                           const void* c, const void* dy, const void* dh,
                                           int batch, int S, int H, int P, int N, int L,
                                           void* hin, void* g, void* stream) {
  if (!wgmma_shape_ok(batch, S, H, P, N, L) || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (L == 64)
    return P <= 64 ? run_state_wgmma<64, 64>(x, log_a, b, c, dy, dh, batch, S, H, P, N, hin, g, st)
                   : run_state_wgmma<64, 128>(x, log_a, b, c, dy, dh, batch, S, H, P, N, hin, g,
                                              st);
  return P <= 64 ? run_state_wgmma<128, 64>(x, log_a, b, c, dy, dh, batch, S, H, P, N, hin, g, st)
                 : run_state_wgmma<128, 128>(x, log_a, b, c, dy, dh, batch, S, H, P, N, hin, g,
                                             st);
}

// dx, dlog_a and the heads' terms of db and dc as repro_ssd_bwd_chunk, on
// the bf16 route; a block walks G heads of one chunk
REPRO_EXPORT int repro_ssd_bwd_chunk_wgmma(const void* x, const void* log_a, const void* b,
                                           const void* c, const void* dy, const void* hin,
                                           const void* g, int batch, int S, int H, int P, int N,
                                           int L, int G, void* dx, void* dla, void* dbp,
                                           void* dcp, void* stream) {
  if (!wgmma_shape_ok(batch, S, H, P, N, L) || G <= 0 || (H + G - 1) / G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (L == 64 && N == 64)
    return chunk_by_width<64, 64>(x, log_a, b, c, dy, hin, g, batch, S, H, P, G, dx, dla, dbp,
                                  dcp, st);
  if (L == 64)
    return chunk_by_width<64, 128>(x, log_a, b, c, dy, hin, g, batch, S, H, P, G, dx, dla, dbp,
                                   dcp, st);
  if (N == 64)
    return chunk_by_width<128, 64>(x, log_a, b, c, dy, hin, g, batch, S, H, P, G, dx, dla, dbp,
                                   dcp, st);
  return chunk_by_width<128, 128>(x, log_a, b, c, dy, hin, g, batch, S, H, P, G, dx, dla, dbp,
                                  dcp, st);
}

#ifdef SSD_BWD_PHASES
// the chunk kernel's phase counters (cycles, [warpgroup 2][phase 16]) into
// out, or set to 0 where out is null
REPRO_EXPORT int repro_ssd_bwd_phases(void* out) {
  static const unsigned long long zero[32] = {};
  return out ? (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase))
             : (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
#endif
