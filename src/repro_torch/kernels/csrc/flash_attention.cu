// flash_attention: blocked online-softmax attention with grouped-query heads,
// causal and sliding-window masks and a query offset, and its backward.
//
// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), all of one type T (float32 or
// bfloat16); q-head h reads kv-head h / (Hq / Hkv).  The FMA kernels cast q
// to float32 and multiply it by `scale` before the product, the wgmma
// forward scales the float32 product; logits, the running max and
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
// Six kernels, with no atomics, so every result has one summation order and
// a training step is reproducible bit for bit:
//
//   attn_fwd_wgmma  the bf16 forward (D <= 128, D % 8 == 0) on the tensor
//            cores.  One block per (b, q-head, 128-row q tile), launched
//            longest-first under the causal mask: two consumer warpgroups
//            of 64 rows and one producer warp.  The producer's lane 0 loads
//            Q once and then the visible K and V tiles of 64 keys, in
//            order, through a ring of 3-4 shared-memory slots with TMA
//            (3-D tensor maps, completion on mbarriers), so tile j + 1 is
//            in flight while tile j is multiplied.  S = Q Kᵀ is
//            wgmma m64n64k16 with both operands read from shared memory;
//            the scale is applied to the float32 S; the online softmax runs
//            on the accumulator fragments (a row's 64 values sit in the
//            four threads of a quad: two shuffles each for max and sum);
//            P is rounded to bf16 in registers and is the register A
//            operand of O += P V (wgmma m64nDk16, V read through the
//            transpose bit since it is stored keys x D); O accumulates in
//            float32 registers.  Writes what attn_fwd writes.  D <= 64
//            runs two blocks an SM.
//   attn_fwd  the forward for float32 (IEEE FMA on the CUDA cores, never
//            TF32) and for bf16 widths TMA cannot take: one block per
//            (b, q-head, 64-row q block) walks the visible kv blocks in
//            order: S = Qs Kᵀ, online softmax, O += P V.  Writes O (type
//            T), optionally O in float32, and the per-row log-sum-exp
//            L = m + log l (+inf for a row that sees no key).
//   attn_bwd_dq_wgmma, attn_bwd_dkdv_wgmma  the bf16 backward (the same
//            widths) on the tensor cores, with the forward's TMA ring, block
//            shape (two consumer warpgroups, one producer warp) and swizzle.
//            dQ: one block per (b, q-head, 128-row q tile), longest first;
//            Q and dO loaded once, K and V streamed; Δ from the float32 O
//            first (each thread its columns in order, then the quad's four
//            parts by two shuffles), written out for dK/dV; per kv tile S =
//            Q Kᵀ and dP = dO Vᵀ (shared x shared), P = 2^(S·scale·log2 e −
//            L·log2 e) and dS = P ∘ (dP − Δ) on the fragments, dS rounded to
//            bf16 as the register A operand of dQ += dS K (K read N-major).
//            dK/dV: one block per (b, kv-head, 128-key tile), the tile the
//            most q tiles see first; K and V loaded once, then for each
//            q-head of the group in order, each q tile of 64 rows that sees
//            the kv tile, in order: Q, dO and the tile's L and Δ (1-D maps
//            over the flat rows) through the ring.  Sᵀ = K Qᵀ and dPᵀ =
//            V dOᵀ (shared x shared), so each thread's accumulator columns
//            are queries and it reads 16 L and Δ values a tile from shared
//            memory; Pᵀ and dSᵀ rounded to bf16 are the register A operands
//            of dV += Pᵀ dO and dK += dSᵀ Q (dO and Q read N-major); scale
//            goes on dK in float32 at the end.  The group's sum stays in
//            registers: no atomics, no split over q.
//   dQ       one block per (b, q-head, q block): Δ = rowsum(dO ∘ O) from
//            the float32 O (written out for the dK/dV kernel), then over
//            the kv blocks P = exp(S − L), dS = P ∘ (dO Vᵀ − Δ),
//            dQ += scale · dS K.
//   dK / dV  one block per (b, kv-head, kv block) walks the q-heads of its
//            group in order and, for each, the q blocks that see it:
//            dV += Pᵀ dO, dK += dSᵀ Qs (Qs = scale · q).  Summing the group
//            inside the block is what makes it atomic-free.
//
// The FMA dQ and dK/dV kernels take float32 (IEEE, never TF32) and bf16
// widths TMA cannot take.
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
// (about 85 MB) 0.025 ms.  So the function is bound by operations.  The
// FMA forward, which attn_fwd_wgmma replaces for bf16, computes them at the
// float32 rate (67 TFLOP/s peak) from a 4 x 4 register tile fed by shared
// loads, with synchronous staging: its floor was about 15x the bound.  The
// wgmma kernel moves both products to the tensor cores and overlaps the
// loads with them.  What limits it then is the softmax on the CUDA cores,
// so a tile that every row sees in full takes no mask work (the mask is a
// compile-time branch), and each p is one FFMA and one ex2.approx.  Not
// done yet: overlapping one tile's softmax with the next tile's products
// inside a warpgroup (issuing P·V behind the next S = Q Kᵀ, with this
// loop, ran slower), and more than two warpgroups of rows a block.
//
// The backward at the same shape: dQ's 193.3 GFLOP (S, dP, dS K) take
// 0.195 ms at the bf16 rate, dK/dV's 257.8 GFLOP (S, dP, Pᵀ dO, dSᵀ Q)
// 0.261 ms; both are bound by operations.  The FMA backward kernels ran at
// about 57x those bounds on the CUDA cores.  The wgmma kernels put every
// product on the tensor cores; what is left on the CUDA cores is one ex2,
// two FFMAs and a multiply an entry, plus the mask on partial tiles.  Rows
// past Sq are hidden by the mask in dK/dV (a tile with such rows is never
// taken as full), since their Q and dO read zeros and their L and Δ another
// head's values.  dQ holds 32 + 32 + DP / 2 float32 a thread, dK/dV 64 +
// DP (192 at DP 128, over the 168 registers 384 threads leave each), so its
// producer warpgroup hands its registers to the consumers (setmaxnreg): one
// block an SM.
//
// What the tensor-core design had to get right:
// - The 128-byte swizzle is the same in the TMA maps and the wgmma
//   descriptors (layout type 1, 8-row groups 1,024 bytes apart, tiles on
//   1,024-byte boundaries); a mismatch would give wrong numbers silently.
//   A K-major k16 step moves the descriptor 32 bytes into its atom.
// - A box is 64 bf16 columns, one swizzle atom: D = 128 takes two atoms
//   (the N-major V descriptor steps between them by its leading offset),
//   and D = 120 relies on TMA's zero fill past column 120 to pad the
//   product's depth to 128.  D % 8 == 0 keeps each row stride a multiple of
//   16 bytes, as TMA requires.
// - The maps are 3-D (b·h, S, D), so a ragged last tile (96 rows; a
//   128-row q tile over 64 rows) reads zeros, not the next head's rows;
//   rows past Sq are never written.
// - cuTensorMapEncodeTiled is a driver call and the library is built
//   without -lcuda: it is reached through cudaGetDriverEntryPoint, and the
//   maps are encoded on the host for each call and passed as
//   __grid_constant__ parameters.
// - The ring's slots hold up to 128 KB, over the 48 KB default, so the
//   launch raises the limit first (prepare) and checks cudaGetLastError().
//
// Layout of the FMA kernels: 256 threads as 16 x 16; thread (ty, tx) owns
// tile rows ty + 16a and columns tx + 16c (a, c < 4) of a 64 x 64 logit
// tile, and columns
// tx + 16c (c < DC = ceil(D / 16)) of a D-wide output row.  Tiles of q, k, v
// and dO are staged in shared memory as float32 with rows padded to D + 1
// floats, so the 16 threads of a half-warp reading 16 rows at one column hit
// 16 banks.  D ≤ 128: the dK/dV kernel's six tiles take 166 KB there.
#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64, THREADS = 256, PS = BK + 1;  // BK: hopper.cuh
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

// ------------------------------------------------------------------------ //
// The bf16 forward on Hopper's tensor cores: TMA loads, wgmma products.      //
// ------------------------------------------------------------------------ //

constexpr int WQ = 128;                   // q rows a block: two consumer warpgroups of 64
constexpr int WTHREADS = 288;             // 8 consumer warps + 1 producer warp

// can any row of q rows [q_first, q_first + n) see any key of [k0, k0 + nk)?
__device__ __forceinline__ bool span_needed(const Mask& mk, int q_first, int n, int k0,
                                            int nk = BK) {
  if (q_first >= mk.Sq || k0 >= mk.Skv) return false;
  const int first_q = q_first + mk.q_offset, last_q = min(q_first + n, mk.Sq) - 1 + mk.q_offset;
  const int last_k = min(k0 + nk, mk.Skv) - 1;
  if (mk.causal && k0 > last_q) return false;
  if (mk.window > 0 && last_k <= first_q - mk.window) return false;
  return true;
}

// does every row of [q_first, q_first + n) below Sq see every key of the tile?
__device__ __forceinline__ bool span_full(const Mask& mk, int q_first, int n, int k0) {
  if (k0 + BK > mk.Skv) return false;
  const int first_q = q_first + mk.q_offset, last_q = min(q_first + n, mk.Sq) - 1 + mk.q_offset;
  if (mk.causal && k0 + BK - 1 > first_q) return false;
  if (mk.window > 0 && k0 <= last_q - mk.window) return false;
  return true;
}

// The online-softmax step of one 64-key tile for this thread's two rows.
// `sv` holds the raw products q·k: register i is row r0 + 8 ((i >> 1) & 1),
// key k0 + 8 (i >> 2) + 2 t + (i & 1).  MASKED tiles (a row of the
// warpgroup sees only part of them) set hidden logits to −inf first.  m is
// the running max of the raw products (scale > 0, so it is the max of the
// scaled ones), l this thread's part of the denominator.  P leaves as bf16
// pairs, the A operand of P·V; alpha rescales the accumulator.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&sv)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], uint32_t (&pa)[16], float sc2,
                                             const Mask& mk, int r0, int k0, int t) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (MASKED && !mk.visible(r0 + 8 * ((i >> 1) & 1), k0 + 8 * (i >> 2) + 2 * t + (i & 1)))
      sv[i] = -CUDART_INF_F;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sv[i]);
  }
  float mb[2];  // the new max in base-2 logit units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mnew = fmaxf(m[r], mx[r]);
    // a row that has seen no key keeps alpha 1 and p = 0; once it has,
    // alpha = 2^((m − mnew) sc2), which is 0 while m is still −inf
    alpha[r] = mnew == -CUDART_INF_F ? 1.0f : ex2((m[r] - mnew) * sc2);
    mb[r] = mnew == -CUDART_INF_F ? 0.0f : mnew * sc2;
    m[r] = mnew;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int r = j & 1;  // registers 2j, 2j + 1 share row r0 + 8 (j & 1)
    const float p0 = ex2(fmaf(sv[2 * j], sc2, -mb[r]));  // hidden: 2^−inf = 0
    const float p1 = ex2(fmaf(sv[2 * j + 1], sc2, -mb[r]));
    l[r] += p0 + p1;
    pa[j] = pack_bf16(p0, p1);
  }
}

template <int DP>
struct WgmmaShape {
  static constexpr int ATOMS = DP / 64;                    // 128-byte swizzle atoms per row
  static constexpr int STAGES = DP == 64 ? 4 : 3;          // K/V ring depth
  static constexpr int Q_ATOM = WQ * ATOM_ROW;             // bytes of one atom column of Q
  static constexpr int KV_ATOM = BK * ATOM_ROW;            // ... of K or V
  static constexpr int Q_BYTES = ATOMS * Q_ATOM;
  static constexpr int KV_BYTES = ATOMS * KV_ATOM;         // one K (or V) tile
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // + alignment slack
  // the backward: dQ holds Q and dO of 128 rows and rings K and V of 64;
  // dK/dV holds K and V of 128 keys and rings Q and dO of 64 rows with their
  // L and Δ (64 float32 each)
  static constexpr int ROW_BYTES = 64 * 4;
  static constexpr int DQ_SMEM = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
  static constexpr int DKDV_SMEM = 2 * Q_BYTES + STAGES * (2 * KV_BYTES + 2 * ROW_BYTES) + 1024;
};

// One block: 128 query rows of one (b, q-head).  Warps 0-7 are two consumer
// warpgroups of 64 rows; warp 8 is the producer, one lane of which issues
// every TMA load: Q once, then the needed K and V tiles in order through a
// ring of STAGES slots (`full` completes on the bytes, `empty` on the eight
// consumer warps).  D is the head width, DP = 64 or 128 its padded width:
// TMA fills the columns past D (and rows past Sq or Skv) with zeros.
// D <= 64 keeps few enough registers for two blocks an SM (their slots take
// 81 KB of shared memory each).
template <int DP>
__global__ void __launch_bounds__(WTHREADS, DP == 64 ? 2 : 1)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, int Hq, int Hkv, int D, float scale,
               Mask mk, __nv_bfloat16* __restrict__ o, float* __restrict__ o32,
               float* __restrict__ lse) {
  using W = WgmmaShape<DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, kv_full[W::STAGES], kv_empty[W::STAGES];
  uint8_t* base = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* qs = base;
  uint8_t* ks = qs + W::Q_BYTES;
  uint8_t* vs = ks + W::STAGES * W::KV_BYTES;

  const int bh = blockIdx.x, b = bh / Hq, h = bh - b * Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int nq = gridDim.y;
  const int qt = mk.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;  // longest first
  const int q0 = qt * WQ, Sq = mk.Sq;
  const int nk = (mk.Skv + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&q_full, W::Q_BYTES);
      for (int a = 0; a < W::ATOMS; ++a) tma_load(qs + a * W::Q_ATOM, &tm_q, &q_full, 64 * a, q0, bh);
      int it = 0;
      for (int kb = 0; kb < nk; ++kb) {
        const int k0 = kb * BK;
        if (!span_needed(mk, q0, WQ, k0)) continue;
        const int s = it % W::STAGES;
        mbar_wait(&kv_empty[s], ((it / W::STAGES) & 1) ^ 1);
        mbar_expect_tx(&kv_full[s], 2 * W::KV_BYTES);
        for (int a = 0; a < W::ATOMS; ++a) {
          tma_load(ks + s * W::KV_BYTES + a * W::KV_ATOM, &tm_k, &kv_full[s], 64 * a, k0, bkv);
          tma_load(vs + s * W::KV_BYTES + a * W::KV_ATOM, &tm_v, &kv_full[s], 64 * a, k0, bkv);
        }
        ++it;
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg + [0, 64); this thread rows
  // r0 and r0 + 8 of them, and of each 8-column block the two columns 2 t, 2 t + 1
  const int wg = warp >> 2, t = lane & 3;
  const int qw = q0 + 64 * wg;
  const int r0 = qw + 16 * (warp & 3) + (lane >> 2);
  const float sc2 = scale * LOG2E;  // scaled logits in base 2
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};  // l: this thread's part
  const uint8_t* qw_smem = qs + 64 * wg * ATOM_ROW;

  mbar_wait(&q_full, 0);
  int it = 0;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    if (!span_needed(mk, q0, WQ, k0)) continue;
    const int s = it % W::STAGES;
    mbar_wait(&kv_full[s], (it / W::STAGES) & 1);
    if (span_needed(mk, qw, 64, k0)) {
      const uint8_t* kt = ks + s * W::KV_BYTES;
      const uint8_t* vt = vs + s * W::KV_BYTES;
      float sv[32];  // S = Q Kᵀ
      fence_regs(sv);
      wgmma_fence();
      product_ss<DP>(sv, qw_smem, W::Q_ATOM, kt, W::KV_ATOM);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sv);

      float alpha[2];
      uint32_t pa[16];
      if (span_full(mk, qw, 64, k0))
        softmax_tile<false>(sv, m, l, alpha, pa, sc2, mk, r0, k0, t);
      else
        softmax_tile<true>(sv, m, l, alpha, pa, sc2, mk, r0, k0, t);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V over 4 steps of 16 keys; V is read N-major (transposed)
      fence_regs(acc);
      wgmma_fence();
      product_rs<DP>(acc, pa, vt);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    if (lane == 0) mbar_arrive(&kv_empty[s]);
    ++it;
  }

  // epilogue: the quad's partial denominators, then O = acc / l and L = m + log l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    const long long g = (long long)bh * Sq + row;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int col = 8 * nb + 2 * t;
      if (col >= D) continue;
      const float v0 = acc[4 * nb + 2 * r] / den, v1 = acc[4 * nb + 2 * r + 1] / den;
      *reinterpret_cast<__nv_bfloat162*>(o + g * D + col) = __floats2bfloat162_rn(v0, v1);
      if (o32 != nullptr) *reinterpret_cast<float2*>(o32 + g * D + col) = make_float2(v0, v1);
    }
    if (t == 0) lse[g] = l[r] > 0.0f ? m[r] * scale + logf(l[r]) : CUDART_INF_F;
  }
}

// ------------------------------------------------------------------------ //
// The bf16 backward on Hopper's tensor cores.                                //
// ------------------------------------------------------------------------ //

constexpr int BKV = 128;  // keys a dK/dV block: two consumer warpgroups of 64
// dK/dV: 8 consumer warps and a producer warpgroup, which keeps 40 registers
// a thread and gives the rest to the consumers (232: dK and dV take DP
// float32 a thread, Sᵀ and dPᵀ 64 more)
constexpr int BTHREADS = 384, PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// dQ's P and dS of one 64-key tile for this thread's two rows: register i of
// `sv` (S) and `dp` (dP) is row r0 + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) +
// 2 t + (i & 1).  lb is the row's L in base 2 (+inf for a row that sees no
// key or lies past Sq, so p = 0), dl its Δ.  dS leaves as bf16 pairs, the A
// operand of dS K.
template <bool MASKED>
__device__ __forceinline__ void dscores(const float (&sv)[32], const float (&dp)[32],
                                        uint32_t (&da)[16], const float (&lb)[2],
                                        const float (&dl)[2], float sc2, const Mask& mk, int r0,
                                        int k0, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int r = j & 1;  // registers 2j, 2j + 1 share row r0 + 8 (j & 1)
    float ds[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p = ex2(fmaf(sv[2 * j + e], sc2, -lb[r]));
      if (MASKED && !mk.visible(r0 + 8 * r, k0 + 8 * (j >> 1) + 2 * t + e)) p = 0.0f;
      ds[e] = p * (dp[2 * j + e] - dl[r]);
    }
    da[j] = pack_bf16(ds[0], ds[1]);
  }
}

// dK/dV's Pᵀ and dSᵀ of one (kv tile, q tile) pair: register i of `st` (Sᵀ)
// and `dpt` (dPᵀ) is key kr + 8 ((i >> 1) & 1), query q0 + 8 (i >> 2) + 2 t +
// (i & 1).  The tile's L and Δ are 64 float32 in shared memory, by query; a
// query past Sq is hidden by the mask (its tile is never taken as full).
template <bool MASKED>
__device__ __forceinline__ void probs_t(const float (&st)[32], const float (&dpt)[32],
                                        uint32_t (&pa)[16], uint32_t (&da)[16], const float* lt,
                                        const float* dt, float sc2, const Mask& mk, int q0,
                                        int kr, int t) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = 8 * c + 2 * t;
    const float2 lv = *reinterpret_cast<const float2*>(lt + col);
    const float2 dv = *reinterpret_cast<const float2*>(dt + col);
    const float lb[2] = {lv.x * LOG2E, lv.y * LOG2E}, dd[2] = {dv.x, dv.y};
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // registers 4c + 2r + e: key kr + 8r, query col + e
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * c + 2 * r + e;
        p[e] = ex2(fmaf(st[i], sc2, -lb[e]));
        if (MASKED && !mk.visible(q0 + col + e, kr + 8 * r)) p[e] = 0.0f;
        ds[e] = p[e] * (dpt[i] - dd[e]);
      }
      pa[2 * c + r] = pack_bf16(p[0], p[1]);
      da[2 * c + r] = pack_bf16(ds[0], ds[1]);
    }
  }
}

// dQ: one block per (b, q-head, 128-row q tile), launched longest-first
// under the causal mask; warps 0-7 are two consumer warpgroups of 64 rows,
// warp 8 the producer, which loads Q and dO once and then the visible K and V
// tiles in order through the ring, as the forward does.  Each consumer
// thread first computes Δ of its two rows from the float32 O (its columns in
// order, then the quad's four parts by two shuffles) and writes it out for
// dK/dV.  Per tile: S = Q Kᵀ and dP = dO Vᵀ (shared x shared), P and dS in
// registers, dQ += dS K (dS as the register A operand, K read N-major).
template <int DP>
__global__ void __launch_bounds__(WTHREADS, 1)
attn_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ o32,
                  const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse, int Hq,
                  int Hkv, int D, float scale, Mask mk, float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq) {
  using W = WgmmaShape<DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, kv_full[W::STAGES], kv_empty[W::STAGES];
  uint8_t* base = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* qs = base;
  uint8_t* dos = qs + W::Q_BYTES;
  uint8_t* ks = dos + W::Q_BYTES;
  uint8_t* vs = ks + W::STAGES * W::KV_BYTES;

  const int bh = blockIdx.x, b = bh / Hq, h = bh - b * Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int nq = gridDim.y;
  const int qt = mk.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;  // longest first
  const int q0 = qt * WQ, Sq = mk.Sq;
  const int nk = (mk.Skv + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&q_full, 2 * W::Q_BYTES);
      for (int a = 0; a < W::ATOMS; ++a) {
        tma_load(qs + a * W::Q_ATOM, &tm_q, &q_full, 64 * a, q0, bh);
        tma_load(dos + a * W::Q_ATOM, &tm_do, &q_full, 64 * a, q0, bh);
      }
      int it = 0;
      for (int kb = 0; kb < nk; ++kb) {
        const int k0 = kb * BK;
        if (!span_needed(mk, q0, WQ, k0)) continue;
        const int s = it % W::STAGES;
        mbar_wait(&kv_empty[s], ((it / W::STAGES) & 1) ^ 1);
        mbar_expect_tx(&kv_full[s], 2 * W::KV_BYTES);
        for (int a = 0; a < W::ATOMS; ++a) {
          tma_load(ks + s * W::KV_BYTES + a * W::KV_ATOM, &tm_k, &kv_full[s], 64 * a, k0, bkv);
          tma_load(vs + s * W::KV_BYTES + a * W::KV_ATOM, &tm_v, &kv_full[s], 64 * a, k0, bkv);
        }
        ++it;
      }
    }
    return;
  }

  const int wg = warp >> 2, t = lane & 3;
  const int qw = q0 + 64 * wg;
  const int r0 = qw + 16 * (warp & 3) + (lane >> 2);
  const float sc2 = scale * LOG2E;
  float lb[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // Δ and L of rows r0 and r0 + 8
    const int row = r0 + 8 * r;
    const long long g = (long long)bh * Sq + row;
    float acc = 0.0f;
    if (row < Sq) {
#pragma unroll
      for (int nb = 0; nb < DP / 8; ++nb) {
        const int col = 8 * nb + 2 * t;
        if (col >= D) continue;
        const float2 o = *reinterpret_cast<const float2*>(o32 + g * D + col);
        const float2 d = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + g * D + col));
        acc = fmaf(d.x, o.x, acc);
        acc = fmaf(d.y, o.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[r] = acc;
    lb[r] = row < Sq ? lse[g] * LOG2E : CUDART_INF_F;
    if (row < Sq && t == 0) delta[g] = acc;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  const uint8_t* qw_smem = qs + 64 * wg * ATOM_ROW;
  const uint8_t* dow_smem = dos + 64 * wg * ATOM_ROW;

  mbar_wait(&q_full, 0);
  int it = 0;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    if (!span_needed(mk, q0, WQ, k0)) continue;
    const int s = it % W::STAGES;
    mbar_wait(&kv_full[s], (it / W::STAGES) & 1);
    if (span_needed(mk, qw, 64, k0)) {
      const uint8_t* kt = ks + s * W::KV_BYTES;
      const uint8_t* vt = vs + s * W::KV_BYTES;
      float sv[32], dp[32];
      fence_regs(sv);
      fence_regs(dp);
      wgmma_fence();
      product_ss<DP>(sv, qw_smem, W::Q_ATOM, kt, W::KV_ATOM);   // S = Q Kᵀ
      product_ss<DP>(dp, dow_smem, W::Q_ATOM, vt, W::KV_ATOM);  // dP = dO Vᵀ
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sv);
      fence_regs(dp);

      uint32_t da[16];
      if (span_full(mk, qw, 64, k0))
        dscores<false>(sv, dp, da, lb, dl, sc2, mk, r0, k0, t);
      else
        dscores<true>(sv, dp, da, lb, dl, sc2, mk, r0, k0, t);

      fence_regs(acc);
      wgmma_fence();
      product_rs<DP>(acc, da, kt);  // dQ += dS K
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    if (lane == 0) mbar_arrive(&kv_empty[s]);
    ++it;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    const long long g = (long long)bh * Sq + row;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int col = 8 * nb + 2 * t;
      if (col >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(dq + g * D + col) =
          __floats2bfloat162_rn(scale * acc[4 * nb + 2 * r], scale * acc[4 * nb + 2 * r + 1]);
    }
  }
}

// dK/dV: one block per (b, kv-head, 128-key tile), the tile that the most q
// tiles see first under the causal mask; warps 0-7 are two consumer
// warpgroups of 64 keys, warps 8-11 the producer warpgroup.  It loads K and V once, then
// walks the q-heads of the group in order and, for each, the q tiles of 64
// rows that see the kv tile, in order: Q, dO and their L and Δ rows through
// the ring (the rows by 1-D maps over the flat (b, h, row) arrays).  Per q
// tile: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (shared x shared), Pᵀ and dSᵀ in registers,
// dV += Pᵀ dO and dK += dSᵀ Q (register A operands, dO and Q read N-major).
// The group's sum stays in the block's registers: no atomics.
template <int DP>
__global__ void __launch_bounds__(BTHREADS, 1)
attn_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_l,
                    const __grid_constant__ CUtensorMap tm_d, int Hq, int Hkv, int D,
                    float scale, Mask mk, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv) {
  using W = WgmmaShape<DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[W::STAGES], empty[W::STAGES];
  uint8_t* base = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* ks = base;  // K and V: 128-row tiles
  uint8_t* vs = ks + W::Q_BYTES;
  uint8_t* qs = vs + W::Q_BYTES;  // the ring of Q and dO: 64-row tiles
  uint8_t* dos = qs + W::STAGES * W::KV_BYTES;
  float* ls = reinterpret_cast<float*>(dos + W::STAGES * W::KV_BYTES);  // L, 64 a slot
  float* dls = ls + W::STAGES * 64;                                      // Δ, 64 a slot

  const int bkv = blockIdx.x, b = bkv / Hkv, hk = bkv - b * Hkv, group = Hq / Hkv;
  const int k0 = (int)blockIdx.y * BKV, Sq = mk.Sq, Skv = mk.Skv;
  const int nq = (Sq + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup; one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(&kv_full, 2 * W::Q_BYTES);
      for (int a = 0; a < W::ATOMS; ++a) {
        tma_load(ks + a * W::Q_ATOM, &tm_k, &kv_full, 64 * a, k0, bkv);
        tma_load(vs + a * W::Q_ATOM, &tm_v, &kv_full, 64 * a, k0, bkv);
      }
      int it = 0;
      for (int g = 0; g < group; ++g) {
        const int bh = b * Hq + hk * group + g;
        for (int qb = 0; qb < nq; ++qb) {
          const int q0 = qb * BK;
          if (!span_needed(mk, q0, BK, k0, BKV)) continue;
          const int s = it % W::STAGES;
          mbar_wait(&empty[s], ((it / W::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * W::KV_BYTES + 2 * W::ROW_BYTES);
          for (int a = 0; a < W::ATOMS; ++a) {
            tma_load(qs + s * W::KV_BYTES + a * W::KV_ATOM, &tm_q, &full[s], 64 * a, q0, bh);
            tma_load(dos + s * W::KV_BYTES + a * W::KV_ATOM, &tm_do, &full[s], 64 * a, q0, bh);
          }
          tma_load_1d(ls + s * 64, &tm_l, &full[s], bh * Sq + q0);
          tma_load_1d(dls + s * 64, &tm_d, &full[s], bh * Sq + q0);
          ++it;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys kw + [0, 64); this thread keys kr and
  // kr + 8, and of each 8-query block the two queries 2 t, 2 t + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2, t = lane & 3;
  const int kw = k0 + 64 * wg;
  const int kr = kw + 16 * (warp & 3) + (lane >> 2);
  const float sc2 = scale * LOG2E;
  float gk[DP / 2], gv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) gk[i] = gv[i] = 0.0f;
  const uint8_t* kw_smem = ks + 64 * wg * ATOM_ROW;
  const uint8_t* vw_smem = vs + 64 * wg * ATOM_ROW;

  mbar_wait(&kv_full, 0);
  int it = 0;
  for (int g = 0; g < group; ++g) {
    for (int qb = 0; qb < nq; ++qb) {
      const int q0 = qb * BK;
      if (!span_needed(mk, q0, BK, k0, BKV)) continue;
      const int s = it % W::STAGES;
      mbar_wait(&full[s], (it / W::STAGES) & 1);
      if (span_needed(mk, q0, BK, kw, 64)) {
        const uint8_t* qt = qs + s * W::KV_BYTES;
        const uint8_t* dot = dos + s * W::KV_BYTES;
        float st[32], dpt[32];
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
        product_ss<DP>(st, kw_smem, W::Q_ATOM, qt, W::KV_ATOM);    // Sᵀ = K Qᵀ
        product_ss<DP>(dpt, vw_smem, W::Q_ATOM, dot, W::KV_ATOM);  // dPᵀ = V dOᵀ
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);

        uint32_t pa[16], da[16];
        if (q0 + BK <= Sq && span_full(mk, q0, BK, kw))
          probs_t<false>(st, dpt, pa, da, ls + s * 64, dls + s * 64, sc2, mk, q0, kr, t);
        else
          probs_t<true>(st, dpt, pa, da, ls + s * 64, dls + s * 64, sc2, mk, q0, kr, t);

        fence_regs(gv);
        fence_regs(gk);
        wgmma_fence();
        product_rs<DP>(gv, pa, dot);  // dV += Pᵀ dO
        product_rs<DP>(gk, da, qt);   // dK += dSᵀ Q
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(gv);
        fence_regs(gk);
      }
      if (lane == 0) mbar_arrive(&empty[s]);
      ++it;
    }
  }

  // epilogue: dK = scale · Σ dSᵀ Q in float32, then both in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kr + 8 * r;
    if (row >= Skv) continue;
    const long long g = (long long)bkv * Skv + row;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int col = 8 * nb + 2 * t;
      if (col >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(dk + g * D + col) =
          __floats2bfloat162_rn(scale * gk[4 * nb + 2 * r], scale * gk[4 * nb + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + g * D + col) =
          __floats2bfloat162_rn(gv[4 * nb + 2 * r], gv[4 * nb + 2 * r + 1]);
    }
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

// ---------------------------------------------------------------- wgmma host --

// a (heads, S, D) bf16 tensor as a 3-D map with boxes of 64 columns x `rows`
// rows of one head, in the 128-byte swizzle; out of range reads give zeros.
// The encoder needs the device's context current in the calling thread, and
// a thread that has made no runtime call yet (autograd's backward thread, or
// any new one) has none: the launchers call prepare() first, whose
// cudaFuncSetAttribute binds it.
int encode_map(CUtensorMap* map, const void* ptr, int heads, int S, int D, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// n float32 (the flat (b, h, row) L or Δ) as a 1-D map with boxes of 64;
// reads past n give zeros
int encode_rows(CUtensorMap* map, const void* ptr, long long n) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};  // a 1-D map has no stride
  const cuuint32_t box[1] = {64};
  const cuuint32_t unit[1] = {1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// what the tensor-core kernels take: bf16, D <= 128 with D % 8 == 0 (TMA
// needs 16-byte row strides), grids and flat row indices within range
bool wgmma_shape_ok(int dtype, int B, int Hq, int Hkv, int Sq, int Skv, int D) {
  return dtype == 1 && D > 0 && D <= 128 && D % 8 == 0 && B > 0 && Hq > 0 && Hkv > 0 &&
         Hq % Hkv == 0 && Sq > 0 && Skv > 0 && (Sq + WQ - 1) / WQ <= 65535 &&
         (Skv + BKV - 1) / BKV <= 65535 && (long long)B * Hq * Sq < (1LL << 31);
}

template <int DP>
int run_wgmma(const Args& a) {
  using W = WgmmaShape<DP>;
  const int Sq = a.mk.Sq, Skv = a.mk.Skv;
  CUtensorMap tq, tk, tv;
  int e;
  if ((e = prepare(attn_fwd_wgmma<DP>, W::SMEM)) != 0) return e;  // before the maps
  if ((e = encode_map(&tq, a.q, a.B * a.Hq, Sq, a.D, WQ)) != 0) return e;
  if ((e = encode_map(&tk, a.k, a.B * a.Hkv, Skv, a.D, BK)) != 0) return e;
  if ((e = encode_map(&tv, a.v, a.B * a.Hkv, Skv, a.D, BK)) != 0) return e;
  // all of the SM's unified memory as shared memory, so two blocks fit at D <= 64
  if ((e = (int)cudaFuncSetAttribute(attn_fwd_wgmma<DP>,
                                     cudaFuncAttributePreferredSharedMemoryCarveout, 100)) != 0)
    return e;
  const dim3 grid((unsigned)(a.B * a.Hq), (unsigned)((Sq + WQ - 1) / WQ));
  attn_fwd_wgmma<DP><<<grid, WTHREADS, (size_t)W::SMEM, a.st>>>(
      tq, tk, tv, a.Hq, a.Hkv, a.D, a.scale, a.mk, (__nv_bfloat16*)a.o, (float*)a.o32_out,
      (float*)a.lse_out);
  return (int)cudaGetLastError();
}

template <int DP>
int run_bwd_dq_wgmma(const Args& a) {
  using W = WgmmaShape<DP>;
  const int Sq = a.mk.Sq, Skv = a.mk.Skv;
  CUtensorMap tq, tdo, tk, tv;
  int e;
  if ((e = prepare(attn_bwd_dq_wgmma<DP>, W::DQ_SMEM)) != 0) return e;  // before the maps
  if ((e = encode_map(&tq, a.q, a.B * a.Hq, Sq, a.D, WQ)) != 0) return e;
  if ((e = encode_map(&tdo, a.dout, a.B * a.Hq, Sq, a.D, WQ)) != 0) return e;
  if ((e = encode_map(&tk, a.k, a.B * a.Hkv, Skv, a.D, BK)) != 0) return e;
  if ((e = encode_map(&tv, a.v, a.B * a.Hkv, Skv, a.D, BK)) != 0) return e;
  const dim3 grid((unsigned)(a.B * a.Hq), (unsigned)((Sq + WQ - 1) / WQ));
  attn_bwd_dq_wgmma<DP><<<grid, WTHREADS, (size_t)W::DQ_SMEM, a.st>>>(
      tq, tdo, tk, tv, (const float*)a.o32, (const __nv_bfloat16*)a.dout, (const float*)a.lse,
      a.Hq, a.Hkv, a.D, a.scale, a.mk, (float*)a.delta, (__nv_bfloat16*)a.dq);
  return (int)cudaGetLastError();
}

template <int DP>
int run_bwd_dkdv_wgmma(const Args& a) {
  using W = WgmmaShape<DP>;
  const int Sq = a.mk.Sq, Skv = a.mk.Skv;
  CUtensorMap tq, tdo, tk, tv, tl, td;
  int e;
  if ((e = prepare(attn_bwd_dkdv_wgmma<DP>, W::DKDV_SMEM)) != 0) return e;  // before the maps
  if ((e = encode_map(&tq, a.q, a.B * a.Hq, Sq, a.D, BK)) != 0) return e;
  if ((e = encode_map(&tdo, a.dout, a.B * a.Hq, Sq, a.D, BK)) != 0) return e;
  if ((e = encode_map(&tk, a.k, a.B * a.Hkv, Skv, a.D, BKV)) != 0) return e;
  if ((e = encode_map(&tv, a.v, a.B * a.Hkv, Skv, a.D, BKV)) != 0) return e;
  if ((e = encode_rows(&tl, a.lse, (long long)a.B * a.Hq * Sq)) != 0) return e;
  if ((e = encode_rows(&td, a.delta, (long long)a.B * a.Hq * Sq)) != 0) return e;
  const dim3 grid((unsigned)(a.B * a.Hkv), (unsigned)((Skv + BKV - 1) / BKV));
  attn_bwd_dkdv_wgmma<DP><<<grid, BTHREADS, (size_t)W::DKDV_SMEM, a.st>>>(
      tq, tdo, tk, tv, tl, td, a.Hq, a.Hkv, a.D, a.scale, a.mk, (__nv_bfloat16*)a.dk,
      (__nv_bfloat16*)a.dv);
  return (int)cudaGetLastError();
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

// The bf16 forward on the tensor cores (attn_fwd_wgmma): the arguments of
// repro_flash_fwd, for bfloat16 (dtype 1) with D <= 128 and D % 8 == 0 only.
REPRO_EXPORT int repro_flash_fwd_wgmma(const void* q, const void* k, const void* v, int B,
                                       int Hq, int Hkv, int Sq, int Skv, int D, float scale,
                                       int causal, int window, int q_offset, int dtype, void* o,
                                       void* o32, void* lse, void* stream) {
  if (!wgmma_shape_ok(dtype, B, Hq, Hkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q; a.k = k; a.v = v;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.D = D; a.scale = scale;
  a.mk = make_mask(Sq, Skv, causal, window, q_offset);
  a.o = o; a.o32_out = o32; a.lse_out = lse;
  a.st = (cudaStream_t)stream;
  return D <= 64 ? run_wgmma<64>(a) : run_wgmma<128>(a);
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

// The bf16 backward on the tensor cores (attn_bwd_dq_wgmma, then
// attn_bwd_dkdv_wgmma): the arguments of repro_flash_bwd_dq and
// repro_flash_bwd_dkdv, for bfloat16 (dtype 1) with D <= 128 and D % 8 == 0
// only.  lse and delta must be 16-byte aligned (TMA reads them).
REPRO_EXPORT int repro_flash_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                          const void* o32, const void* dout, const void* lse,
                                          int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                          float scale, int causal, int window, int q_offset,
                                          int dtype, void* delta, void* dq, void* stream) {
  if (!wgmma_shape_ok(dtype, B, Hq, Hkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o32 = o32; a.dout = dout; a.lse = lse;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.D = D; a.scale = scale;
  a.mk = make_mask(Sq, Skv, causal, window, q_offset);
  a.delta = delta; a.dq = dq;
  a.st = (cudaStream_t)stream;
  return D <= 64 ? run_bwd_dq_wgmma<64>(a) : run_bwd_dq_wgmma<128>(a);
}

REPRO_EXPORT int repro_flash_bwd_dkdv_wgmma(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, int B, int Hq, int Hkv, int Sq,
                                            int Skv, int D, float scale, int causal, int window,
                                            int q_offset, int dtype, void* dk, void* dv,
                                            void* stream) {
  if (!wgmma_shape_ok(dtype, B, Hq, Hkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.D = D; a.scale = scale;
  a.mk = make_mask(Sq, Skv, causal, window, q_offset);
  a.delta = const_cast<void*>(delta); a.dk = dk; a.dv = dv;
  a.st = (cudaStream_t)stream;
  return D <= 64 ? run_bwd_dkdv_wgmma<64>(a) : run_bwd_dkdv_wgmma<128>(a);
}
