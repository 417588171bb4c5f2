"""The port's attention against the JAX package's, on the CPU.

The plain version (what the ``flash_attention`` wrapper runs on a CPU
tensor) is held against the JAX Pallas ``flash_attention`` in interpret mode
and ``ref.attention_ref`` over the sweep of ``tests/test_kernels.py``, and
its autograd gradients against ``jax.grad`` of ``ref.attention_ref`` and
``ref.attention_xla_chunked`` (the Pallas call itself cannot be
differentiated).  Then the layers, the attention block (with and without a
cache, the ring buffer included) and whole-model forwards on the JAX
parameters carried over by ``params_from_numpy``.

Tolerances: in float32 the outputs agree to 2e-5 (the reference's own
kernel tolerance) and the gradients to 1e-5 of the largest |value| (sums in
another order); in bfloat16 outputs agree to 2e-2, the reference's bf16
kernel tolerance.  Model logits: float32 within 1e-5 of the largest
|logit|; bfloat16 within 2^-5 of it (bf16 rounds at a few dozen places per
layer, in another order in each package).
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import attention as jatt
from repro.models import init_model as j_init_model
from repro.models import layers as jlayers
from repro.models.base import ShardCtx as JShardCtx
from repro.models.lm import forward as j_forward
from repro.serve.engine import greedy_generate as j_generate
from repro.serve.engine import make_serve_fns as j_serve_fns
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlayers
from repro_torch.models import params_from_numpy
from repro_torch.models.base import SINGLE
from repro_torch.models.lm import forward as t_forward
from repro_torch.serve import greedy_generate, make_serve_fns


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _qkv(rng, B, Hq, Hkv, Sq, D, Skv=None):
    Skv = Skv or Sq
    return (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


# --------------------------------------------------------------- the kernel --
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (1, 2, 2, 128, 64),    # MHA
    (2, 8, 2, 256, 64),    # GQA 4:1
    (1, 4, 1, 256, 128),   # MQA
    (1, 3, 1, 128, 64),    # odd head count
    (1, 16, 1, 256, 256),  # MQA group 16 at RecurrentGemma's head dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_vs_pallas_and_ref(B, Hq, Hkv, S, D, dtype):
    q, k, v = _qkv(_rng("sweep", B, Hq, S, D, dtype), B, Hq, Hkv, S, D)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = tfa.flash_attention(_t(q, td), _t(k, td), _t(v, td), causal=True)
    assert got.dtype == td
    got = got.float().numpy()
    tol = 2e-5 if dtype == "float32" else 2e-2
    pallas = j_flash(_j(q, jd), _j(k, jd), _j(v, jd), causal=True, interpret=True)
    oracle = jref.attention_ref(_j(q, jd), _j(k, jd), _j(v, jd), causal=True)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window,Sq,Skv,q_offset", [
    (True, None, 256, 256, 0), (False, None, 256, 256, 0), (True, 64, 256, 256, 0),
    (True, 128, 256, 256, 0), (True, None, 1, 512, 511), (True, None, 128, 384, 256),
    (True, 32, 128, 384, 256), (False, 32, 128, 128, 0),
])
def test_plain_attention_masks_vs_pallas_and_ref(causal, window, Sq, Skv, q_offset):
    """Causal or not, windows, decode (Sq = 1) and q_offset > 0 with
    Sq < Skv (with a window, a row's first kv blocks are all hidden)."""
    q, k, v = _qkv(_rng("mask", causal, window, Sq, q_offset), 1, 4, 2, Sq, 64, Skv)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), **mask).numpy()
    pallas = j_flash(_j(q), _j(k), _j(v), interpret=True, **mask)
    oracle = jref.attention_ref(_j(q), _j(k), _j(v), **mask)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("Sq,window,group", [(128, None, 3), (1024, None, 2), (1024, 48, 1)])
def test_plain_attention_gradients_vs_jax_grad(Sq, window, group):
    """Autograd of the plain version against jax.grad of the reference's
    oracles: ``attention_ref`` up to 512 rows, ``attention_xla_chunked``
    (query blocks of 512, −1e30 fill) beyond."""
    Hkv, D = 2, 32
    q, k, v = _qkv(_rng("grad", Sq, window, group), 1, Hkv * group, Hkv, Sq, D)
    g = _rng("cot", Sq).normal(size=q.shape).astype(np.float32)
    mask = dict(causal=True, window=window)
    oracle = jref.attention_ref if Sq <= 512 else jref.attention_xla_chunked
    jgrads = jax.grad(lambda a, b, c: jnp.sum(oracle(a, b, c, **mask) * _j(g)),
                      argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, **mask)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(oracle(_j(q), _j(k), _j(v),
                                                                       **mask)), atol=2e-5)
    tgrads = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    for name, tg, jg in zip("qkv", tgrads, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-5 * np.abs(jg).max(),
                                   err_msg=f"d{name}")


def test_attention_entry_vs_reference_ops():
    """``ops.attention`` against the JAX ``ops.attention`` on the ``xla``
    path, and the port's two oracles against each other."""
    q, k, v = _qkv(_rng("ops"), 2, 6, 2, 1024, 32)
    with jops.local_backend("xla"):
        want = np.asarray(jops.attention(_j(q), _j(k), _j(v), causal=True, window=100))
    for backend in ("cuda", "torch"):
        with tops.local_backend(backend):
            got = tops.attention(_t(q), _t(k), _t(v), causal=True, window=100).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5)
    ref = tfa.attention_ref(_t(q), _t(k), _t(v), causal=True, window=100).numpy()
    np.testing.assert_allclose(ref, want, atol=2e-5)


@pytest.mark.parametrize("Sq,Skv", [(200, 256), (128, 300), (96 + 128, 96 + 128)])
def test_tiling_contract_raises_for_ragged_lengths(Sq, Skv):
    q, k, v = (torch.zeros(s) for s in ((1, 2, Sq, 16), (1, 2, Skv, 16), (1, 2, Skv, 16)))
    with pytest.raises(ValueError, match="tile"):
        tfa.flash_attention(q, k, v)
    with pytest.raises(ValueError):
        tfa.flash_attention(torch.zeros(1, 2, 64, 16), torch.zeros(1, 2, 64, 16),
                            torch.zeros(1, 2, 64, 16), window=0)


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 120, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "fma"), (torch.float32, 120, "fma"), (torch.float32, 128, "fma"),
    (torch.bfloat16, 100, "fma"), (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 200, "wgmma"),
    (torch.float32, 256, "fma"), (torch.bfloat16, 250, "fma"),
])
def test_forward_route_by_type_and_head_width(dtype, D, route):
    """bf16 with D % 8 == 0 takes the tensor-core kernel; float32 (never
    TF32) and other bf16 widths the FMA kernel."""
    assert tfa.forward_route(dtype, D) == route


@pytest.mark.parametrize("dtype,D,exc", [(torch.bfloat16, 264, ValueError),
                                         (torch.float32, 264, ValueError),
                                         (torch.float16, 64, TypeError)])
def test_forward_route_raises_beyond_the_kernels(dtype, D, exc):
    with pytest.raises(exc):
        tfa.forward_route(dtype, D)


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 120, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "fma"), (torch.float32, 120, "fma"), (torch.float32, 128, "fma"),
    (torch.bfloat16, 100, "fma"), (torch.bfloat16, 256, "wgmma"), (torch.float32, 256, "fma"),
])
def test_backward_route_by_type_and_head_width(dtype, D, route):
    """The backward follows the forward's rule: bf16 with D % 8 == 0 takes
    the tensor-core kernels; float32 (never TF32) and other bf16 widths the
    FMA kernels."""
    assert tfa.backward_route(dtype, D) == route == tfa.forward_route(dtype, D)


@pytest.mark.parametrize("dtype,D,exc", [(torch.bfloat16, 264, ValueError),
                                         (torch.float32, 264, ValueError),
                                         (torch.bfloat16, 0, ValueError),
                                         (torch.float16, 64, TypeError)])
def test_backward_route_raises_beyond_the_kernels(dtype, D, exc):
    with pytest.raises(exc):
        tfa.backward_route(dtype, D)


def _wgmma_forward_model(q, k, v, causal, window, q_offset):
    """The tensor-core forward's arithmetic on the CPU: float32 logits of
    bf16 q and k, scaled after the product, in base 2; online softmax over
    64-key tiles with the denominator summed from float32 p; P rounded to
    bf16 before P·V; a float32 accumulator → (O in float32, the log-sum-exp
    L of the scaled logits, +inf for a row that sees no key)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    sc2 = np.float32(D ** -0.5) * np.float32(np.log2(np.e))
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sc2
    s = s.masked_fill(~tfa._mask(Sq, Skv, causal, window, q_offset, q.device), float("-inf"))
    m = torch.full((B, Hq, Sq, 1), float("-inf"))
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, D))
    for j in range(0, Skv, 64):
        blk = s[..., j:j + 64]
        mnew = torch.maximum(m, blk.amax(-1, keepdim=True))
        seen = mnew > float("-inf")
        alpha = torch.where(seen, torch.exp2(m - mnew), 1.0)
        p = torch.where(seen, torch.exp2(blk - torch.where(seen, mnew, 0.0)), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, j:j + 64]
        m = mnew
    lse = torch.where(l > 0, m * np.float32(np.log(2.0)) + torch.log(l), float("inf"))
    return acc / l.clamp_min(1e-30), lse


def _wgmma_rounding_model(q, k, v, causal, window, q_offset):
    """The tensor-core forward's O, rounded to bf16."""
    return _wgmma_forward_model(q, k, v, causal, window, q_offset)[0].bfloat16()


def _wgmma_backward_model(q, k, v, do, causal, window, q_offset):
    """The tensor-core backward's arithmetic on the CPU: float32 S of bf16 q
    and k, scaled after the product; P = 2^(S·log2 e − L·log2 e) from the
    forward model's L, hidden entries 0; Δ = rowsum(dO ∘ O) from its float32
    O; dS = P ∘ (dO Vᵀ − Δ); P and dS rounded to bf16 before dV = Pᵀ dO,
    dK = scale · dSᵀ Q and dQ = scale · dS K, float32 sums (each GQA group
    summed in float32), each gradient rounded to bf16 once."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = np.float32(D ** -0.5)
    log2e = np.float32(np.log2(np.e))
    o32, lse = _wgmma_forward_model(q, k, v, causal, window, q_offset)
    delta = (do.float() * o32).sum(-1, keepdim=True)
    mask = tfa._mask(Sq, Skv, causal, window, q_offset, q.device)
    dq = torch.zeros((B, Hq, Sq, D))
    dk = torch.zeros((B, Hkv, Skv, D))
    dv = torch.zeros((B, Hkv, Skv, D))
    for b in range(B):
        for h in range(Hq):
            hk = h // group
            qf, kf, vf, dof = q[b, h].float(), k[b, hk].float(), v[b, hk].float(), do[b, h].float()
            s = qf @ kf.T
            p = torch.where(mask, torch.exp2(s * (scale * log2e) - lse[b, h] * log2e), 0.0)
            ds = p * (dof @ vf.T - delta[b, h])
            pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
            dq[b, h] = dsb @ kf
            dk[b, hk] += dsb.T @ qf
            dv[b, hk] += pb.T @ dof
    return (scale * dq).bfloat16(), (scale * dk).bfloat16(), dv.bfloat16()


# the bf16 shapes of chip_smoke.py's ATTN_SHAPES that fit the CPU
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window,q_offset", [
    (1, 2, 2, 128, 128, 64, True, None, 0),
    (4, 8, 1, 128, 128, 128, True, None, 0),
    (2, 3, 1, 256, 256, 64, True, 32, 0),
    (1, 15, 5, 512, 512, 64, True, 4096, 0),
    (1, 4, 2, 128, 384, 64, True, 32, 256),
    (1, 6, 2, 96, 96, 120, False, 32, 0),
    (2, 15, 5, 1024, 1024, 64, True, None, 0),
    (2, 8, 2, 256, 256, 128, False, None, 0),
    (1, 4, 2, 64, 384, 64, True, None, 320),
    (1, 16, 1, 256, 256, 256, True, 64, 0),
    (2, 16, 1, 128, 384, 256, True, 32, 256),
])
def test_wgmma_rounding_model_within_the_card_limit(B, Hq, Hkv, Sq, Skv, D, causal, window,
                                                     q_offset):
    """The design's rounding, emulated here, against the JAX oracle on the
    same bf16 inputs (made as chip_smoke.py makes them): within the limit
    the card holds the kernel to, 2 bf16 ulps of max |o|."""
    rng = _rng("wgmma", B, Hq, Sq, Skv, D)
    q = rng.normal(0, 1.5, (B, Hq, Sq, D))
    k = rng.normal(0, 1.5, (B, Hkv, Skv, D))
    v = rng.normal(0, 1.0, (B, Hkv, Skv, D))
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    got = _wgmma_rounding_model(tq, tk, tv, causal, window, q_offset).float().numpy()
    jq, jk, jv = (_j(a.float().numpy(), jnp.bfloat16) for a in (tq, tk, tv))
    want = np.asarray(jref.attention_ref(jq, jk, jv, causal=causal, window=window,
                                         q_offset=q_offset), np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2.0 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window,q_offset", [
    (1, 2, 2, 128, 128, 64, True, None, 0),
    (4, 8, 1, 128, 128, 128, True, None, 0),
    (2, 3, 1, 256, 256, 64, True, 32, 0),
    (1, 15, 5, 512, 512, 64, True, 4096, 0),
    (1, 4, 2, 128, 384, 64, True, 32, 256),
    (1, 6, 2, 96, 96, 120, False, 32, 0),
    (2, 15, 5, 1024, 1024, 64, True, None, 0),
    (2, 8, 2, 256, 256, 128, False, None, 0),
    (1, 4, 2, 64, 384, 64, True, None, 320),
    (1, 16, 1, 256, 256, 256, True, 64, 0),
    (2, 16, 1, 128, 384, 256, True, 32, 256),
])
def test_wgmma_backward_rounding_model_within_the_card_limit(B, Hq, Hkv, Sq, Skv, D, causal,
                                                              window, q_offset):
    """The tensor-core backward's rounding, emulated here, against jax.grad
    of the JAX oracle (``attention_ref`` up to 512 rows,
    ``attention_xla_chunked`` beyond) on the same bf16 inputs and cotangent
    (made as chip_smoke.py makes them): dQ, dK and dV each within the limit
    the card holds the kernels to, 2 bf16 ulps of the largest |grad|."""
    rng = _rng("wgmma-bwd", B, Hq, Sq, Skv, D)
    q = rng.normal(0, 1.5, (B, Hq, Sq, D))
    k = rng.normal(0, 1.5, (B, Hkv, Skv, D))
    v = rng.normal(0, 1.0, (B, Hkv, Skv, D))
    g = rng.normal(0, 1.0, (B, Hq, Sq, D))
    tq, tk, tv, tg = (_t(a, torch.bfloat16) for a in (q, k, v, g))
    got = _wgmma_backward_model(tq, tk, tv, tg, causal, window, q_offset)
    jq, jk, jv, jg = (_j(a.float().numpy(), jnp.bfloat16) for a in (tq, tk, tv, tg))
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    oracle = jref.attention_ref if Sq <= 512 else jref.attention_xla_chunked
    want = jax.grad(lambda a, b, c: jnp.sum(oracle(a, b, c, **mask).astype(jnp.float32)
                                            * jg.astype(jnp.float32)),
                    argnums=(0, 1, 2))(jq, jk, jv)
    for name, tgrad, jgrad in zip("qkv", got, want):
        jgrad = np.asarray(jgrad, np.float32)
        np.testing.assert_allclose(tgrad.float().numpy(), jgrad, rtol=0,
                                   atol=2 * 2.0 ** -7 * np.abs(jgrad).max(), err_msg=f"d{name}")


def test_wrapper_without_card_raises_instead_of_falling_back():
    """A non-CPU tensor never takes the plain version: here there is no
    card, so the kernel path raises."""
    q = torch.zeros((1, 2, 64, 16), device="meta")
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        tfa.flash_attention(q, q, q)


# ------------------------------------------------------------------ layers --
def test_rope_qknorm_and_mlps_vs_reference():
    cfg = j_smoke("qwen3_8b")
    rng = _rng("layers")
    pos = rng.integers(0, 5000, (2, 12)).astype(np.int32)
    jc, js = jlayers.rope_freqs(cfg, jnp.asarray(pos))
    tc, ts = tlayers.rope_freqs(get_smoke_config("qwen3_8b"), torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)
    for d in (16, 15):  # even and odd head dims
        x = rng.normal(size=(2, 3, 12, d)).astype(np.float32)
        half = d // 2
        got = tlayers.apply_rope(_t(x), tc[..., :half], ts[..., :half]).numpy()
        want = jlayers.apply_rope(_j(x), jc[..., :half], js[..., :half])
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    scale = rng.normal(1.0, 0.1, 16).astype(np.float32)
    np.testing.assert_allclose(tlayers.rms_head_norm(_t(scale), _t(x)).numpy(),
                               np.asarray(jlayers.rms_head_norm(_j(scale), _j(x))), atol=1e-6)
    for mlp_type in ("swiglu", "geglu", "gelu"):
        c = dataclasses.replace(cfg, mlp_type=mlp_type, dtype="float32")
        p = {name: rng.normal(0, 0.1, s.shape).astype(np.float32)
             for name, s in jlayers.mlp_spec(c, JShardCtx()).items()}
        h = rng.normal(size=(2, 7, c.d_model)).astype(np.float32)
        got = tlayers.apply_mlp({n: _t(a) for n, a in p.items()}, c, _t(h)).numpy()
        want = np.asarray(jlayers.apply_mlp({n: _j(a) for n, a in p.items()}, c, _j(h)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=mlp_type)


# --------------------------------------------------------- attention block --
def _block_params(cfg, rng):
    spec = jatt.attn_spec(cfg, JShardCtx())
    return {name: (rng.normal(0, 0.2, s.shape) + (1.0 if name.endswith("norm") else 0.0))
            .astype(np.float32) for name, s in spec.items()}


@pytest.mark.parametrize("arch,window", [("smollm_360m", None), ("qwen3_8b", None),
                                         ("h2o_danube_3_4b", 8)])
def test_attention_block_with_and_without_cache(arch, window):
    """Cache-free (the kernel path), then a prefill into a cache and decode
    steps; with a window of 8 the cache is a ring buffer of 8 slots, which
    the decode steps wrap around.  Outputs and cache contents within 1e-5
    of their largest |value| (float32; RoPE's cos and sin may differ by an
    ulp between the packages)."""
    cfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    rng = _rng("block", arch)
    p = _block_params(cfg, rng)
    jp, tp = {n: _j(a) for n, a in p.items()}, {n: _t(a) for n, a in p.items()}
    S = 16
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    with jops.local_backend("xla"):
        want, _ = jatt.attention_block(jp, cfg, _j(x), jnp.asarray(pos), window=window)
    got, _ = tatt.attention_block(tp, tcfg, _t(x), torch.from_numpy(pos), window=window,
                                  ctx=SINGLE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())

    jc = jatt.init_kv_cache(cfg, 2, 32, window=window)
    tc = tatt.init_kv_cache(tcfg, 2, 32, window=window, device="cpu")
    assert tc.capacity == jc.capacity == (window or 32)
    for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9), (9, 10), (10, 11)):
        xs, ps = x[:, lo:hi], pos[:, lo:hi]
        jo, jc = jatt.attention_block(jp, cfg, _j(xs), jnp.asarray(ps), window=window, cache=jc)
        to, tc = tatt.attention_block(tp, tcfg, _t(xs), torch.from_numpy(ps), window=window,
                                      cache=tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jo)).max(), err_msg=f"{lo}")
        for got_c, want_c in ((tc.k, jc.k), (tc.v, jc.v)):
            want_c = np.asarray(want_c)
            np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0,
                                       atol=1e-5 * np.abs(want_c).max())
        assert int(tc.pos) == int(jc.pos)


def test_attention_block_refuses_tensor_parallel_ctx():
    cfg = get_smoke_config("smollm_360m")
    with pytest.raises(NotImplementedError, match="A7"):
        tatt.attention_block({}, cfg, torch.zeros(1, 1, cfg.d_model), torch.zeros(1, 1),
                             ctx=dataclasses.replace(SINGLE, tp=2))


# ------------------------------------------------------------ whole model --
def _models(arch, dtype):
    cfg = dataclasses.replace(j_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jparams = j_init_model(cfg, JShardCtx(), seed=0)
    return cfg, tcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                                 device="cpu")


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen3_8b", "h2o_danube_3_4b",
                                  "starcoder2_7b", "internvl2_76b", "musicgen_large"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_model_forward_vs_reference(arch, dtype):
    """A cache-free forward (attention through the wrapper) on the JAX
    parameters: logits within 1e-5 (f32) or 2^-5 (bf16) of the largest.
    Multi-codebook configs take tokens (B, K, S)."""
    cfg, tcfg, jparams, model = _models(arch, dtype)
    shape = (2, 64) if cfg.n_codebooks == 1 else (2, cfg.n_codebooks, 64)
    tokens = _rng("fwd", arch).integers(0, cfg.vocab, shape).astype(np.int32)
    with jops.local_backend("xla"):
        jl, _, _ = j_forward(jparams, cfg, jnp.asarray(tokens), JShardCtx())
    tl, _, _ = t_forward(model, tcfg, torch.from_numpy(tokens), SINGLE)
    jl = np.asarray(jl.astype(jnp.float32))
    rel = 1e-5 if dtype == "float32" else 2.0 ** -5
    np.testing.assert_allclose(tl.float().numpy(), jl, rtol=0, atol=rel * np.abs(jl).max())


def test_smoke_smollm_prefill_and_greedy_decode_vs_reference():
    """Serving a dense model on the cache branch: last-token prefill logits
    within 1e-5 of the largest and 8 greedy tokens equal (float32)."""
    cfg, tcfg, jparams, model = _models("smollm_360m", "float32")
    prompt = _rng("prompt").integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    with jops.local_backend("xla"):
        jpre, jdec, _ = j_serve_fns(cfg, JShardCtx(), capacity=64)
        jl, _ = jpre(jparams, jnp.asarray(prompt))
        jtok = np.asarray(j_generate(cfg, jparams, jpre, jdec, jnp.asarray(prompt), 8))
    tpre, tdec, _ = make_serve_fns(tcfg, SINGLE, capacity=64)
    tl, _ = tpre(model, torch.from_numpy(prompt).long())
    ttok = greedy_generate(tcfg, model, tpre, tdec, torch.from_numpy(prompt).long(), 8)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-5 * np.abs(jl).max())
    np.testing.assert_array_equal(ttok.numpy(), jtok)
