"""The port's RG-LRU block and RecurrentGemma against the JAX package's, on
the CPU.

``_lru_scan`` (a log-step scan in torch ops) against the reference's
``jax.lax.associative_scan``, with and without an initial state, at S = 1,
7, 64 and 1,000; ``rglru_block`` without a cache, with a cache at S > 1 and
at S == 1 (decode); the parameter tree and its storage types; the smoke
``recurrentgemma_9b`` forward, its greedy prefill and decode past the
local-attention ring, and its loss with every gradient against
``jax.value_and_grad`` of the JAX ``loss_fn``.

Tolerances: the scan within 1e-6 of max |h| (float32, another combining
tree); the block's output and state within 1e-5 of their largest |value|
(float32 products in another order), its conv tail exact; model logits in
float32 within 1e-5 of the largest |logit|, in bfloat16 within 2^-5 of it;
loss within 1e-6 relative, gradients within 1e-5 of each leaf's largest |g|;
greedy tokens equal.
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
from repro.models import init_model as j_init_model
from repro.models import rglru as jrg
from repro.models.base import ShardCtx as JShardCtx
from repro.models.lm import forward as j_forward
from repro.serve.engine import greedy_generate as j_generate
from repro.serve.engine import make_serve_fns as j_serve_fns
from repro.train.trainstep import loss_fn as j_loss_fn
from repro_torch.configs import get_smoke_config
from repro_torch.data import SynthSpec, batch_at
from repro_torch.models import params_from_numpy
from repro_torch.models import rglru as trg
from repro_torch.models.base import SINGLE, keystr, tree_flatten
from repro_torch.models.lm import forward as t_forward
from repro_torch.models.lm import init_cache
from repro_torch.serve import greedy_generate, make_serve_fns
from repro_torch.train.trainstep import value_and_grad

ARCH = "recurrentgemma_9b"


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _cfgs(dtype="float32"):
    return (dataclasses.replace(j_smoke(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype))


# ------------------------------------------------------------------- scan ----
@pytest.mark.parametrize("S", [1, 7, 64, 1000])
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_vs_associative_scan(S, with_h0):
    rng = _rng("scan", S, with_h0)
    B, W = 2, 24
    log_a = -rng.uniform(0.0, 0.5, (B, S, W)).astype(np.float32)
    u = rng.normal(size=(B, S, W)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32) if with_h0 else None
    jh, jlast = jrg._lru_scan(jnp.asarray(log_a), jnp.asarray(u),
                              None if h0 is None else jnp.asarray(h0))
    th, tlast = trg._lru_scan(torch.from_numpy(log_a), torch.from_numpy(u),
                              None if h0 is None else torch.from_numpy(h0))
    jh = np.asarray(jh)
    tol = 1e-6 * np.abs(jh).max()
    np.testing.assert_allclose(th.numpy(), jh, rtol=0, atol=tol)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=0, atol=tol)


# ------------------------------------------------------------------ block ----
def _block_params(cfg, rng):
    r, d = cfg.rglru, cfg.d_model
    w = r.lru_width
    p = {"in_proj": rng.normal(0, 0.2, (d, 2 * w)), "conv_w": rng.normal(0, 0.3, (r.conv_width, w)),
         "conv_b": rng.normal(0, 0.1, (w,)), "lambda_p": rng.normal(0, 0.5, (w,)),
         "w_rec_gate": rng.normal(0, 0.2, (w, w)), "w_in_gate": rng.normal(0, 0.2, (w, w)),
         "out_proj": rng.normal(0, 0.2, (w, d))}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("mode,S", [("none", 48), ("cache", 12), ("decode", 1)])
def test_rglru_block_vs_reference(mode, S):
    """Without a cache, with a cache holding a state and a conv tail (S >
    1, the scan from h0) and one decode step: the output, and the new
    cache's state and conv tail."""
    cfg, tcfg = _cfgs()
    rng = _rng("block", mode, S)
    params = _block_params(cfg, rng)
    B, W = 2, cfg.rglru.lru_width
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    jcache = tcache = None
    if mode != "none":
        h = rng.normal(size=(B, W)).astype(np.float32)
        conv = rng.normal(size=(B, cfg.rglru.conv_width - 1, W)).astype(np.float32)
        jcache = jrg.RGLRUCache(h=jnp.asarray(h), conv=jnp.asarray(conv),
                                pos=jnp.asarray(5, jnp.int32))
        tcache = trg.RGLRUCache(h=torch.from_numpy(h), conv=torch.from_numpy(conv),
                                pos=torch.tensor(5, dtype=torch.int32))
    jy, jnew = jrg.rglru_block({k: jnp.asarray(v) for k, v in params.items()}, cfg,
                               jnp.asarray(x), cache=jcache)
    ty, tnew = trg.rglru_block({k: torch.from_numpy(v) for k, v in params.items()}, tcfg,
                               torch.from_numpy(x), cache=tcache)
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=1e-5 * np.abs(jy).max())
    if mode == "none":
        assert jnew is None and tnew is None
        return
    jh = np.asarray(jnew.h)
    np.testing.assert_allclose(tnew.h.numpy(), jh, rtol=0, atol=1e-5 * np.abs(jh).max())
    np.testing.assert_array_equal(tnew.conv.numpy(), np.asarray(jnew.conv))
    assert int(tnew.pos) == int(jnew.pos) == 5 + S
    assert tnew.h.dtype == tnew.conv.dtype == torch.float32


def test_rglru_cache_stacks_like_the_other_caches():
    """``init_cache`` stacks the RG-LRU state over the groups, as the
    reference's cache tree does (shapes and types)."""
    cfg, tcfg = _cfgs("bfloat16")
    from repro.models.lm import init_cache as j_init_cache

    jc = j_init_cache(cfg, 2, 64)
    tc = init_cache(tcfg, 2, 64, "cpu")
    for key in jc["groups"]:
        jt = jax.tree.leaves(jc["groups"][key])
        tt = tc["groups"][key].tensors()
        assert [tuple(a.shape) for a in jt] == [tuple(a.shape) for a in tt]
        assert [str(a.dtype) for a in jt] == [str(a.dtype).split(".")[1] for a in tt]


def test_params_from_numpy_carries_the_tree_with_its_storage_types():
    """Serving stores the projections in the compute type and keeps the
    conv, Λ and the two gate matrices in float32 (the reference uses them
    so); training stores every leaf in float32."""
    cfg, tcfg = _cfgs("bfloat16")
    jparams = jax.tree.map(np.asarray, j_init_model(cfg, JShardCtx(), seed=0))
    jflat = dict((keystr(p), v) for p, v in tree_flatten(jparams))
    f32 = ("conv_w", "conv_b", "lambda_p", "w_rec_gate", "w_in_gate")
    for trainable in (False, True):
        model = params_from_numpy(jparams, tcfg, device="cpu", trainable=trainable)
        flat = dict((keystr(p), v) for p, v in tree_flatten(model.tree()))
        assert set(flat) == set(jflat)
        for key, leaf in flat.items():
            want = torch.from_numpy(np.array(jflat[key], np.float32)).to(leaf.dtype)
            assert torch.equal(leaf.detach(), want), key
            if "['rglru']" in key:
                bf16 = not trainable and not any(f"['{n}']" in key for n in f32)
                assert leaf.dtype == (torch.bfloat16 if bf16 else torch.float32), key


# ------------------------------------------------------------------ model ----
def _models(dtype, trainable=False):
    cfg, tcfg = _cfgs(dtype)
    jparams = j_init_model(cfg, JShardCtx(), seed=0)
    return cfg, tcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                                 device="cpu", trainable=trainable)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_recurrentgemma_forward_vs_reference(dtype):
    """A cache-free forward (the local attention through the wrapper) on the
    JAX parameters: logits within 1e-5 (f32) or 2^-5 (bf16) of the largest."""
    cfg, tcfg, jparams, model = _models(dtype)
    tokens = _rng("fwd", ARCH).integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    with jops.local_backend("xla"):
        jl, _, _ = j_forward(jparams, cfg, jnp.asarray(tokens), JShardCtx())
    tl, _, aux = t_forward(model, tcfg, torch.from_numpy(tokens), SINGLE)
    assert aux == {}
    jl = np.asarray(jl.astype(jnp.float32))
    rel = 1e-5 if dtype == "float32" else 2.0 ** -5
    np.testing.assert_allclose(tl.float().numpy(), jl, rtol=0, atol=rel * np.abs(jl).max())


def test_smoke_recurrentgemma_prefill_and_greedy_decode_vs_reference():
    """Serving: a 24-token prompt (a prefill may not pass the 32-slot ring,
    in either package), then 16 greedy tokens, so decode wraps the ring:
    last-token prefill logits within 1e-5 of the largest, tokens equal
    (float32)."""
    cfg, tcfg, jparams, model = _models("float32")
    prompt = _rng("prompt", ARCH).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    n = 16
    assert prompt.shape[1] + n > cfg.local_window
    with jops.local_backend("xla"):
        jpre, jdec, _ = j_serve_fns(cfg, JShardCtx(), capacity=64)
        jl, _ = jpre(jparams, jnp.asarray(prompt))
        jtok = np.asarray(j_generate(cfg, jparams, jpre, jdec, jnp.asarray(prompt), n))
    tpre, tdec, _ = make_serve_fns(tcfg, SINGLE, capacity=64)
    tl, _ = tpre(model, torch.from_numpy(prompt).long())
    ttok = greedy_generate(tcfg, model, tpre, tdec, torch.from_numpy(prompt).long(), n)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-5 * np.abs(jl).max())
    np.testing.assert_array_equal(ttok.numpy(), jtok)


def test_decode_logits_match_the_cache_free_forward():
    """Decoding token by token past the ring gives, at every position, the
    logits of one cache-free forward over the whole sequence (float32,
    within 1e-5 of the largest)."""
    cfg, tcfg, jparams, model = _models("float32")
    S = 48
    tokens = torch.from_numpy(_rng("decode", ARCH).integers(0, cfg.vocab, (1, S))).long()
    full, _, _ = t_forward(model, tcfg, tokens, SINGLE)
    tpre, tdec, _ = make_serve_fns(tcfg, SINGLE, capacity=64)
    logits, cache = tpre(model, tokens[:, :1])
    steps = [logits]
    for t in range(1, S):
        logits, cache = tdec(model, cache, tokens[:, t:t + 1], torch.tensor(t, dtype=torch.int32))
        steps.append(logits)
    got = torch.stack(steps, 1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0,
                               atol=1e-5 * float(full.abs().max()))


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_vs_jax_value_and_grad(remat):
    cfg, tcfg, jparams, model = _models("float32", trainable=True)
    data = batch_at(SynthSpec(vocab=cfg.vocab, seq_len=64, batch=2, seed=1), 0)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    with jops.local_backend("xla"):
        (jl, _), jg = jax.value_and_grad(
            lambda p: j_loss_fn(p, cfg, jbatch, JShardCtx(), None, remat, False),
            has_aux=True)(jparams)
    tl, _, tg = value_and_grad(model, tcfg, {k: torch.from_numpy(v) for k, v in data.items()},
                               SINGLE, remat)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    want = dict((keystr(p), np.asarray(v)) for p, v in tree_flatten(jax.tree.map(np.asarray,
                                                                                   jg)))
    got = dict((keystr(p), v) for p, v in tree_flatten(tg))
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30), err_msg=key)


def test_ring_prefill_mask_is_the_references():
    """ROADMAP C7, reproduced as the reference has it: a prefill of more
    than one token into the local-attention ring (capacity == window) is
    not causal within the prompt (its mask lets a token see the later ones),
    so a 2-token prefill's first position differs from a 1-token prefill's
    in both packages; the port's prefill logits equal the reference's at
    every position (float32, within 1e-5 of the largest)."""
    from repro.models.lm import init_cache as j_init_cache

    cfg, tcfg, jparams, model = _models("float32")
    tokens = np.array([[5, 7]], np.int32)
    start = jnp.asarray(0, jnp.int32)
    jl2, _, _ = j_forward(jparams, cfg, jnp.asarray(tokens), JShardCtx(),
                          cache=j_init_cache(cfg, 1, 64), start_pos=start)
    jl1, _, _ = j_forward(jparams, cfg, jnp.asarray(tokens[:, :1]), JShardCtx(),
                          cache=j_init_cache(cfg, 1, 64), start_pos=start)
    tstart = torch.zeros((), dtype=torch.int32)
    with torch.no_grad():
        tl2, _, _ = t_forward(model, tcfg, torch.from_numpy(tokens).long(), SINGLE,
                              cache=init_cache(tcfg, 1, 64, "cpu"), start_pos=tstart)
        tl1, _, _ = t_forward(model, tcfg, torch.from_numpy(tokens[:, :1]).long(), SINGLE,
                              cache=init_cache(tcfg, 1, 64, "cpu"), start_pos=tstart)
    jl2, jl1 = np.asarray(jl2), np.asarray(jl1)
    scale = np.abs(jl2).max()
    np.testing.assert_allclose(tl2.numpy(), jl2, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(tl1.numpy(), jl1, rtol=0, atol=1e-5 * scale)
    assert np.abs(jl2[0, 0] - jl1[0, 0]).max() > 0.1 * scale
    assert np.abs(tl2[0, 0].numpy() - tl1[0, 0].numpy()).max() > 0.1 * scale
