"""The port's Mamba-2 SSD against the JAX package's, on the CPU.

``ssd_chunk_scan_plain`` (what the ``ssd_chunk_scan`` wrapper runs on a CPU
tensor) is held against the JAX Pallas ``ssd_chunk_scan`` in interpret mode,
per sequence of the batch, and ``ops.ssd_scan`` against the JAX ``ops``
entry.  Then the smoke ``mamba2_2p7b`` with the JAX parameters carried over
by ``params_from_numpy`` is held against the JAX prefill and decode, the
Pallas kernel again in interpret mode.

Tolerances: in float32 the outputs agree to 1e-5 of the largest |y| (sums
in another order); in bfloat16 both sides round y_intra and y to bf16 at
the same two places, so they agree to one bf16 ulp (2^-7 relative) of the
largest |y|.  The final states are float32 in both: 1e-5 relative.
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
from repro.kernels.ssd_chunk import ssd_chunk_scan as j_ssd
from repro.models import init_model as j_init_model
from repro.models.base import ShardCtx as JShardCtx
from repro.serve.engine import greedy_generate as j_generate
from repro.serve.engine import make_serve_fns as j_serve_fns
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_chunk as SC
from repro_torch.models import SINGLE, model_spec, param_count, params_from_numpy
from repro_torch.models.blocks import block_spec
from repro_torch.serve import greedy_generate, make_serve_fns

_BF16 = jnp.bfloat16


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _inputs(rng, batch, S, H=4, P=16, N=16):
    x = rng.normal(0, 1, (batch, S, H, P)).astype(np.float32)
    la = -rng.uniform(0.01, 0.5, (batch, S, H)).astype(np.float32)
    b = rng.normal(0, 0.5, (batch, S, N)).astype(np.float32)
    c = rng.normal(0, 0.5, (batch, S, N)).astype(np.float32)
    return x, la, b, c


def _chunk(S, chunk=32):
    """The reference's chunk rule (``models/ssd.py:126``)."""
    return min(chunk if S % min(chunk, S) == 0 else 1, S)


@pytest.mark.parametrize("S", [32, 64, 40])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_scan_plain_vs_pallas(S, batch, dtype):
    x, la, b, c = _inputs(_rng("ssd", S, batch, dtype), batch, S)
    L = _chunk(S)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else _BF16
    ty, th = SC.ssd_chunk_scan_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(la),
                                     torch.from_numpy(b).to(tdt), torch.from_numpy(c).to(tdt), L)
    assert ty.dtype == tdt and th.dtype == torch.float32
    for i in range(batch):
        jy, jh = j_ssd(jnp.asarray(x[i], jdt), jnp.asarray(la[i]), jnp.asarray(b[i], jdt),
                       jnp.asarray(c[i], jdt), chunk=L, interpret=True)
        jy = np.asarray(jy.astype(jnp.float32))
        scale = np.abs(jy).max()
        rel = 1e-5 if dtype == "float32" else 2.0**-7
        np.testing.assert_allclose(ty[i].float().numpy(), jy, rtol=0, atol=rel * scale)
        np.testing.assert_allclose(th[i].numpy(), np.asarray(jh), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jh)).max())


@pytest.mark.parametrize("S,chunk", [(64, 32), (40, 1), (16, 32)])
def test_ssd_scan_entry_vs_reference_ops(S, chunk):
    """``ops.ssd_scan`` (batched) against the JAX ``ops.ssd_scan`` per
    sequence on the ``xla`` path; chunk is cut to S as in the reference."""
    x, la, b, c = _inputs(_rng("ops", S, chunk), 2, S)
    with tops.local_backend("torch"):
        ty, th = tops.ssd_scan(torch.from_numpy(x), torch.from_numpy(la),
                               torch.from_numpy(b), torch.from_numpy(c), chunk=chunk)
    for i in range(2):
        with jops.local_backend("xla"):
            jy, jh = jops.ssd_scan(jnp.asarray(x[i]), jnp.asarray(la[i]), jnp.asarray(b[i]),
                                   jnp.asarray(c[i]), chunk=chunk)
        np.testing.assert_allclose(ty[i].numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jy)).max())
        np.testing.assert_allclose(th[i].numpy(), np.asarray(jh), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jh)).max())


def test_ssd_scan_rejects_a_chunk_that_does_not_divide():
    x, la, b, c = (torch.from_numpy(a) for a in _inputs(_rng("bad"), 1, 40))
    with pytest.raises(ValueError):
        tops.ssd_scan(x, la, b, c, chunk=32)


# ------------------------------------------------------------------- model ----
def test_param_tree_and_count_match_reference():
    cfg = get_config("mamba2_2p7b")
    spec = model_spec(cfg)
    assert set(spec["groups"]) == {"p0_ssd"}
    assert spec["groups"]["p0_ssd"]["ssd"]["in_proj"].shape == (64, 2560, 10576)
    assert spec["embed"]["head"].shape == (2560, 50280)
    assert param_count(spec) == 2_831_296_000
    assert cfg.param_count() == 2_830_704_640  # the config's own estimate
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        block_spec("rglru", get_smoke_config("recurrentgemma_9b"), SINGLE)
    with pytest.raises(NotImplementedError, match="ROADMAP A6.2"):
        block_spec("attn", get_smoke_config("qwen3_moe_30b_a3b"), SINGLE)


def _prefill_and_decode(dtype, S=40):
    cfg = dataclasses.replace(j_smoke("mamba2_2p7b"), dtype=dtype)
    jparams = j_init_model(cfg, JShardCtx(), seed=0)
    tcfg = dataclasses.replace(get_smoke_config("mamba2_2p7b"), dtype=dtype)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    prompt = _rng("prompt", dtype, S).integers(0, cfg.vocab, (2, S)).astype(np.int32)
    with jops.local_backend("interpret"):
        jpre, jdec, _ = j_serve_fns(cfg, JShardCtx(), capacity=64)
        jl, _ = jpre(jparams, jnp.asarray(prompt))
        jtok = np.asarray(j_generate(cfg, jparams, jpre, jdec, jnp.asarray(prompt), 8))
    tpre, tdec, _ = make_serve_fns(tcfg, SINGLE, capacity=64)
    tl, _ = tpre(model, torch.from_numpy(prompt).long())
    ttok = greedy_generate(tcfg, model, tpre, tdec, torch.from_numpy(prompt).long(), 8)
    return np.asarray(jl.astype(jnp.float32)), tl.float().numpy(), jtok, ttok.numpy()


@pytest.mark.parametrize("S", [32, 40])
def test_smoke_mamba2_float32_prefill_and_greedy_decode(S):
    """float32: last-token logits within 1e-5 of the largest |logit|, and 8
    greedy tokens equal.  S = 32 is one chunk; S = 40 takes the one-token-
    chunk rule."""
    jl, tl, jtok, ttok = _prefill_and_decode("float32", S)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5 * np.abs(jl).max())
    np.testing.assert_array_equal(ttok, jtok)


def test_smoke_mamba2_bfloat16_prefill():
    """bfloat16: logits within 2 bf16 ulps (2^-6) of the largest |logit|."""
    jl, tl, _, _ = _prefill_and_decode("bfloat16")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2.0**-6 * np.abs(jl).max())
