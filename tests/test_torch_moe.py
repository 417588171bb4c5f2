"""The port's MoE feed-forward against the JAX package's, on the CPU.

``moe_ffn`` on the same inputs in both packages (the smoke granite-MoE and
Qwen3-MoE configs, float32 and bfloat16, the router biased so that an
expert overflows its capacity): the output and both aux losses, the
routing and the set of assignments dropped at capacity.  Then the
parameter tree and its storage types, whole-model forwards on the JAX
parameters, and the loss (aux losses included) with every gradient against
``jax.value_and_grad`` of the JAX ``loss_fn``.

Tolerances: ``moe_ffn`` in float32 within 1e-5 of max |y| (the expert
products sum in another order), in bfloat16 within 2^-5; the routing and
the dropped set exact.  Model logits: float32 within 1e-5 of the largest
|logit|; bfloat16 within 2^-5 of it, as for the dense models, or within
the distance of the reference's own bfloat16 logits from its float32 ones
where that is larger (the smoke Qwen3-MoE: about 0.035): a token whose
top-k is a near tie takes other experts after any rounding.  Loss within
1e-6 relative, gradients within 1e-5 of each leaf's largest |g|.
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
from repro.models import moe as jmoe
from repro.models.base import ShardCtx as JShardCtx
from repro.models.lm import forward as j_forward
from repro.models.lm import model_spec as j_model_spec
from repro.train.trainstep import loss_fn as j_loss_fn
from repro_torch.configs import get_smoke_config
from repro_torch.data import SynthSpec, batch_at
from repro_torch.models import moe as tmoe
from repro_torch.models import params_from_numpy
from repro_torch.models.base import SINGLE, keystr, tree_flatten
from repro_torch.models.lm import forward as t_forward
from repro_torch.models.lm import model_spec
from repro_torch.train.trainstep import value_and_grad

MOE_ARCHS = ["granite_moe_3b_a800m", "qwen3_moe_30b_a3b"]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _cfgs(arch, dtype):
    return (dataclasses.replace(j_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


def _moe_inputs(cfg, rng, B=2, S=64):
    """Random expert weights and x, with the router's column 0 raised so
    that expert 0 is in most tokens' top k and overflows its capacity."""
    d, E, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    params = {"router": rng.normal(0, 0.3, (d, E)),
              "w_up": rng.normal(0, 0.1, (E, d, f)),
              "w_down": rng.normal(0, 0.1, (E, f, d))}
    if cfg.mlp_type in ("swiglu", "geglu"):
        params["w_gate"] = rng.normal(0, 0.1, (E, d, f))
    x = rng.normal(size=(B, S, d))
    params["router"][:, 0] += 0.3 * np.sign(x.mean((0, 1)))
    return ({k: v.astype(np.float32) for k, v in params.items()}, x.astype(np.float32))


def _reference_dropped(top_e, e_count, capacity):
    """The reference's capacity rule on its own routing, in numpy: the
    (token, slot) pairs past their expert's capacity after the stable sort."""
    flat = np.asarray(top_e).reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_e = flat[order]
    pos = np.arange(flat.size) - np.searchsorted(sorted_e, sorted_e, side="left")
    return set(order[(pos >= capacity) | (sorted_e >= e_count)].tolist())


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_vs_reference_with_tokens_dropped(arch, dtype):
    cfg, tcfg = _cfgs(arch, dtype)
    params, x = _moe_inputs(cfg, _rng("moe", arch, dtype))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x, jd)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v).to(td) for k, v in params.items()}
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(td)
    jy, jaux = jmoe.moe_ffn(jparams, cfg, jx, JShardCtx())
    ty, taux = tmoe.moe_ffn(tparams, tcfg, tx, SINGLE)
    assert ty.dtype == td and ty.shape == tx.shape
    jy = np.asarray(jy.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=0, atol=tol * np.abs(jy).max())
    for key in ("moe_aux", "moe_z"):
        assert float(taux[key]) == pytest.approx(float(jaux[key]), rel=1e-5)

    # the routing, and the assignments dropped at capacity, are the same
    T, E = x.shape[0] * x.shape[1], cfg.moe.n_experts
    cap = jmoe.expert_capacity(cfg, T)
    assert tmoe.expert_capacity(tcfg, T) == cap
    _, j_top_e, _ = jmoe._route(jparams, cfg, jx.reshape(T, -1), E)
    _, t_top_e, _ = tmoe._route(tparams, tcfg, tx.reshape(T, -1), E)
    np.testing.assert_array_equal(t_top_e.numpy(), np.asarray(j_top_e))
    order, keep, slot = tmoe._dispatch(t_top_e, E, cap)
    dropped = set(order[~keep].tolist())
    assert dropped == _reference_dropped(j_top_e, E, cap)
    assert len(dropped) > 0, "the biased router overflowed no expert"
    assert int((slot == E * cap).sum()) == len(dropped)


def test_route_puts_the_lower_expert_first_on_ties():
    """Equal router probabilities: the lower expert index is taken first, as
    ``jax.lax.top_k`` takes it."""
    cfg, tcfg = _cfgs("granite_moe_3b_a800m", "float32")
    d, E = cfg.d_model, cfg.moe.n_experts
    router = np.zeros((d, E), np.float32)
    router[:, 5] = router[:, 2] = 0.5  # experts 2 and 5 tie above the rest
    x = np.ones((3, d), np.float32)
    _, j_top_e, _ = jmoe._route({"router": jnp.asarray(router)}, cfg, jnp.asarray(x), E)
    _, t_top_e, _ = tmoe._route({"router": torch.from_numpy(router)}, tcfg,
                                torch.from_numpy(x), E)
    np.testing.assert_array_equal(t_top_e.numpy(), np.asarray(j_top_e))
    assert t_top_e[0].tolist() == [2, 5]


@pytest.mark.parametrize("tokens", [1, 64, 128, 1000, 4096])
def test_expert_capacity_vs_reference(tokens):
    for arch in MOE_ARCHS:
        cfg, tcfg = _cfgs(arch, "float32")
        assert tmoe.expert_capacity(tcfg, tokens) == jmoe.expert_capacity(cfg, tokens)


@pytest.mark.parametrize("tp", [2, 4])
def test_moe_ffn_at_tensor_parallel_ctx_vs_reference(tp):
    """ROADMAP C13: ``moe_ffn`` at ``ShardCtx(tp)`` with no mesh is the
    global semantics over ``padded_experts(tp)`` experts (the padded ones
    masked out of the routing), as in the reference: the output within
    1e-5 of max |y| (float32), the routing exact."""
    cfg, tcfg = _cfgs("granite_moe_3b_a800m", "float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=5))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, n_experts=5))
    e_pad = tcfg.moe.padded_experts(tp)
    assert e_pad == cfg.moe.padded_experts(tp) > cfg.moe.n_experts
    rng = _rng("moe-tp", tp)
    params, x = _moe_inputs(cfg, rng)
    extra = e_pad - cfg.moe.n_experts  # the padded experts' weights
    params = {k: np.concatenate([v, rng.normal(0, 0.1, (v.shape[0], extra) if k == "router"
                                               else (extra,) + v.shape[1:]).astype(np.float32)],
                                axis=1 if k == "router" else 0) for k, v in params.items()}
    jy, jaux = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in params.items()}, cfg,
                            jnp.asarray(x), JShardCtx(tp=tp))
    ty, taux = tmoe.moe_ffn({k: torch.from_numpy(v) for k, v in params.items()}, tcfg,
                            torch.from_numpy(x), dataclasses.replace(SINGLE, tp=tp))
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=1e-5 * np.abs(jy).max())
    for key in ("moe_aux", "moe_z"):
        assert float(taux[key]) == pytest.approx(float(jaux[key]), rel=1e-5)
    T = x.shape[0] * x.shape[1]
    _, j_top_e, _ = jmoe._route({"router": jnp.asarray(params["router"])}, cfg,
                                jnp.asarray(x).reshape(T, -1), e_pad)
    _, t_top_e, _ = tmoe._route({"router": torch.from_numpy(params["router"])}, tcfg,
                                torch.from_numpy(x).reshape(T, -1), e_pad)
    np.testing.assert_array_equal(t_top_e.numpy(), np.asarray(j_top_e))
    assert int(t_top_e.max()) < cfg.moe.n_experts  # no padded expert is routed to


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_numpy_carries_the_tree_with_its_storage_types(arch):
    """The JAX parameter tree carries over leaf for leaf: serving stores the
    router and the expert weights in the compute type, training every leaf
    in float32."""
    cfg, tcfg = _cfgs(arch, "bfloat16")
    jparams = jax.tree.map(np.asarray, j_init_model(cfg, JShardCtx(), seed=0))
    jflat = dict((keystr(p), v) for p, v in tree_flatten(jparams))
    for trainable in (False, True):
        model = params_from_numpy(jparams, tcfg, device="cpu", trainable=trainable)
        flat = dict((keystr(p), v) for p, v in tree_flatten(model.tree()))
        assert set(flat) == set(jflat)
        for key, leaf in flat.items():
            want = torch.from_numpy(np.array(jflat[key], np.float32)).to(leaf.dtype)
            assert torch.equal(leaf.detach(), want), key
            if trainable:
                assert leaf.dtype == torch.float32, key
            elif "['moe']" in key:
                assert leaf.dtype == torch.bfloat16, key
    assert set(jflat) == set(keystr(p) for p, _ in tree_flatten(
        j_model_spec(cfg, JShardCtx())))
    assert set(jflat) == set(keystr(p) for p, _ in tree_flatten(model_spec(tcfg)))


def _logits(arch, dtype, tokens):
    cfg, tcfg = _cfgs(arch, dtype)
    jparams = j_init_model(cfg, JShardCtx(), seed=0)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    with jops.local_backend("xla"):
        jl, _, jaux = j_forward(jparams, cfg, jnp.asarray(tokens), JShardCtx())
    tl, _, taux = t_forward(model, tcfg, torch.from_numpy(tokens), SINGLE)
    return np.asarray(jl.astype(jnp.float32)), tl.float().numpy(), jaux, taux


def model_forward_limit(jl32, jl, dtype):
    """The test's limit on |port - reference| relative to the largest
    |logit|: 1e-5 in float32; in bfloat16 2^-5, or the reference's own
    bf16-to-float32 distance where that is larger."""
    if dtype == "float32":
        return 1e-5
    return max(2.0 ** -5, float(np.abs(jl - jl32).max() / np.abs(jl32).max()))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_moe_model_forward_vs_reference(arch, dtype):
    """A cache-free forward on the JAX parameters: logits within the limit
    of ``model_forward_limit``, and both aux losses summed over the layers."""
    tokens = _rng("fwd", arch).integers(0, j_smoke(arch).vocab, (2, 64)).astype(np.int32)
    jl, tl, jaux, taux = _logits(arch, dtype, tokens)
    jl32 = jl if dtype == "float32" else _logits(arch, "float32", tokens)[0]
    rel = model_forward_limit(jl32, jl, dtype)
    assert rel <= 2.0 ** -4
    np.testing.assert_allclose(tl, jl, rtol=0, atol=rel * np.abs(jl).max())
    assert set(taux) == set(jaux) == {"moe_aux", "moe_z"}
    for key in taux:
        assert float(taux[key]) == pytest.approx(float(jaux[key]), rel=1e-5 if dtype ==
                                                 "float32" else 2.0 ** -5)


def test_loss_with_aux_and_every_gradient_vs_jax_value_and_grad():
    """granite-MoE in float32: the total loss (LM loss + moe_aux + moe_z),
    each part, and every leaf's gradient against ``jax.value_and_grad`` of
    the JAX ``loss_fn``."""
    cfg, tcfg = _cfgs("granite_moe_3b_a800m", "float32")
    jparams = j_init_model(cfg, JShardCtx(), seed=0)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                              trainable=True)
    data = batch_at(SynthSpec(vocab=cfg.vocab, seq_len=32, batch=4, seed=1), 0)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    with jops.local_backend("xla"):
        (jl, jm), jg = jax.value_and_grad(
            lambda p: j_loss_fn(p, cfg, jbatch, JShardCtx(), None, False, False),
            has_aux=True)(jparams)
    tl, tm, tg = value_and_grad(model, tcfg, {k: torch.from_numpy(v) for k, v in data.items()},
                                SINGLE, False)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert set(tm) >= {"loss", "moe_aux", "moe_z"}
    for key in ("loss", "moe_aux", "moe_z"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5)
    assert float(tl) == pytest.approx(float(tm["loss"] + tm["moe_aux"] + tm["moe_z"]), rel=1e-6)
    want = dict((keystr(p), np.asarray(v)) for p, v in tree_flatten(jax.tree.map(np.asarray,
                                                                                   jg)))
    got = dict((keystr(p), v) for p, v in tree_flatten(tg))
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30), err_msg=key)


@pytest.mark.parametrize("k,E", [(8, 40), (2, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_token_gather_backward_adds_each_tokens_rows_in_expert_order(dtype, k, E):
    """``_TokenGather``: the forward is ``xf[order // k]``; the backward
    equals, bit for bit, an explicit loop that adds each token's k gradient
    rows from 0 in ascending expert id, rounding to the type after each
    add (rows of dropped assignments are zero, as the grid gives them)."""
    rng = _rng("gather", k, E, str(dtype))
    T, d = 96, 24
    top_e = torch.from_numpy(np.argsort(rng.random((T, E)), axis=1)[:, :k].copy())
    order = torch.argsort(top_e.reshape(-1), stable=True)
    xf = torch.from_numpy(rng.normal(size=(T, d))).to(dtype).requires_grad_(True)
    rows = tmoe._TokenGather.apply(xf, order, top_e)
    assert torch.equal(rows, xf.detach()[order // k])

    g = torch.from_numpy(rng.normal(size=(T * k, d))).to(dtype)
    g[torch.from_numpy(rng.random(T * k) < 0.2)] = 0
    rows.backward(g)

    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * k)  # sorted position of assignment (t, j)
    want = torch.empty((T, d), dtype=dtype)
    for t in range(T):
        acc = torch.zeros(d, dtype=dtype)
        for j in torch.argsort(top_e[t]).tolist():  # ascending expert id
            acc = acc + g[pos[t * k + j]]
        want[t] = acc
    assert torch.equal(xf.grad, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slot_gather_forward_and_backward(dtype):
    """``_SlotGather``: each assignment's grid row, zero where dropped; the
    backward puts each kept assignment's gradient row on its grid row as it
    is (kept slots are distinct) and nothing from a dropped one."""
    rng = _rng("slot", str(dtype))
    rows, d, n = 40, 6, 64
    slot = torch.from_numpy(rng.permutation(rows + n)[:n].copy())
    slot = torch.where(slot < rows, slot, torch.tensor(rows))  # the rest dropped
    y = torch.from_numpy(rng.normal(size=(rows, d))).to(dtype).requires_grad_(True)
    out = tmoe._SlotGather.apply(y, slot)
    kept = slot < rows
    assert torch.equal(out[kept], y.detach()[slot[kept]])
    assert torch.equal(out[~kept], torch.zeros((int((~kept).sum()), d), dtype=dtype))
    g = torch.from_numpy(rng.normal(size=(n, d))).to(dtype)
    out.backward(g)
    want = torch.zeros((rows, d), dtype=dtype)
    want[slot[kept]] = g[kept]
    assert torch.equal(y.grad, want)


def _old_moe_aux(params, cfg, xf, e_pad, top_e):
    """``moe_aux`` as ``_route`` computed it with ``torch.bincount`` (which
    reads the largest expert id back to the host on a card)."""
    moe = cfg.moe
    logits = (xf @ params["router"].to(xf.dtype)).float()
    if e_pad > moe.n_experts:
        pad_mask = torch.arange(e_pad) >= moe.n_experts
        logits = torch.where(pad_mask[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    counts = torch.bincount(top_e.reshape(-1), minlength=e_pad).float()
    frac_tokens = counts / (xf.shape[0] * moe.top_k)
    return moe.n_experts * torch.sum(frac_tokens * probs.mean(0)) * moe.aux_loss_coef


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad", [0, 8])
def test_route_aux_counts_bit_for_bit_the_bincount_formula(arch, dtype, pad):
    """The fixed-size count (an int64 scatter-add) gives ``moe_aux`` bit for
    bit what the bincount did, padded experts included."""
    _, tcfg = _cfgs(arch, dtype)
    params, x = _moe_inputs(tcfg, _rng("aux", arch, dtype, pad))
    E = tcfg.moe.n_experts + pad
    d = tcfg.d_model
    router = np.concatenate([params["router"], np.zeros((d, pad), np.float32)], 1)
    tparams = {"router": torch.from_numpy(router)}
    xf = torch.from_numpy(x.reshape(-1, d)).to(getattr(torch, dtype))
    _, top_e, aux = tmoe._route(tparams, tcfg, xf, E)
    want = _old_moe_aux(tparams, tcfg, xf, E, top_e)
    assert aux["moe_aux"].dtype == want.dtype
    assert torch.equal(aux["moe_aux"], want)


def test_no_bincount_in_the_port_models():
    """bincount sizes its output from the data, which on a card reads the
    largest id back to the host: the models count with fixed shapes."""
    from pathlib import Path

    import repro_torch.models as models

    root = Path(models.__file__).parent
    hits = [f"{p.name}:{i}" for p in sorted(root.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1) if "bincount" in line]
    assert hits == []
