"""The port's model mesh against the JAX package's, on the CPU.

The mesh is emulated: ``make_mesh(..., devices=["cpu"] * n)`` runs every
shard on the CPU, one after the other, as the single-controller port runs
them on cards.  The reference's ``shard_map`` bodies run without a JAX mesh,
under nested ``jax.vmap(..., axis_name="data")`` / ``axis_name="model"``,
where ``axis_index``, ``psum``, ``pmax`` and ``pmean`` take their meaning.

Held here:
- ``make_mesh`` / ``make_production_mesh``: shapes, axis names, the
  row-major device order, and the refusals that name both counts;
- every parameter's placement against the reference's ``PartitionSpec``,
  leaf for leaf, for every registered config (full size, shapes only) over
  tp in {1, 2, 4, 16}, dp in {1, 2, 16}, pods in {1, 2}; ``stack_specs``,
  ``tree_specs_to_shapes``, ``batch_spec`` and ``train_state_specs``;
- the tensor-parallel context without a mesh (ROADMAP C13): whole-model
  forwards at ``ShardCtx(tp=2)`` and ``(tp=4)``;
- expert parallelism: ``moe_ffn_sharded`` on ``[cpu] * (dp · tp)`` against
  the reference's ``moe_ffn_ep`` with a router biased to overflow an expert
  (the routing and the dropped set exact), and its gradient against the
  port's global ``moe_ffn``;
- split-S decode: ``partial_decode_attention``,
  ``combine_partial_attention``, and prefill + decode of the smoke
  granite-MoE and ``qwen3_8b`` over a mesh against the reference's decode
  with no mesh;
- data-parallel training: ``compressed_psum`` bit for bit, the step over
  ``[cpu] * 2`` bit for bit the step with ``microbatch = B/2``, and within
  the train tolerances of the reference's step.

Tolerances, as the files they come from state them: MoE outputs
(``test_torch_moe.py``) in float32 within 1e-5 of max |y|, in bfloat16 within
2^-5; the aux losses 1e-5 relative in float32, 2^-5 in bfloat16; model
logits (``test_torch_attention.py``, ``test_torch_moe.py``) in float32
within 1e-5 of the largest |logit|, in bfloat16 within 2^-5 of it, or the
reference's own bf16-to-float32 distance where that is larger; attention
outputs (``test_torch_attention.py``) 2e-5 in float32 and 2e-2 in
bfloat16, relative to the largest |value|; gradients within 1e-5 of each
leaf's largest |g|; the train step (``test_torch_train.py``): losses 1e-6
relative, the gradient norm 1e-5, params within 2.5e-3.  What the port
computes the same way twice (the data-parallel step against the
microbatched one, compression) is held bit for bit.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.kernels import ops as jops
from repro.models import attention as jatt
from repro.models import init_model as j_init_model
from repro.models import moe as jmoe
from repro.models.base import ShardCtx as JShardCtx
from repro.models.base import stack_specs as j_stack_specs
from repro.models.base import tree_specs_to_shapes as j_tree_specs_to_shapes
from repro.models.lm import forward as j_forward
from repro.models.lm import model_spec as j_model_spec
from repro.serve.engine import make_serve_fns as j_serve_fns
from repro.train import optimizer as jopt
from repro.train.trainstep import batch_spec as j_batch_spec
from repro.train.trainstep import make_shard_ctx as j_make_shard_ctx
from repro.train.trainstep import make_train_step as j_make_step
from repro.train.trainstep import train_state_specs as j_train_state_specs
from repro_torch.configs import ARCH_IDS, RunConfig, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SynthSpec, batch_at
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import attention as tatt
from repro_torch.models import moe as tmoe
from repro_torch.models import params_from_numpy
from repro_torch.models.base import (ShardCtx, keystr, matrix_spec, stack_specs, tree_flatten,
                                     tree_specs_to_shapes)
from repro_torch.models.lm import forward as t_forward
from repro_torch.models.lm import RowCaches, model_spec, replica
from repro_torch.serve import greedy_generate, make_serve_fns
from repro_torch.train import optimizer as topt
from repro_torch.train.trainstep import batch_spec, make_shard_ctx, make_train_step, \
    train_state_specs

MOE_ARCHS = ["granite_moe_3b_a800m", "qwen3_moe_30b_a3b"]
CPU = torch.device("cpu")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _cfgs(arch, dtype):
    return (dataclasses.replace(j_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


def _pairs(tp, dp, pods):
    kw = dict(tp=tp, dp=dp, pods=pods, data_axes=("pod", "data") if pods > 1 else ("data",))
    return JShardCtx(**kw), ShardCtx(**kw)


def _placements(tree, leaf):
    return {keystr(p): leaf(v) for p, v in tree_flatten(tree)}


# ------------------------------------------------------------------- mesh --


def test_make_mesh_shapes_axes_and_row_major_devices():
    devs = [f"cpu:{i}" for i in range(8)]
    mesh = make_mesh(2, 4, devices=devs)
    assert mesh.axis_names == ("data", "model") and mesh.shape == (2, 4)
    assert (mesh.dp_total, mesh.tp) == (2, 4)
    assert mesh.row_devices(1) == tuple(torch.device(d) for d in devs[4:])
    assert mesh.device(1, 2) == torch.device("cpu:6") and mesh.first == torch.device("cpu:0")
    row = mesh.row(1)
    assert row.shape == (1, 4) and row.devices == mesh.row_devices(1)
    pods = make_mesh(2, 2, pods=2, devices=devs)
    assert pods.axis_names == ("pod", "data", "model") and pods.shape == (2, 2, 2)
    assert pods.dp_total == 4 and pods.row_devices(3) == tuple(torch.device(d) for d in devs[6:])
    # an emulated mesh repeats one device
    assert make_mesh(1, 4, devices=["cpu"] * 4).devices == (CPU,) * 4


def test_make_mesh_refuses_more_devices_than_the_host_has(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(RuntimeError, match=r"needs 4 devices; this host has 3 CUDA devices"):
        make_mesh(2, 2)
    with pytest.raises(ValueError, match=r"needs 8 devices; 4 given"):
        make_mesh(2, 4, devices=["cpu"] * 4)


def test_production_mesh_shapes():
    one = make_production_mesh(devices=["cpu"] * 256)
    assert one.shape == (16, 16) and one.axis_names == ("data", "model")
    two = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert two.shape == (2, 16, 16) and two.axis_names == ("pod", "data", "model")
    assert two.dp_total == 32 and two.tp == 16


# ------------------------------------------------------------- placements --


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_equal_the_references_partition_specs(arch, pods):
    """Every leaf of the full config's parameter tree: its shape and its
    placement equal the reference's shape and ``tuple(pspec)``, over the
    whole context grid."""
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for tp in (1, 2, 4, 16):
        for dp in (1, 2, 16):
            jctx, tctx = _pairs(tp, dp, pods)
            want = _placements(j_model_spec(jcfg, jctx), lambda s: (s.shape, tuple(s.pspec)))
            got = _placements(model_spec(tcfg, tctx), lambda s: (s.shape, s.placement))
            assert got == want, (tp, dp)


def test_fsdp_and_tp_axes_and_stack_specs_vs_reference():
    from repro.models import base as jbase
    from repro_torch.models import base as tbase

    for tp, dp, pods in ((1, 1, 1), (4, 2, 1), (2, 16, 2), (16, 2, 2)):
        jctx, tctx = _pairs(tp, dp, pods)
        assert tctx.dp_total == jctx.dp_total and tctx.data_spec() == jctx.data_spec()
        for dim in (1, 2, 8, 30, 64, 4096):
            assert tbase.fsdp_axis(tctx, dim) == jbase.fsdp_axis(jctx, dim)
            assert tbase.tp_axis(tctx, dim) == jbase.tp_axis(jctx, dim)
        for tp_dim, fsdp_dim in ((0, 1), (1, 0), (None, 0), (0, None), (1, 1)):
            j = jbase.matrix_spec(jctx, (32, 64), tp_dim, fsdp_dim)
            t = matrix_spec(tctx, (32, 64), tp_dim, fsdp_dim)
            assert t.placement == tuple(j.pspec)
            js, ts = j_stack_specs(j, 5), stack_specs(t, 5)
            assert ts.shape == js.shape and ts.placement == tuple(js.pspec)


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "internvl2_76b", "musicgen_large"])
def test_tree_specs_to_shapes_vs_reference(arch):
    jctx, tctx = _pairs(4, 2, 2)
    jshapes, jspecs = j_tree_specs_to_shapes(j_model_spec(j_get_config(arch), jctx))
    tshapes, tspecs = tree_specs_to_shapes(model_spec(get_config(arch), tctx))
    want = _placements(jshapes, lambda s: (tuple(s.shape), np.dtype(s.dtype).name))
    got = _placements(tshapes, lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]))
    assert got == want
    assert all(t.device.type == "meta" for _, t in tree_flatten(tshapes))
    assert _placements(tspecs, lambda p: p) == _placements(jspecs, tuple)


@pytest.mark.parametrize("compression", [False, True])
@pytest.mark.parametrize("arch", ["smollm_360m", "granite_moe_3b_a800m", "internvl2_76b",
                                  "musicgen_large"])
def test_batch_spec_and_train_state_specs_vs_reference(arch, compression):
    for tp, dp, pods in ((1, 1, 1), (4, 16, 1), (16, 2, 2)):
        shape = dict(name="s", kind="train", seq_len=32, global_batch=32)
        jrun = JRunConfig(model=j_get_config(arch), shape=JShape(**shape), dp=dp, tp=tp,
                          pods=pods, grad_compression=compression)
        trun = RunConfig(model=get_config(arch), shape=ShapeConfig(**shape), dp=dp, tp=tp,
                         pods=pods, grad_compression=compression)
        jctx, tctx = j_make_shard_ctx(jrun), make_shard_ctx(trun)
        assert dataclasses.asdict(tctx) == dataclasses.asdict(jctx)
        assert batch_spec(trun.model, tctx) == {k: tuple(v) for k, v in
                                                 j_batch_spec(jrun.model, jctx).items()}
        (jps, jpp), (jos, jop) = j_train_state_specs(jrun.model, jrun, jctx)
        (tps, tpp), (tos, top) = train_state_specs(trun.model, trun, tctx)
        for jt, tt in ((jps, tps), (jos, tos)):
            assert _placements(tt, lambda t: (tuple(t.shape), str(t.dtype).split(".")[1])) == \
                _placements(jt, lambda s: (tuple(s.shape), np.dtype(s.dtype).name))
        for jt, tt in ((jpp, tpp), (jop, top)):
            assert _placements(tt, lambda p: p) == _placements(jt, tuple)
        assert ("err" in tos) == ("err" in top) == compression


# ------------------------------------------------- C13: tp > 1, no mesh ----


def _model_pair(arch, dtype, tp, seed=0):
    cfg, tcfg = _cfgs(arch, dtype)
    jctx, tctx = JShardCtx(tp=tp), ShardCtx(tp=tp)
    jparams = j_init_model(cfg, jctx, seed=seed)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu", ctx=tctx)
    return cfg, tcfg, jctx, tctx, jparams, model


def _forward_pair(arch, dtype, tp, tokens):
    cfg, tcfg, jctx, tctx, jparams, model = _model_pair(arch, dtype, tp)
    with jops.local_backend("xla"):
        jl, _, jaux = j_forward(jparams, cfg, jnp.asarray(tokens), jctx)
    tl, _, taux = t_forward(model, tcfg, torch.from_numpy(tokens), tctx)
    return np.asarray(jl.astype(jnp.float32)), tl.float().numpy(), jaux, taux


def _logit_limit(arch, tp, tokens, jl, dtype):
    """1e-5 of the largest |logit| in float32; in bfloat16 2^-5, or the
    reference's own bf16-to-float32 distance where that is larger."""
    if dtype == "float32":
        return 1e-5
    jl32 = _forward_pair(arch, "float32", tp, tokens)[0]
    return max(2.0 ** -5, float(np.abs(jl - jl32).max() / np.abs(jl32).max()))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "qwen3_8b"])
def test_forward_at_tensor_parallel_ctx_without_mesh_vs_reference(arch, dtype, tp):
    """ROADMAP C13: ``ShardCtx(tp)`` with no mesh is the global semantics,
    with the vocab padded to ``padded_vocab(tp)`` and the experts to
    ``padded_experts(tp)``."""
    tokens = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jl, tl, jaux, taux = _forward_pair(arch, dtype, tp, tokens)
    assert tl.shape == jl.shape == (2, 4, get_smoke_config(arch).padded_vocab(tp))
    rel = _logit_limit(arch, tp, tokens, jl, dtype)
    assert rel <= 2.0 ** -4
    np.testing.assert_allclose(tl, jl, rtol=0, atol=rel * np.abs(jl).max())
    assert set(taux) == set(jaux)
    for key in taux:
        assert float(taux[key]) == pytest.approx(float(jaux[key]), rel=1e-5 if dtype ==
                                                 "float32" else 2.0 ** -5)


# ---------------------------------------------------- expert parallelism ----


def _moe_inputs(cfg, e_pad, rng, B, S=16):
    """Random weights for ``e_pad`` experts (the padded ones included) and
    x, with the router's column 0 raised so that expert 0 overflows."""
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    params = {"router": rng.normal(0, 0.3, (d, e_pad)),
              "w_up": rng.normal(0, 0.1, (e_pad, d, f)),
              "w_down": rng.normal(0, 0.1, (e_pad, f, d))}
    if cfg.mlp_type in ("swiglu", "geglu"):
        params["w_gate"] = rng.normal(0, 0.1, (e_pad, d, f))
    x = rng.normal(size=(B, S, d))
    params["router"][:, 0] += 0.6 * np.sign(x.mean((0, 1)))
    return ({k: v.astype(np.float32) for k, v in params.items()}, x.astype(np.float32))


def _reference_dropped(top_e, e_count, capacity):
    """The reference's capacity rule on its own routing, in numpy (as in
    ``test_torch_moe.py``): the assignments past their expert's capacity
    after the stable sort."""
    flat = np.asarray(top_e).reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_e = flat[order]
    pos = np.arange(flat.size) - np.searchsorted(sorted_e, sorted_e, side="left")
    return set(order[(pos >= capacity) | (sorted_e >= e_count)].tolist())


def _reference_ep(cfg, jctx, jparams, jx, dp, tp, split):
    """The reference's ``moe_ffn_ep`` run as its ``shard_map`` would: each
    data row's tokens (the whole batch when it does not split) against
    each model shard's expert slice, under nested named vmaps."""
    e_loc = cfg.moe.padded_experts(tp) // tp
    local = {k: (v if k == "router" else v.reshape(tp, e_loc, *v.shape[1:]))
             for k, v in jparams.items()}
    axes = {k: (None if k == "router" else 0) for k in local}
    rows = jx.reshape(dp, jx.shape[0] // dp, *jx.shape[1:]) if split else jnp.stack([jx] * dp)
    body = jax.vmap(jax.vmap(lambda p, x: jmoe.moe_ffn_ep(p, cfg, x, jctx),
                             in_axes=(axes, None), axis_name="model"),
                    in_axes=(None, 0), axis_name="data")
    y, aux = body(local, rows)  # (dp, tp, b, S, d): the psum replicated over the model axis
    for s in range(1, tp):
        np.testing.assert_array_equal(np.asarray(y[:, s]), np.asarray(y[:, 0]))
    y = y[:, 0].reshape(-1, *jx.shape[1:]) if split else y[0, 0]
    return y, {k: v[0, 0] for k, v in aux.items()}


@pytest.mark.parametrize("dp,tp,B", [(1, 2, 2), (1, 4, 2), (2, 2, 2), (2, 4, 4), (2, 2, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_sharded_vs_reference_ep(arch, dtype, dp, tp, B):
    """``moe_ffn_sharded`` over ``[cpu] * (dp · tp)``: the output and the
    aux losses against the reference's ``moe_ffn_ep``; per data row the
    routing and the set of assignments dropped at the row's capacity,
    exact.  B = 3 over two data rows does not split: every row takes the
    whole batch."""
    cfg, tcfg = _cfgs(arch, dtype)
    jctx, tctx = JShardCtx(tp=tp, dp=dp), ShardCtx(tp=tp, dp=dp)
    e_pad = cfg.moe.padded_experts(tp)
    params, x = _moe_inputs(cfg, e_pad, _rng("ep", arch, dtype, dp, tp, B), B)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x, jd)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v).to(td) for k, v in params.items()}
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(td)
    split = B % dp == 0
    jy, jaux = _reference_ep(cfg, jctx, jparams, jx, dp, tp, split)
    mesh = make_mesh(dp, tp, devices=["cpu"] * (dp * tp))
    ty, taux = tmoe.moe_ffn_sharded(tparams, tcfg, tx, tctx, mesh)
    assert ty.dtype == td and ty.shape == tx.shape
    jy = np.asarray(jy.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=0, atol=tol * np.abs(jy).max())
    for key in ("moe_aux", "moe_z"):
        assert float(taux[key]) == pytest.approx(float(jaux[key]), rel=1e-5 if dtype ==
                                                 "float32" else 2.0 ** -5)

    e_loc = e_pad // tp
    b = B // dp if split else B
    dropped_any = False
    for r in range(dp if split else 1):
        rows = slice(r * b, (r + 1) * b)
        T = b * x.shape[1]
        cap = jmoe.expert_capacity(cfg, T)
        _, j_top_e, _ = jmoe._route(jparams, cfg, jx[rows].reshape(T, -1), e_pad)
        _, t_top_e, _ = tmoe._route(tparams, tcfg, tx[rows].reshape(T, -1), e_pad)
        np.testing.assert_array_equal(t_top_e.numpy(), np.asarray(j_top_e))
        kept = set()
        for s in range(tp):
            order, keep, _ = tmoe._dispatch(t_top_e, e_loc, cap, e_first=s * e_loc)
            kept |= set(order[keep].tolist())
        dropped = set(range(T * cfg.moe.top_k)) - kept
        assert dropped == _reference_dropped(j_top_e, e_pad, cap)
        dropped_any |= bool(dropped)
    assert dropped_any, "the biased router overflowed no expert"


@pytest.mark.parametrize("tp", [2, 4])
def test_moe_ffn_sharded_gradient_vs_global_moe_ffn(tp):
    """One data row (dp = 1) routes the whole batch at the global capacity,
    so expert parallelism is the global ``moe_ffn`` in another order of
    adds: the gradients of x and of every parameter (through the experts'
    slices, the shards' copies of x and the combine) within 1e-5 of each
    one's largest |g|, float32."""
    _, tcfg = _cfgs("granite_moe_3b_a800m", "float32")
    tctx = ShardCtx(tp=tp)
    params, x = _moe_inputs(tcfg, tcfg.moe.padded_experts(tp), _rng("ep-grad", tp), B=2)
    g = _rng("ep-grad-g", tp).normal(size=x.shape).astype(np.float32)
    mesh = make_mesh(1, tp, devices=["cpu"] * tp)

    def grads(fn):
        p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        y, aux = fn(p, tx)
        loss = (y * torch.from_numpy(g)).sum() + aux["moe_aux"] + aux["moe_z"]
        loss.backward()
        return {"x": tx.grad, **{k: v.grad for k, v in p.items()}}

    want = grads(lambda p, tx: tmoe.moe_ffn(p, tcfg, tx, tctx))
    got = grads(lambda p, tx: tmoe.moe_ffn_sharded(p, tcfg, tx, tctx, mesh))
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * max(float(w.abs().max()), 1e-30), err_msg=key)


# ----------------------------------------------------------- split-S decode --


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partial_decode_attention_vs_reference(dtype):
    """A shard's partial (o, m, l): GQA over 4 q heads a kv head, the
    last batch row with no valid slot (m = -1e30, l = 0, o = 0)."""
    rng = _rng("partial", dtype)
    B, Hq, Hkv, C, D = 3, 8, 2, 24, 16
    q = rng.normal(size=(B, Hq, 1, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Hkv, C, D)).astype(np.float32) for _ in range(2))
    valid = rng.random((B, C)) < 0.6
    valid[-1] = False
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jatt.partial_decode_attention(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                         jnp.asarray(valid))
    got = tatt.partial_decode_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                                        torch.from_numpy(valid))
    tol = 2e-5 if dtype == "float32" else 2e-2
    for name, g, w in zip("oml", got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=name)
    assert float(got[1][-1].max()) == float(np.float32(-1e30))
    assert float(got[2][-1].abs().max()) == 0 and float(got[0][-1].abs().max()) == 0


@pytest.mark.parametrize("tp", [2, 4])
def test_combine_partial_attention_vs_reference(tp):
    """The shards' partials combined (the reference under
    ``vmap(axis_name="model")``), one shard of each batch row with no valid
    slot."""
    rng = _rng("combine", tp)
    B, Hq, D = 3, 8, 16
    o = rng.normal(size=(tp, B, Hq, D)).astype(np.float32)
    m = rng.normal(size=(tp, B, Hq)).astype(np.float32)
    l = rng.uniform(0.5, 4, (tp, B, Hq)).astype(np.float32)
    m[-1], l[-1], o[-1] = -1e30, 0, 0
    want = jax.vmap(lambda a, b, c: jatt.combine_partial_attention(a, b, c, "model"),
                    axis_name="model")(jnp.asarray(o), jnp.asarray(m), jnp.asarray(l))[0]
    got = tatt.combine_partial_attention(*(list(torch.from_numpy(a)) for a in (o, m, l)))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("dp,tp", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "qwen3_8b"])
def test_decode_over_a_mesh_vs_reference_without_one(arch, dp, tp):
    """A prefill of 8 tokens then 4 decode steps over ``make_mesh(dp, tp)``
    (granite-MoE expert-parallel) against the reference's prefill and decode
    at the same context with no mesh, both fed the reference's greedy
    tokens: every step's logits within 1e-5 of the largest |logit|
    (float32).  Each decode step is split-S: the caches of the attention
    layers are sharded over the row's model shards."""
    cfg, tcfg, jctx, tctx, jparams, model = _model_pair(arch, "float32", tp)
    use_ep = tcfg.moe is not None
    B = 2
    prompt = _rng("decode", arch, dp, tp).integers(0, cfg.vocab, (B, 8)).astype(np.int32)
    jpre, jdec, _ = j_serve_fns(cfg, jctx, capacity=32)
    mesh = make_mesh(dp, tp, devices=["cpu"] * (dp * tp))
    tpre, tdec, new_cache = make_serve_fns(tcfg, tctx, mesh=mesh, capacity=32, use_ep=use_ep)
    with jops.local_backend("xla"):
        jl, jc = jpre(jparams, jnp.asarray(prompt))
    tl, tc = tpre(model, torch.from_numpy(prompt))
    sharded = [c for c in _caches(tc) if isinstance(c, tatt.ShardedKVCache)]
    assert sharded and all(len(c.k) == tp for c in sharded)
    for step in range(5):
        jl32 = np.asarray(jl.astype(jnp.float32))
        np.testing.assert_allclose(tl.numpy(), jl32, rtol=0, atol=1e-5 * np.abs(jl32).max(),
                                   err_msg=f"step {step}")
        if step == 4:
            break
        nxt = np.asarray(jnp.argmax(jl[..., :cfg.vocab], -1)).astype(np.int32)[:, None]
        pos = 8 + step
        with jops.local_backend("xla"):
            jl, jc = jdec(jparams, jc, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32))
        tl, tc = tdec(model, tc, torch.from_numpy(nxt), torch.tensor(pos, dtype=torch.int32))


def _caches(tree):
    if isinstance(tree, RowCaches):
        return [c for row in tree.rows for c in _caches(row)]
    if isinstance(tree, dict):
        return [c for v in tree.values() for c in _caches(v)]
    return [tree]


def test_split_s_cache_written_where_the_dense_path_writes():
    """A decode step of one attention block against a slot-sharded cache:
    the output equals the dense cached path's within 1e-5 (float32), and
    the gathered cache equals the dense path's written cache."""
    tcfg = dataclasses.replace(get_smoke_config("qwen3_8b"), dtype="float32")
    rng = _rng("split-cache")
    spec = tatt.attn_spec(tcfg, ShardCtx(tp=4))
    p = {n: torch.from_numpy((rng.normal(0, 0.2, s.shape) + (1.0 if n.endswith("norm") else 0))
                             .astype(np.float32)) for n, s in spec.items()}
    x = torch.from_numpy(rng.normal(size=(2, 9, tcfg.d_model)).astype(np.float32))
    pos = torch.arange(9)[None].expand(2, 9)
    mesh = make_mesh(1, 4, devices=["cpu"] * 4)
    cache = tatt.init_kv_cache(tcfg, 2, 16, device="cpu")
    _, cache = tatt.attention_block(p, tcfg, x[:, :8], pos[:, :8], cache=cache)
    dense, dense_c = tatt.attention_block(p, tcfg, x[:, 8:], pos[:, 8:], cache=cache,
                                          ctx=ShardCtx(tp=4))
    split, split_c = tatt.attention_block(p, tcfg, x[:, 8:], pos[:, 8:], cache=cache,
                                          mesh=mesh, ctx=ShardCtx(tp=4))
    assert isinstance(split_c, tatt.ShardedKVCache) and len(split_c.k) == 4
    np.testing.assert_allclose(split.numpy(), dense.numpy(), rtol=0,
                               atol=1e-5 * float(dense.abs().max()))
    gathered = split_c.gathered()
    assert torch.equal(gathered.k, dense_c.k) and torch.equal(gathered.v, dense_c.v)
    assert int(gathered.pos) == int(dense_c.pos) == 9


# ------------------------------------------------- data-parallel training --


@pytest.mark.parametrize("shards", [2, 4])
def test_compressed_psum_vs_reference_bit_for_bit(shards):
    rng = _rng("psum", shards)
    g = rng.normal(size=(shards, 33, 7)).astype(np.float32) * rng.uniform(0.1, 10, (shards, 1, 1))
    err = rng.normal(0, 0.01, (shards, 33, 7)).astype(np.float32)
    want, want_err = jax.vmap(lambda a, b: jopt.compressed_psum(a, b, "data"),
                              axis_name="data")(jnp.asarray(g), jnp.asarray(err))
    got, got_err = topt.compressed_psum(list(torch.from_numpy(g)), list(torch.from_numpy(err)))
    for s in range(shards):
        assert np.array_equal(got.numpy(), np.asarray(want[s]))
        assert np.array_equal(got_err[s].numpy(), np.asarray(want_err[s]))


SHAPE = dict(name="tiny", kind="train", seq_len=32, global_batch=4)


def _train_setup(arch, **run_kw):
    cfg, tcfg = _cfgs(arch, "float32")
    tp = run_kw.get("tp", 1)
    jparams = j_init_model(cfg, JShardCtx(tp=tp), seed=0)

    def model():
        return params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                                 trainable=True, ctx=ShardCtx(tp=tp))

    data = batch_at(SynthSpec(vocab=cfg.vocab, seq_len=32, batch=4, seed=1), 0)
    return cfg, tcfg, jparams, model, data


def _step(tcfg, model, data, mesh=None, use_ep=False, **run_kw):
    run = RunConfig(model=tcfg, shape=ShapeConfig(**SHAPE), **run_kw)
    step, _ = make_train_step(tcfg, run, mesh=mesh, opt=topt.AdamWConfig(
        lr=1e-3, warmup_steps=0, total_steps=10), use_ep=use_ep)
    state = topt.init_opt_state(model.tree())
    if run.grad_compression:
        state["err"] = topt.init_error_state(model.tree())
    return step(model, state, {k: torch.from_numpy(v) for k, v in data.items()})


def _bits_equal(a, b):
    fa, fb = tree_flatten(a), tree_flatten(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        torch.equal(x.detach(), y.detach()) for (_, x), (_, y) in zip(fa, fb))


@pytest.mark.parametrize("compression", [False, True])
def test_dp_step_equals_the_microbatched_step_bit_for_bit(compression):
    """smollm over ``make_mesh(2, 1)`` on ``[cpu] * 2``: each data row's
    gradient on its replica (the master itself: one device), added in row
    order and halved, is the ``microbatch = B/2`` step's accumulation: the
    parameters, both moments, the carried error and the loss bit for bit."""
    _, tcfg, _, model, data = _train_setup("smollm_360m")
    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    m1, s1, met1 = _step(tcfg, model(), data, mesh=mesh, dp=2, tp=1,
                         grad_compression=compression)
    m2, s2, met2 = _step(tcfg, model(), data, microbatch=2, dp=1, tp=1,
                         grad_compression=compression)
    assert replica(m1, "cpu") is m1
    assert _bits_equal(m1.tree(), m2.tree())
    for key in ("mu", "nu") + (("err",) if compression else ()):
        assert _bits_equal(s1[key], s2[key]), key
    assert torch.equal(met1["loss"], met2["loss"])
    assert torch.equal(met1["grad_norm"], met2["grad_norm"])


def test_dp_step_vs_reference_train_step():
    """The step over two data rows against the reference's step
    (microbatched in halves, the same mean of halves' gradients): the loss
    and gradient norm, and the params within the train tolerance."""
    cfg, tcfg, jparams, model, data = _train_setup("smollm_360m")
    jrun = JRunConfig(model=cfg, shape=JShape(**SHAPE), dp=1, tp=1, microbatch=2)
    jstep, _ = j_make_step(cfg, jrun, opt=jopt.AdamWConfig(lr=1e-3, warmup_steps=0,
                                                            total_steps=10))
    with jops.local_backend("xla"):
        jnew, _, jm = jstep(jparams, jopt.init_opt_state(jparams),
                            {k: jnp.asarray(v) for k, v in data.items()})
    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    tm_model, _, tm = _step(tcfg, model(), data, mesh=mesh, dp=2, tp=1)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    jnew = jax.tree.map(np.asarray, jnew)
    for path, p in tree_flatten(tm_model.tree()):
        want = jnew
        for k in path:
            want = want[k]
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0, atol=2.5e-3,
                                   err_msg=keystr(path))


def test_dp_and_ep_step_equals_the_microbatched_ep_step_bit_for_bit():
    """granite-MoE expert-parallel over ``make_mesh(2, 2)`` (four emulated
    shards) equals the ``microbatch = B/2`` step expert-parallel over one
    data row of two model shards: each row routes its half of the batch at
    the half's capacity in both."""
    _, tcfg, _, model, data = _train_setup("granite_moe_3b_a800m", tp=2)
    m1, s1, met1 = _step(tcfg, model(), data, mesh=make_mesh(2, 2, devices=["cpu"] * 4),
                         use_ep=True, dp=2, tp=2)
    m2, s2, met2 = _step(tcfg, model(), data, mesh=make_mesh(1, 2, devices=["cpu"] * 2),
                         use_ep=True, microbatch=2, dp=1, tp=2)
    assert _bits_equal(m1.tree(), m2.tree())
    assert _bits_equal(s1["mu"], s2["mu"]) and _bits_equal(s1["nu"], s2["nu"])
    assert torch.isfinite(met1["loss"]) and torch.equal(met1["grad_norm"], met2["grad_norm"])


# ------------------------------------------ replicas on distinct devices --
# ``cpu:i`` names a distinct device to the mesh and to ``replica``, while
# ``.to("cpu:i")`` copies: so the paths of a mesh over several cards (a
# replica a card, synced after each update; gradients of every replica
# added on the first; expert slices and cache shards from each card's own
# replica) run on the CPU, and must equal the emulated mesh's bit for bit.
CARDS = [f"cpu:{i}" for i in range(4)]


def test_dp_steps_over_distinct_devices_equal_the_microbatched_steps():
    """Two steps over ``make_mesh(2, 1)`` on two distinct devices (each
    row on its own replica, synced after the update) equal two
    ``microbatch = B/2`` steps bit for bit."""
    _, tcfg, _, model, data = _train_setup("smollm_360m")
    run_kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    got, want = model(), model()
    mesh = make_mesh(2, 1, devices=CARDS[:2])
    steps = {}
    for name, m, run, mesh_ in (("mesh", got, dict(dp=2, tp=1), mesh),
                                ("micro", want, dict(dp=1, tp=1, microbatch=2), None)):
        run = RunConfig(model=tcfg, shape=ShapeConfig(**SHAPE), **run)
        step, _ = make_train_step(tcfg, run, mesh=mesh_, opt=topt.AdamWConfig(**run_kw))
        state = topt.init_opt_state(m.tree())
        for i in range(2):
            batch = batch_at(SynthSpec(vocab=tcfg.vocab, seq_len=32, batch=4, seed=1), i)
            m, state, metrics = step(m, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        steps[name] = (m, state, metrics)
    assert replica(got, "cpu:1") is not got
    assert _bits_equal(replica(got, "cpu:1").tree(), got.tree())  # synced after the update
    assert _bits_equal(steps["mesh"][0].tree(), steps["micro"][0].tree())
    assert _bits_equal(steps["mesh"][1]["mu"], steps["micro"][1]["mu"])
    assert torch.equal(steps["mesh"][2]["loss"], steps["micro"][2]["loss"])


def test_dp_and_ep_step_over_distinct_devices_equals_the_emulated_mesh():
    """granite-MoE expert-parallel over ``make_mesh(2, 2)`` on four distinct
    devices (each shard's experts from its own replica, whose gradient
    slice is added on the first device) equals the same step over four
    shards of one device bit for bit."""
    _, tcfg, _, model, data = _train_setup("granite_moe_3b_a800m", tp=2)
    m1, s1, _ = _step(tcfg, model(), data, mesh=make_mesh(2, 2, devices=CARDS), use_ep=True,
                      dp=2, tp=2)
    m2, s2, _ = _step(tcfg, model(), data, mesh=make_mesh(2, 2, devices=["cpu"] * 4),
                      use_ep=True, dp=2, tp=2)
    assert _bits_equal(m1.tree(), m2.tree())
    assert _bits_equal(s1["mu"], s2["mu"]) and _bits_equal(s1["nu"], s2["nu"])


@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 2)])
def test_decode_over_distinct_devices_equals_the_emulated_mesh(dp, tp):
    """granite-MoE prefill + 4 greedy decode steps, expert-parallel and
    split-S, over distinct devices and over one device repeated: the same
    tokens and last logits bit for bit."""
    _, tcfg, _, tctx, _, model = _model_pair("granite_moe_3b_a800m", "float32", tp)
    prompt = torch.from_numpy(_rng("cards", dp, tp).integers(0, tcfg.vocab, (2, 8)))
    outs = []
    for devices in (CARDS[:dp * tp], ["cpu"] * (dp * tp)):
        pre, dec, _ = make_serve_fns(tcfg, tctx, mesh=make_mesh(dp, tp, devices=devices),
                                     capacity=32, use_ep=True)
        outs.append(greedy_generate(tcfg, model, pre, dec, prompt, 4))
    assert torch.equal(outs[0], outs[1])


def test_forward_refuses_a_mesh_of_another_tp():
    _, tcfg, _, tctx, _, model = _model_pair("qwen3_8b", "float32", 2)
    with pytest.raises(ValueError, match="a mesh of 4 model shards under ShardCtx\\(tp=2\\)"):
        t_forward(model, tcfg, torch.zeros(1, 4, dtype=torch.int64), tctx,
                  mesh=make_mesh(1, 4, devices=["cpu"] * 4))
