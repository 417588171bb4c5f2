"""The train state stored in slices over a model mesh's data rows, on the CPU.

``place_train_state`` / ``init_placed_state`` store each leaf
as the reference's placements say (``fsdp_axis`` over the data axes: the
dry run's input shardings), and the step over a placed state gathers each
layer's weights as it runs it and adds each row's gradient into the
slices' accumulators.  Held here:

- the layout: every leaf's slices (shape, device) for every registered
  config at dp 2 and 4 (full size, on ``meta`` tensors: nothing is
  allocated) against the reference's ``PartitionSpec``; an expert leaf's
  shard slices over ``make_mesh(2, 2)``;
- the bytes a data row holds for the full ``qwen3_8b``: 32.77 GB at dp 4
  against 131.05 GB whole, counted on ``meta`` tensors;
- the sliced step against the replicated step bit for bit (params, both
  moments, the error tree, loss and ``grad_norm``) over two steps, for
  ``smollm_360m`` and the smoke ``qwen3_8b``, on one device repeated and on
  distinct ``cpu:i`` devices, with and without compression and
  microbatching; granite-MoE expert-parallel over ``make_mesh(2, 2)``;
- the sliced step against the reference's ``make_train_step`` with
  ``tests/test_torch_mesh.py``'s train tolerances (loss 1e-6 relative,
  gradient norm 1e-5, params 2.5e-3);
- where a gradient lands: each piece a row's backward adds is a slice's
  part, added into that slice's accumulator; no gathered weight outlives
  its use, and no whole-leaf gradient is left after the step.
"""
import dataclasses
import gc
import weakref

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
from repro.models import init_model as j_init_model
from repro.models.base import ShardCtx as JShardCtx
from repro.models.lm import model_spec as j_model_spec
from repro.train import optimizer as jopt
from repro.train.trainstep import make_train_step as j_make_step
from repro_torch.configs import ARCH_IDS, RunConfig, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SynthSpec, batch_at
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LM, model_spec, params_from_numpy
from repro_torch.models import fsdp
from repro_torch.models.base import ShardCtx, keystr, tree_flatten, tree_specs_to_shapes
from repro_torch.train import optimizer as topt
from repro_torch.train.trainstep import (init_placed_state, init_train_state, make_shard_ctx,
                                         make_train_step, place_train_state, placement_bytes,
                                         row_state_bytes, value_and_grad)

SHAPE = dict(name="tiny", kind="train", seq_len=32, global_batch=4)
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
CARDS = [f"cpu:{i}" for i in range(4)]


def _meta_state(cfg, ctx):
    """A whole train state of ``meta`` tensors at ``ctx`` (no allocation)."""
    shapes, _ = tree_specs_to_shapes(model_spec(cfg, ctx))
    model = LM(cfg, shapes, ctx, trainable=True)
    return model, topt.init_opt_state(model.tree())


def _data_dim(pspec, jctx):
    return next((i for i, a in enumerate(pspec) if a == jctx.data_spec()), None)


# ------------------------------------------------------------------ layout --


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_slices_follow_the_references_placements(arch, dp):
    """Each leaf of the full config's state placed over ``make_mesh(dp,
    1)``: row ``r`` holds slice ``r`` of the dimension the reference's
    ``PartitionSpec`` gives the data axis, on ``mesh.device(r, 0)``; a leaf
    with no data axis whole on every row; the moments as their parameter."""
    cfg = get_config(arch)
    mesh = make_mesh(dp, 1, devices=["meta"] * dp)
    model, state = place_train_state(*_meta_state(cfg, ShardCtx()), mesh)
    jctx = JShardCtx(dp=dp)
    want = {keystr(p): (s.shape, tuple(s.pspec))
            for p, s in tree_flatten(j_model_spec(j_get_config(arch), jctx))}
    for tree in (model.tree(), state["mu"], state["nu"]):
        got = tree_flatten(tree)
        assert [keystr(p) for p, _ in got] == list(want)
        for path, leaf in got:
            shape, pspec = want[keystr(path)]
            dim = _data_dim(pspec, jctx)
            assert isinstance(leaf, fsdp.Sliced) and leaf.shape == shape
            assert leaf.dim == dim and leaf.tp_dim is None and leaf.rows == dp
            for r in range(dp):
                (part,) = leaf.parts[r]
                want_shape = list(shape)
                if dim is not None:
                    want_shape[dim] //= dp
                assert list(part.shape) == want_shape and part.dtype == torch.float32
                assert leaf.devices[r] == [mesh.device(r, 0)]


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "qwen3_moe_30b_a3b"])
def test_expert_slices_stay_on_their_model_shards(arch):
    """Over ``make_mesh(2, 2)`` at ``ShardCtx(tp=2)``: an expert leaf's
    shard ``s`` of row ``r`` holds experts ``[s·e/2, (s+1)·e/2)`` and row
    ``r``'s slice of its fsdp dimension (1 or 2 of the unstacked leaf), on
    ``mesh.device(r, s)``; a dense leaf whose placement names the model
    axis is sliced over the shards the same way (``wq`` by columns), one
    without it (the router) keeps its row's slice on the row's first
    device."""
    cfg = get_config(arch)
    mesh = make_mesh(2, 2, devices=["meta"] * 4)
    model, _ = place_train_state(*_meta_state(cfg, ShardCtx(tp=2)), mesh)
    moe = model.tree()["groups"]["p0_attn"]["moe"]
    for name, fsdp_dim in (("w_up", 2), ("w_down", 3), ("w_gate", 2)):
        leaf = moe[name]
        assert (leaf.tp_dim, leaf.dim, leaf.shards) == (1, fsdp_dim, 2), name
        for r in range(2):
            for s in range(2):
                want = list(leaf.shape)
                want[1] //= 2
                want[fsdp_dim] //= 2
                assert list(leaf.parts[r][s].shape) == want
                assert leaf.devices[r][s] == mesh.device(r, s)
    wq = model.tree()["groups"]["p0_attn"]["attn"]["wq"]
    assert wq.tp_dim == 2 and wq.shards == 2 and wq.dim == 1
    assert list(wq.parts[1][1].shape) == [wq.shape[0], wq.shape[1] // 2, wq.shape[2] // 2]
    assert wq.devices[1] == [mesh.device(1, 0), mesh.device(1, 1)]
    router = model.tree()["groups"]["p0_attn"]["moe"]["router"]
    assert router.tp_dim is None and router.shards == 1 and router.dim == 1


def test_row_bytes_of_the_full_qwen3_8b_from_meta_tensors():
    """qwen3_8b at full size: 8,190,735,360 parameters; weights, gradients
    and two moments in float32 take 131.05 GB whole and 32.77 GB a row
    sliced over four rows (308,224 elements, the norms, replicated); the
    placed state's rows hold the placements' reckoning, counted on its
    ``meta`` tensors."""
    cfg = get_config("qwen3_8b")
    whole, row = placement_bytes(cfg, ShardCtx(dp=4))
    n = 8_190_735_360
    assert whole == n * 16 and round(whole / 1e9, 2) == 131.05
    assert row == ((n - 308_224) // 4 + 308_224) * 16 and round(row / 1e9, 2) == 32.77
    mesh = make_mesh(4, 1, devices=["meta"] * 4)
    model, state = place_train_state(*_meta_state(cfg, ShardCtx()), mesh)
    held = row_state_bytes(model, state)
    assert held == [placement_bytes(cfg, ShardCtx(dp=4), arrays=3)[1]] * 4
    assert all(p.device.type == "meta" for _, leaf in tree_flatten(model.tree())
               for p in leaf.all_parts())


# ------------------------------------------------------------- bit for bit --


def _train(arch, devices, placed, tp=1, use_ep=False, steps=2, init="port", fsdp=True,
           **run_kw):
    """``steps`` steps over ``make_mesh(len(devices) // tp, tp)`` from one
    seed → (params, {mu, nu, err}, the last metrics), each leaf whole on the
    host; ``placed`` with ``fsdp=False``: held whole over the data rows."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    dp = len(devices) // tp
    run = RunConfig(model=cfg, shape=ShapeConfig(**SHAPE), dp=dp, tp=tp, **run_kw)
    mesh = make_mesh(dp, tp, devices=devices)
    step, ctx = make_train_step(cfg, run, mesh=mesh, opt=topt.AdamWConfig(**OPT),
                                use_ep=use_ep)
    if init == "mesh":  # placed leaf by leaf as it is made
        model, state = init_placed_state(cfg, run, ctx, mesh, seed=0)
    else:
        model, state = init_train_state(cfg, run, ctx, seed=0, device="cpu")
        if placed:
            model, state = place_train_state(model, state, mesh, fsdp=fsdp)
    for i in range(steps):
        batch = batch_at(SynthSpec(vocab=cfg.vocab, seq_len=32, batch=4, seed=1), i)
        model, state, metrics = step(model, state, {k: torch.from_numpy(v)
                                                    for k, v in batch.items()})
    whole = {k: _whole(v) for k, v in state.items() if k != "step"}
    return _whole(model.tree()), whole, metrics


def _whole(tree):
    return [(keystr(p), leaf.whole("cpu") if isinstance(leaf, fsdp.Sliced) else
             leaf.detach().clone()) for p, leaf in tree_flatten(tree)]


def _same(a, b):
    return [k for k, _ in a] == [k for k, _ in b] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(a, b))


@pytest.mark.parametrize("arch,devices,run_kw", [
    ("smollm_360m", ["cpu"] * 2, {}),
    ("smollm_360m", ["cpu"] * 2, {"grad_compression": True}),
    ("smollm_360m", CARDS[:2], {}),
    ("smollm_360m", CARDS[:2], {"grad_compression": True}),
    ("smollm_360m", ["cpu"] * 2, {"microbatch": 2, "grad_compression": True}),
    ("smollm_360m", ["cpu"] * 4, {"remat": "full"}),
    ("qwen3_8b", ["cpu"] * 2, {}),
    ("qwen3_8b", ["cpu"] * 2, {"grad_compression": True}),
    ("qwen3_8b", CARDS[:2], {"remat": "full"}),
    ("qwen3_8b", CARDS[:2], {"remat": "full", "grad_compression": True}),
], ids=["smollm", "smollm-int8", "smollm-cards", "smollm-cards-int8", "smollm-micro-int8",
        "smollm-4rows-remat", "qwen3", "qwen3-int8", "qwen3-cards-remat",
        "qwen3-cards-remat-int8"])
def test_sliced_step_equals_the_replicated_step_bit_for_bit(arch, devices, run_kw):
    """Two steps over the same mesh from the same seed, the state sliced
    and replicated: params, both moments, the error tree, the loss and the
    gradient norm bit for bit (each row's gradient slice added into its
    owner's accumulator in row order, as the replicated step adds the rows'
    gradients on its first device; the norm and the int8 scale read each
    leaf whole)."""
    p1, s1, m1 = _train(arch, devices, True, **run_kw)
    p2, s2, m2 = _train(arch, devices, False, **run_kw)
    assert _same(p1, p2)
    assert set(s1) == set(s2) == {"mu", "nu"} | ({"err"} if run_kw.get("grad_compression")
                                                  else set())
    for key in s1:
        assert _same(s1[key], s2[key]), key
    assert torch.equal(m1["loss"], m2["loss"]) and torch.equal(m1["grad_norm"], m2["grad_norm"])


@pytest.mark.parametrize("devices", [["cpu"] * 2, CARDS[:2]], ids=["emulated", "cards"])
def test_state_placed_as_it_is_made_equals_the_placed_whole_state(devices):
    """``init_placed_state`` draws each leaf from the seeded
    generator and slices it at once: the same slices, and the same two
    steps, as placing the whole state made from that seed."""
    a = _train("smollm_360m", devices, True, init="mesh", grad_compression=True)
    b = _train("smollm_360m", devices, True, grad_compression=True)
    assert _same(a[0], b[0]) and all(_same(a[1][k], b[1][k]) for k in a[1])
    assert torch.equal(a[2]["loss"], b[2]["loss"])


@pytest.mark.parametrize("devices", [["cpu"] * 4, CARDS], ids=["emulated", "cards"])
def test_sliced_expert_parallel_step_equals_the_replicated_one(devices):
    """granite-MoE expert-parallel over ``make_mesh(2, 2)`` with its expert
    slices (and, tensor parallel, its attention's slices) on their model
    shards, sliced over the rows within each shard: two steps bit for bit
    the steps of the same slices held whole on each row (replicated over
    the data rows)."""
    p1, s1, m1 = _train("granite_moe_3b_a800m", devices, True, tp=2, use_ep=True)
    p2, s2, m2 = _train("granite_moe_3b_a800m", devices, True, tp=2, use_ep=True, fsdp=False)
    assert _same(p1, p2) and _same(s1["mu"], s2["mu"]) and _same(s1["nu"], s2["nu"])
    assert torch.equal(m1["loss"], m2["loss"]) and torch.equal(m1["grad_norm"], m2["grad_norm"])


def test_sliced_step_vs_reference_train_step():
    """One step over two sliced rows against the reference's step on one
    device at the same ``ShardCtx`` (microbatched in halves: the same mean
    of the halves' gradients): the loss, the gradient norm and the params
    within the train tolerances."""
    cfg = dataclasses.replace(j_smoke("smollm_360m"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("smollm_360m"), dtype="float32")
    jparams = j_init_model(cfg, JShardCtx(), seed=0)
    data = batch_at(SynthSpec(vocab=cfg.vocab, seq_len=32, batch=4, seed=1), 0)
    jrun = JRunConfig(model=cfg, shape=JShape(**SHAPE), dp=1, tp=1, microbatch=2)
    jstep, _ = j_make_step(cfg, jrun, opt=jopt.AdamWConfig(**OPT))
    with jops.local_backend("xla"):
        jnew, _, jm = jstep(jparams, jopt.init_opt_state(jparams),
                            {k: jnp.asarray(v) for k, v in data.items()})
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                              trainable=True)
    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    model, state = place_train_state(model, topt.init_opt_state(model.tree()), mesh)
    run = RunConfig(model=tcfg, shape=ShapeConfig(**SHAPE), dp=2, tp=1)
    step, _ = make_train_step(tcfg, run, mesh=mesh, opt=topt.AdamWConfig(**OPT))
    model, _, tm = step(model, state, {k: torch.from_numpy(v) for k, v in data.items()})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    jnew = jax.tree.map(np.asarray, jnew)
    for path, leaf in tree_flatten(model.tree()):
        want = jnew
        for k in path:
            want = want[k]
        np.testing.assert_allclose(leaf.whole("cpu").numpy(), want, rtol=0, atol=2.5e-3,
                                   err_msg=keystr(path))


# -------------------------------------------------------- where it lands --


def test_a_gathered_layers_gradient_reaches_only_its_slices(monkeypatch):
    """Over four distinct devices: a row's backward hands each leaf's
    gathered layer one gradient, whose pieces land in the slices'
    accumulators, each slice's accumulator its own region of the replicated
    step's gradient; the gathered weights are freed by the time the
    backward ends; after the step no leaf holds a gradient."""
    cfg = dataclasses.replace(get_smoke_config("qwen3_8b"), dtype="float32")
    run = RunConfig(model=cfg, shape=ShapeConfig(**SHAPE), dp=4, tp=1, remat="full")
    mesh = make_mesh(4, 1, devices=CARDS)
    ctx = make_shard_ctx(run)
    whole_model, _ = init_train_state(cfg, run, ctx, seed=0, device="cpu")
    model, state = init_placed_state(cfg, run, ctx, mesh, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in
             batch_at(SynthSpec(vocab=cfg.vocab, seq_len=32, batch=4, seed=1), 0).items()}
    _, _, want = value_and_grad(whole_model, cfg, batch, ctx, True, mesh)

    pieces, gathered = [], []
    add, whole = fsdp.Sliced.add_grad, fsdp.Sliced.whole

    def record_add(self, grad, layer, shard):
        pieces.append((id(self), layer, tuple(grad.shape), self.shape))
        add(self, grad, layer, shard)

    def record_whole(self, device, layer=None, shard=None, row=0):
        out = whole(self, device, layer, shard, row)
        gathered.append(weakref.ref(out))
        return out

    monkeypatch.setattr(fsdp.Sliced, "add_grad", record_add)
    monkeypatch.setattr(fsdp.Sliced, "whole", record_whole)
    _, _, grads = value_and_grad(model, cfg, batch, ctx, True, mesh)
    monkeypatch.undo()
    gc.collect()
    assert gathered and all(ref() is None for ref in gathered)
    counts = {}
    for leaf_id, layer, shape, leaf_shape in pieces:
        assert shape == leaf_shape[0 if layer is None else 1:]  # one layer, gathered
        counts[(leaf_id, layer)] = counts.get((leaf_id, layer), 0) + 1
    assert set(counts.values()) == {4}  # one piece a row for each leaf and layer
    for (path, leaf), (_, g), (_, w) in zip(tree_flatten(model.tree()), tree_flatten(grads),
                                            tree_flatten(want)):
        assert g is leaf.grad
        rows = leaf.rows if leaf.dim is not None else 1
        assert g.rows == rows and g.devices == leaf.devices[:rows]
        for r in range(rows):
            (part,) = g.parts[r]
            region = w[leaf.region(r if leaf.dim is not None else None, 0)]
            assert part.shape == leaf.parts[r][0].shape and torch.equal(part, region), \
                (keystr(path), r)
        assert all(p.grad is None for p in leaf.all_parts())
    step, _ = make_train_step(cfg, run, mesh=mesh, opt=topt.AdamWConfig(**OPT))
    step(model, state, batch)
    assert all(leaf.grad is None and all(p.grad is None for p in leaf.all_parts())
               for _, leaf in tree_flatten(model.tree()))


def test_place_train_state_consumes_the_whole_state():
    """The whole state given is dropped leaf by leaf as it is sliced (the
    reference's dry run donates it): the model's parameters become sliced
    leaves, and no whole tensor of the state is left on the model or in
    the optimizer state."""
    cfg = dataclasses.replace(get_smoke_config("smollm_360m"), dtype="float32")
    run = RunConfig(model=cfg, shape=ShapeConfig(**SHAPE), dp=2, tp=1, grad_compression=True)
    model, state = init_train_state(cfg, run, make_shard_ctx(run), seed=0, device="cpu")
    refs = [weakref.ref(t) for _, t in tree_flatten({"p": model.tree(), "mu": state["mu"]})]
    placed, pstate = place_train_state(model, state, make_mesh(2, 1, devices=["cpu"] * 2))
    gc.collect()
    assert placed is model and model.placed and not list(model.parameters())
    assert all(r() is None for r in refs)
    assert all(isinstance(leaf, fsdp.Sliced) for key in ("mu", "nu", "err")
               for _, leaf in tree_flatten(pstate[key]))


def test_place_train_state_refuses_a_mesh_of_another_tp():
    cfg = dataclasses.replace(get_smoke_config("smollm_360m"), dtype="float32")
    model, state = _meta_state(cfg, ShardCtx())
    with pytest.raises(ValueError, match="a mesh of 2 model shards under ShardCtx\\(tp=1\\)"):
        place_train_state(model, state, make_mesh(2, 2, devices=["meta"] * 4))
