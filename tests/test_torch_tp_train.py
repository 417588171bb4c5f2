"""Training under tensor parallelism (TP, and TP × FSDP) on the CPU, against
the JAX package: ``qwen3_8b`` and ``mamba2_2p7b`` here, with the cases of no
one architecture; ``granite_moe_3b_a800m`` and ``recurrentgemma_9b`` in
``test_torch_tp_train_moe_rglru.py``, which shares this file's helpers (the
file split in two along its parametrisation, so that each runs in about half
the time on one worker).

The mesh is emulated as in ``test_torch_tensor_parallel.py``: ``make_mesh(...,
devices=["cpu"] * n)`` runs every shard on the CPU one after the other, and
``cpu:i`` devices stand for distinct cards (``.to("cpu:1")`` copies).  The
reference shards with GSPMD over the ``model`` axis, which does not change the
answer: its ``loss_fn`` at ``ShardCtx(tp)`` with no mesh (the padded vocab,
the padded experts) is what the port's step over the model shards computes.
Inputs (parameters, token batches) come from seeds through numpy.

Held over both files, at the smoke configs (2 layers, widths that tp 2 and 4
divide, 32 tokens: every step runs the reference's sequence parallelism and
takes its loss on the head's vocabulary slices):
- the TP step's loss and every leaf's gradient against ``jax.value_and_grad``
  of the reference's ``loss_fn`` for a dense model, an MoE (expert-parallel
  over the same shards), ``mamba2_2p7b`` and ``recurrentgemma_9b`` at tp 2
  and 4: the loss within 1e-6 relative, each gradient within 1e-4 of its
  leaf's largest |g| (float32; the row-parallel products add their partials
  in another order);
- TP × FSDP over ``(2, 2)`` bit for bit the TP step over ``(1, 2)`` with
  microbatches of half the batch; tp 1 over a mesh bit for bit the no-mesh
  step; a repeat bit for bit; the state held whole on each row bit for bit
  the state sliced over the rows;
- two AdamW steps on the port's TP gradients against the reference's
  ``adamw_update`` on the same gradients (1e-6 relative, as
  ``test_torch_train.py`` holds AdamW);
- a checkpoint of a ``(2, 2)`` state round trip, and a run killed at step
  2 resumed in place, bit for bit three uninterrupted steps;
- ``mamba2_2p7b``'s and ``recurrentgemma_9b``'s served prefill and decode
  steps under tp 4 against the reference's serve fns (float32 limit 1e-5 of
  the largest |logit|);
- each card's bytes against the placements' reckoning, with no whole copy of
  a model-axis leaf on any card, for every registered config at full size
  on ``meta``; the global norm a layer at a time past ``NORM_WHOLE_MAX``
  (within 1e-6 relative of the whole leaf's, the same bits in every layout);
- the moves' fixed backward (a broadcast's gradient added in float32 in
  shard order and rounded once), and their profiler ranges;
- ``launch.train --dp 2 --tp 2 --fsdp`` end to end on the CPU, equal to
  ``--dp 2 --tp 2``, and a q-head count ``--tp`` does not divide refused.
"""
import dataclasses
import io
import math
import zlib
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.models import init_model as j_init_model
from repro.models.base import ShardCtx as JShardCtx
from repro.train import optimizer as jopt
from repro.train.trainstep import loss_fn as j_loss_fn
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import ARCH_IDS, RunConfig, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SynthSpec, batch_at
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LM, fsdp, model_spec, params_from_numpy
from repro_torch.models import tp as TP
from repro_torch.models.base import ShardCtx, keystr, tree_flatten, tree_specs_to_shapes
from repro_torch.train import optimizer as topt
from repro_torch.train import trainstep
from repro_torch.train.trainstep import (card_state_bytes, init_placed_state, init_train_state,
                                         make_train_step, place_train_state, value_and_grad)

CARDS = [f"cpu:{i}" for i in range(4)]
SHAPE = dict(name="tiny", kind="train", seq_len=32, global_batch=4)
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
LOSS_REL = 1e-6
GRAD_TOL = 1e-4
ADAM_REL = 1e-6
F32_TOL = 1e-5
ARCHS = ["qwen3_8b", "granite_moe_3b_a800m", "mamba2_2p7b", "recurrentgemma_9b"]
HERE = ["qwen3_8b", "mamba2_2p7b"]  # the rest of ARCHS: test_torch_tp_train_moe_rglru.py


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (restored after): its
    steps are many small ops, and under parallel test workers more threads
    only oversubscribe the cores.  Every comparison here is within one
    process or within a tolerance."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _cfgs(arch):
    return (dataclasses.replace(j_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def _data(cfg, i=0, batch=4, seq=32):
    return batch_at(SynthSpec(vocab=cfg.vocab, seq_len=seq, batch=batch,
                              n_codebooks=cfg.n_codebooks, seed=1), i)


def _torch(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


def _reference(cfg, tp, seed=0):
    return j_init_model(cfg, JShardCtx(tp=tp), seed=seed)


def _placed(jparams, tcfg, tp, mesh):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, ctx=ShardCtx(tp=tp),
                             trainable=True, mesh=mesh)


def _whole(tree):
    return [(keystr(p), leaf.whole("cpu") if isinstance(leaf, fsdp.Sliced) else
             leaf.detach().clone()) for p, leaf in tree_flatten(tree)]


def _same(a, b):
    return [k for k, _ in a] == [k for k, _ in b] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(a, b))


def _close(got, want_tree, rel, what):
    want = {keystr(p): np.asarray(v) for p, v in tree_flatten(want_tree)}
    assert [k for k, _ in got] == list(want)
    for key, g in got:
        w = want[key]
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=rel * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=f"{what} {key}")


# ----------------------------------------------- the step against the JAX one --


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", HERE)
def test_tp_step_loss_and_every_gradient_vs_reference(arch, tp, remat):
    """The loss and every leaf's gradient of a step over ``make_mesh(1,
    tp)`` (tp 2 over distinct devices, tp 4 over one device repeated), each
    model-axis leaf's gradient accumulated in its shards' slices, against
    ``jax.value_and_grad`` of the reference's ``loss_fn`` at
    ``ShardCtx(tp)``."""
    step_vs_reference(arch, tp, remat)


def step_vs_reference(arch, tp, remat):
    """:func:`test_tp_step_loss_and_every_gradient_vs_reference`'s body."""
    cfg, tcfg = _cfgs(arch)
    jparams = _reference(cfg, tp)
    data = _data(cfg)
    with jops.local_backend("xla"):
        (jl, _), jg = jax.value_and_grad(
            lambda p: j_loss_fn(p, cfg, {k: jnp.asarray(v) for k, v in data.items()},
                                JShardCtx(tp=tp), None, remat == "full", False),
            has_aux=True)(jparams)
    mesh = make_mesh(1, tp, devices=CARDS[:tp] if tp == 2 else ["cpu"] * tp)
    model = _placed(jparams, tcfg, tp, mesh)
    assert model.placed_tp
    tl, _, grads = value_and_grad(model, tcfg, _torch(data), ShardCtx(tp=tp), remat == "full",
                                  mesh)
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_REL)
    sliced = 0
    for (path, g), (_, leaf) in zip(tree_flatten(grads), tree_flatten(model.tree())):
        assert g is leaf.grad and [p.device for p in g.all_parts()] == [
            p.device for p in leaf.all_parts()[:len(g.all_parts())]], keystr(path)
        sliced += g.tp_dim is not None
    assert sliced > 0
    _close(_whole(grads), jax.tree.map(np.asarray, jg), GRAD_TOL, "grad")


def _steps(arch, dp, tp, devices, steps=2, placed=True, fsdp_rows=True, **run_kw):
    """``steps`` steps from one seed over ``make_mesh(dp, tp, devices)``
    (``placed``: the train storage; else the whole state on the CPU and no
    mesh) → (params, moments, the metrics of each step), whole on the
    host."""
    _, tcfg = _cfgs(arch)
    run = RunConfig(model=tcfg, shape=ShapeConfig(**SHAPE), dp=dp, tp=tp, **run_kw)
    mesh = make_mesh(dp, tp, devices=devices) if placed else None
    step, ctx = make_train_step(tcfg, run, mesh=mesh, opt=topt.AdamWConfig(**OPT))
    if placed:
        model, state = init_placed_state(tcfg, run, ctx, mesh, seed=0, fsdp=fsdp_rows)
    else:
        model, state = init_train_state(tcfg, run, ctx, seed=0, device="cpu")
    metrics = []
    for i in range(steps):
        model, state, m = step(model, state, _torch(_data(tcfg, i)))
        metrics.append(m)
    return (_whole(model.tree()), {k: _whole(state[k]) for k in ("mu", "nu")}, metrics)


def _assert_steps_equal(a, b):
    """Params, moments, losses and gradient norms bit for bit."""
    assert _same(a[0], b[0])
    assert _same(a[1]["mu"], b[1]["mu"]) and _same(a[1]["nu"], b[1]["nu"])
    for ma, mb in zip(a[2], b[2]):
        assert torch.equal(ma["loss"], mb["loss"])
        assert torch.equal(ma["grad_norm"], mb["grad_norm"])


@pytest.mark.parametrize("arch,devices", [(a, d) for a in HERE for d in ("emulated", "distinct")]
                         + [("qwen3_8b", "norm by layer")])
def test_tp_fsdp_step_equals_the_tp_step_bit_for_bit(arch, devices, monkeypatch):
    """Two steps over ``make_mesh(2, 2)`` with the state in slices over the
    rows and the shards (TP × FSDP; each row its half of the batch) equal
    two steps over ``make_mesh(1, 2)`` with microbatches of half the batch:
    params, both moments, losses and gradient norms bit for bit; also with
    the global norm taken a layer at a time (``NORM_WHOLE_MAX`` lowered
    under the stacked leaves).  An MoE routes the whole batch at one
    capacity on the first row's cards (the reference's global ``moe_ffn``),
    so its ``(2, 2)`` steps equal the ``(1, 2)`` steps on the whole batch."""
    fsdp_vs_tp(arch, devices, monkeypatch)


def fsdp_vs_tp(arch, devices, monkeypatch):
    """:func:`test_tp_fsdp_step_equals_the_tp_step_bit_for_bit`'s body."""
    if devices == "norm by layer":
        monkeypatch.setattr(topt, "NORM_WHOLE_MAX", 100)
    four = ["cpu"] * 4 if devices == "emulated" else CARDS
    a = _steps(arch, 2, 2, four)
    b = _steps(arch, 1, 2, four[:2], microbatch=None if get_smoke_config(arch).moe else 2)
    _assert_steps_equal(a, b)


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "recurrentgemma_9b"])
def test_recompute_over_the_shards_equals_keeping_the_activations(arch, monkeypatch):
    """A remat region over the model shards (``lm._Recompute``: run again
    and differentiated inside one backward node, ROADMAP C18) gives the
    loss and every gradient of the same step with its activations kept, bit
    for bit, over distinct devices; and it, not ``torch.utils.checkpoint``,
    takes the regions."""
    from repro_torch.models import lm

    _, tcfg = _cfgs(arch)
    mesh = make_mesh(1, 2, devices=CARDS[:2])
    calls = []
    run = lm._Recompute.run

    def counting(*args):
        calls.append(1)
        return run(*args)

    monkeypatch.setattr(lm._Recompute, "run", counting)
    monkeypatch.setattr(lm, "checkpoint", None)  # the non-reentrant recompute is not taken
    out = []
    for remat in (True, False):
        model, _ = init_placed_state(tcfg, RunConfig(model=tcfg, shape=ShapeConfig(**SHAPE),
                                                     tp=2), ShardCtx(tp=2), mesh)
        total, _, grads = value_and_grad(model, tcfg, _torch(_data(tcfg)), ShardCtx(tp=2),
                                         remat, mesh)
        out.append((total, _whole(grads)))
    assert calls and torch.equal(out[0][0], out[1][0]) and _same(out[0][1], out[1][1])


@pytest.mark.parametrize("arch", ["qwen3_8b", "mamba2_2p7b"])
def test_tp1_step_over_a_mesh_equals_the_no_mesh_step_bit_for_bit(arch):
    """The train storage over ``make_mesh(1, 1)`` (no leaf sliced: the
    placements at tp 1 name no model axis) steps bit for bit as the whole
    state with no mesh, two steps."""
    _assert_steps_equal(_steps(arch, 1, 1, ["cpu"]), _steps(arch, 1, 1, None, placed=False))


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "recurrentgemma_9b"])
def test_tp_step_repeats_bit_for_bit(arch):
    """The same two TP steps over four distinct devices, twice, from the
    same seed: the same bits."""
    _assert_steps_equal(_steps(arch, 1, 4, CARDS), _steps(arch, 1, 4, CARDS))


def test_state_held_whole_on_each_row_equals_the_sliced_rows():
    """``--tp`` without ``--fsdp``: the slices over the shards held whole
    on every data row (the gradient added on row 0's, the update copied to
    the others) equal the state sliced over the rows bit for bit."""
    _assert_steps_equal(_steps("qwen3_8b", 2, 2, CARDS, fsdp_rows=False),
                        _steps("qwen3_8b", 2, 2, CARDS))


@pytest.mark.parametrize("arch", ["qwen3_8b", "mamba2_2p7b"])
def test_two_adamw_steps_on_tp_gradients_vs_reference(arch, monkeypatch):
    """Two steps over ``make_mesh(1, 2)``: the first loss against the
    reference's, and each step's AdamW update against the reference's
    ``adamw_update`` fed the port's gradients (whole on the host) from the
    same params and moments: params and moments within 1e-6 relative, the
    gradient norm and the learning rate too."""
    cfg, tcfg = _cfgs(arch)
    jparams = _reference(cfg, 2)
    mesh = make_mesh(1, 2, devices=CARDS[:2])
    model = _placed(jparams, tcfg, 2, mesh)
    state = topt.init_opt_state(model.tree())
    run = RunConfig(model=tcfg, shape=ShapeConfig(**SHAPE), dp=1, tp=2)
    step, _ = make_train_step(tcfg, run, mesh=mesh, opt=topt.AdamWConfig(**OPT))
    seen = []
    update = trainstep.adamw_update

    def recording(cfg_, params, grads, st):
        seen.append(dict(_whole(grads)))
        return update(cfg_, params, grads, st)

    monkeypatch.setattr(trainstep, "adamw_update", recording)
    jp, js = jparams, jopt.init_opt_state(jparams)
    paths = [p for p, _ in tree_flatten(jax.tree.map(np.asarray, jparams))]
    for i in range(2):
        data = _data(tcfg, i)
        if i == 0:
            with jops.local_backend("xla"):
                jl, _ = j_loss_fn(jp, cfg, {k: jnp.asarray(v) for k, v in data.items()},
                                  JShardCtx(tp=2), None, False, False)
        model, state, tm = step(model, state, _torch(data))
        if i == 0:
            assert float(tm["loss"]) == pytest.approx(float(jl), rel=LOSS_REL)
        grads = {}
        for path in paths:
            node = grads
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = jnp.asarray(seen[i][keystr(path)].numpy())
        jp, js, jm = jopt.adamw_update(jopt.AdamWConfig(**OPT), jp, grads, js)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=ADAM_REL)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=ADAM_REL)
        for got, want in ((model.tree(), jp), (state["mu"], js["mu"]), (state["nu"], js["nu"])):
            for (path, g), (_, w) in zip(_whole(got), tree_flatten(jax.tree.map(np.asarray,
                                                                                want))):
                np.testing.assert_allclose(g.numpy(), w, rtol=ADAM_REL, atol=1e-7,
                                           err_msg=f"step {i} {path}")


# ------------------------------------------------------------- checkpoints --


def test_tp_fsdp_checkpoint_round_trip_into_its_slices(tmp_path):
    """A ``(2, 2)`` state after a step, saved, restores in place into a
    state of the same layout drawn from another seed (each slice on its
    card), and into a whole state, bit for bit."""
    _, tcfg = _cfgs("granite_moe_3b_a800m")
    run = RunConfig(model=tcfg, shape=ShapeConfig(**SHAPE), dp=2, tp=2, grad_compression=True)
    mesh = make_mesh(2, 2, devices=CARDS)
    step, ctx = make_train_step(tcfg, run, mesh=mesh, opt=topt.AdamWConfig(**OPT))
    model, state = init_placed_state(tcfg, run, ctx, mesh, seed=0)
    model, state, _ = step(model, state, _torch(_data(tcfg)))
    CheckpointManager(str(tmp_path)).save(1, {"params": model.tree(), "opt": state})
    want = _whole({"params": model.tree(), "opt": state})
    other, ostate = init_placed_state(tcfg, run, ctx, mesh, seed=7)
    parts = [p for _, leaf in tree_flatten(other.tree()) for p in leaf.all_parts()]
    CheckpointManager(str(tmp_path)).restore_into({"params": other.tree(), "opt": ostate})
    assert _same(_whole({"params": other.tree(), "opt": ostate}), want)
    assert parts == [p for _, leaf in tree_flatten(other.tree()) for p in leaf.all_parts()]
    whole, wstate = init_train_state(tcfg, run, ctx, seed=7, device="cpu")
    CheckpointManager(str(tmp_path)).restore_into({"params": whole.tree(), "opt": wstate})
    assert _same(_whole({"params": whole.tree(), "opt": wstate}), want)


# ------------------------------------------------------- bytes and norms --


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_each_cards_bytes_are_the_placements_reckoning(arch):
    """Every registered config at full size over ``make_mesh(2, 2)`` of
    ``meta`` devices, placed as TP × FSDP: each card's weights and moments
    are ``chip_smoke.tp_train_reckoning``'s bytes; a model-axis leaf lies a
    quarter a card (half over the shards, half over the rows where its
    placement names the data axis), no card holding it whole."""
    cfg = get_config(arch)
    ctx = ShardCtx(tp=2)
    shapes, _ = tree_specs_to_shapes(model_spec(cfg, ctx))
    model = LM(cfg, shapes, ctx, trainable=True)
    model, state = place_train_state(model, topt.init_opt_state(model.tree()),
                                     make_mesh(2, 2, devices=["meta"] * 4))
    assert card_state_bytes(model, state) == chip_smoke.tp_train_reckoning(cfg, 2, 2, arrays=3)
    split = 0
    for path, leaf in tree_flatten(model.tree()):
        if leaf.tp_dim is None:
            continue
        split += 1
        n = leaf.numel() // 2 // (2 if leaf.dim is not None else 1)
        assert leaf.shards == 2 and all(p.numel() == n for p in leaf.all_parts()), keystr(path)
    assert split > 0


@pytest.mark.parametrize("arch,dp,tp,layers", [("qwen3_moe_30b_a3b", 2, 2, 24),
                                               ("qwen3_8b", 2, 2, 36)])
def test_four_card_depths(arch, dp, tp, layers):
    """``tools/tp_train_cards.py``'s depths: the deepest cut whose fullest
    card, reckoned, stays within REG_BUDGET (one layer more passes it)."""
    cfg = get_config(arch)
    r = chip_smoke.tp_train_depth(cfg, dp, tp, batch=2)
    assert r["layers"] == layers and r["bytes"] <= chip_smoke.REG_BUDGET
    if layers < cfg.n_layers:
        deeper = dataclasses.replace(cfg, n_layers=layers + 1)
        assert max(chip_smoke.tp_train_reckoning(deeper, dp, tp)) + chip_smoke.tp_train_extra(
            cfg, layers + 1, dp, tp, 2) > chip_smoke.REG_BUDGET


@pytest.mark.parametrize("layout", [(1, 2), (2, 2)])
def test_global_norm_a_layer_at_a_time_past_its_limit(layout, monkeypatch):
    """With ``NORM_WHOLE_MAX`` lowered under the stacked leaves, the global
    norm gathers them a layer at a time: within 1e-6 relative of the norm
    that gathers each leaf whole (the layout-free bits are held by
    ``test_tp_fsdp_step_equals_the_tp_step_bit_for_bit[norm by layer]``)."""
    dp, tp = layout
    _, tcfg = _cfgs("qwen3_8b")
    run = RunConfig(model=tcfg, shape=ShapeConfig(**SHAPE), dp=dp, tp=tp)
    mesh = make_mesh(dp, tp, devices=CARDS[:dp * tp])
    model, _ = init_placed_state(tcfg, run, trainstep.make_shard_ctx(run), mesh, seed=0)
    _, _, grads = value_and_grad(model, tcfg, _torch(_data(tcfg)), ShardCtx(tp=tp), False, mesh)
    whole = topt.global_norm(grads)
    monkeypatch.setattr(topt, "NORM_WHOLE_MAX", 100)
    assert any(g.numel() > 100 and 0 not in (g.dim, g.tp_dim) for _, g in tree_flatten(grads))
    by_layer = topt.global_norm(grads)
    assert float(by_layer) == pytest.approx(float(whole), rel=1e-6)


# ------------------------------------------------------------------ moves --


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_broadcast_backward_adds_in_shard_order_in_float32(dtype):
    """The shards' gradients of a broadcast come back added on its device in
    float32 in shard order and rounded once; a reduce_sum's gradient goes
    out to every shard, a join's backward hands each shard its columns, a
    scatter's brings each part home."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, generator=g).to(dtype).requires_grad_(True)
    outs = TP.broadcast(x, CARDS)
    gs = [torch.randn(3, 8, generator=g).to(dtype) for _ in CARDS]
    torch.autograd.backward(outs, gs)
    want = gs[0].float()
    for t in gs[1:]:
        want = want + t.float()
    assert torch.equal(x.grad, want.to(dtype))
    parts = [torch.randn(3, 4, generator=g).requires_grad_(True) for _ in range(2)]
    joined = TP.join(parts, -1, "cpu")
    dy = torch.randn(3, 8, generator=g)
    joined.backward(dy)
    assert torch.equal(parts[0].grad, dy[:, :4]) and torch.equal(parts[1].grad, dy[:, 4:])
    parts = [torch.randn(3, 4, generator=g).requires_grad_(True) for _ in range(2)]
    total = TP.reduce_sum(parts, "cpu")
    assert torch.equal(total, parts[0] + parts[1])
    total.backward(dy[:, :4])
    assert all(torch.equal(p.grad, dy[:, :4]) for p in parts)
    y = torch.randn(3, 8, generator=g, requires_grad=True)
    moved = TP.scatter(y.chunk(2, -1), CARDS[:2])
    torch.autograd.backward(moved, [dy[:, :4], dy[:, 4:]])
    assert torch.equal(y.grad, dy)


def test_tp_step_traces_the_moves_in_both_directions():
    """A TP training step's trace holds the moves' ranges, its backward's
    among them, and the gathers and gradient adds of the train storage."""
    from torch.profiler import profile

    _, tcfg = _cfgs("qwen3_8b")
    mesh = make_mesh(1, 2, devices=CARDS[:2])
    model, _ = init_placed_state(tcfg, RunConfig(model=tcfg, shape=ShapeConfig(**SHAPE), tp=2),
                                 ShardCtx(tp=2), mesh)
    with profile() as prof:
        value_and_grad(model, tcfg, _torch(_data(tcfg)), ShardCtx(tp=2), True, mesh)
    names = {e.key for e in prof.key_averages()}
    assert {"tp_broadcast", "tp_sum", "tp_gather", "fsdp_gather", "fsdp_grad_add"} <= names


# --------------------------------------------------------------- launcher --


def _quiet(fn, *args):
    with redirect_stdout(io.StringIO()):
        return fn(*args)


@pytest.mark.parametrize("arch", ["qwen3_8b", "granite_moe_3b_a800m"])
def test_launcher_tp_fsdp_on_cpu(arch):
    """``--dp 2 --tp 2 --fsdp --device cpu`` trains through ``train_loop``
    over the emulated mesh: finite, falling losses, each step equal to
    ``--dp 2 --tp 2`` (the slices held whole on each row) bit for bit."""
    base = ["--arch", arch, "--steps", "3", "--batch", "4", "--seq", "32", "--device", "cpu",
            "--dp", "2", "--tp", "2", "--remat", "full"]
    sliced = _quiet(ttrain.main, [*base, "--fsdp"])
    rows = _quiet(ttrain.main, base)
    assert sliced.steps == rows.steps == 3
    assert all(math.isfinite(x) for x in sliced.losses + sliced.grad_norms)
    assert sliced.losses[-1] < sliced.losses[0]
    assert sliced.losses == rows.losses and sliced.grad_norms == rows.grad_norms


def test_launcher_refuses_a_head_count_tp_does_not_divide(capsys):
    """``--tp 2`` on the full ``smollm_360m`` (15 q heads) is refused,
    naming the head count; the padded vocabulary and experts are printed."""
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--arch", "smollm_360m", "--full-config", "--tp", "2", "--device", "cpu"])
    assert exc.value.code == 2
    assert "2 does not divide the 15 q heads of smollm-360m" in capsys.readouterr().err
    assert ttrain.tp_fit(get_config("granite_moe_3b_a800m"), 4) == (
        None, ["the vocabulary of 49155 padded to 49184"])
    assert ttrain.tp_fit(get_config("granite_moe_3b_a800m"), 16)[1][1] == \
        "the 40 experts padded to 48"
