"""The port's roofline (``repro_torch.launch.roofline``, ``probe``, ``dryrun``)
beside the JAX package's ``tests/test_roofline.py``.

* ``RooflineReport``'s terms at the H100 constants, its ``row()`` keys, and
  ``model_flops_for`` equal to the reference's for every config and shape;
* the kernels' work formulas: phase 5's attention bound pinned, and
  ``chip_smoke.py`` reading the package's copy;
* the counter against the reference's probes (XLA's cost analysis on a
  one-device CPU mesh) part by part, at a width where the products dominate;
* the split (outer + Σ n x group + accumulation + AdamW) equal to the whole
  step counted at once, in training, prefill and decode, for every config;
* counts on ``meta`` equal to counts on the CPU, and counting leaving the
  step's numbers unchanged; the kernels' charges as the card launches them;
* the collective reckoning against what the state-in-slices step moves over
  two distinct CPU devices; a tiny dry run and one full-size cell.

The reference's ``test_collective_parser_on_real_hlo``,
``test_cost_analysis_is_per_device`` and ``test_scan_bodies_counted_once``
test XLA's artefacts alone (HLO text, per-device cost analysis, a scan body
counted once) and have no counterpart: the port reads no HLO and counts
every loop iteration as it runs.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import get_config as r_config
from repro.configs import get_smoke_config as r_smoke
from repro.launch import roofline as r_roofline
from repro_torch.configs import ARCH_IDS, SHAPES, RunConfig, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, probe
from repro_torch.launch import roofline as rl
from repro_torch.launch.roofline import RooflineReport, model_flops_for
from repro_torch.models.base import SINGLE, ShardCtx


def _grown(arch):
    """The smoke config with a third pattern group and one extra layer."""
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, n_layers=cfg.n_layers + len(cfg.block_pattern) + 1)


def _run(cfg, kind, S=64, B=4, microbatch=None):
    return RunConfig(model=cfg, shape=ShapeConfig("x", kind, S, B), dp=1, tp=1, remat="full",
                     microbatch=microbatch)


# ------------------------------------------------------------------ report --


def test_roofline_report_terms():
    r = RooflineReport(
        arch="a", shape="train_4k", mesh="16x16", chips=256,
        flops_per_device=989e12,  # exactly 1 s on the tensor cores
        bytes_per_device=3.35e12,  # exactly 1 s of HBM3
        collective_bytes_per_device=50e9,  # 1 s of a 400 Gb/s port, beyond one host
        collective_by_kind={}, peak_memory_per_device=8 * 2**30,
        model_flops=989e12 * 256 * 0.5,
    )
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(1.0)
    assert r.useful_flops_fraction == pytest.approx(0.5)
    assert r.roofline_fraction == pytest.approx(0.5)
    one_host = dataclasses.replace(r, chips=4, collective_bytes_per_device=450e9)
    assert one_host.t_collective == pytest.approx(1.0)  # NVLink within one host
    assert set(r.row()) == set(r_roofline.RooflineReport(**{
        f.name: getattr(r, f.name) for f in dataclasses.fields(r)}).row())


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch, shape):
    assert model_flops_for(get_config(arch), SHAPES[shape]) == \
        r_roofline.model_flops_for(r_config(arch), SHAPES[shape])


def test_model_flops_decode_vs_train():
    cfg = get_config("qwen3_8b")
    n = cfg.param_count()
    assert model_flops_for(cfg, SHAPES["train_4k"]) == pytest.approx(6 * n * 4096 * 256)
    assert model_flops_for(cfg, SHAPES["decode_32k"]) == pytest.approx(2 * n * 128)


def test_kernel_bounds_pinned_and_shared_with_chip_smoke():
    """Phase 5's row 6: the forward at 4 x 15 (5) x 4,096 x 64, bf16, causal."""
    import chip_smoke

    work = rl.attention_work((4, 15, 5, 4096, 4096, 64, "bfloat16", True, None, 0))
    assert rl.bound(*work["flash_attention"], rl.PEAK_FLOPS) == (0.13031392938321537,
                                                                  "operations")
    for name in ("bound", "attention_work", "ssd_work", "scan_work", "recur_work",
                 "ssd_bwd_work", "ssd_bwd_total"):
        assert getattr(chip_smoke, name) is getattr(rl, name)
    assert chip_smoke.BF16_OPS_PER_S == 989e12 and chip_smoke.F32_OPS_PER_S == 67e12
    assert rl.visible_pairs(4, 4, True, None, 0) == 10
    assert rl.visible_pairs(4, 8, True, 2, 4) == 8


# ----------------------------------------------------- against the reference --
# XLA's cost analysis and the counter agree on the products (2 M N K each)
# and count elementwise work their own ways: XLA one flop an output element
# of each HLO op after fusion's rewrites, the counter one of each aten op.
# The test widens smoke qwen3_8b eight times (d_model 512, d_ff 1,024, vocab
# 1,024), where the products dominate, and adjusts for two known
# differences: the reference's attention (``attention_xla_chunked``)
# multiplies every (query, key) pair, masked or not (4 D a pair forward, 8 D
# backward), where the counter charges the kernels' visible pairs; and XLA
# drops the last product of the layer's forward from its gradient (the probe's
# stand-in loss needs no value), which eager PyTorch computes.  Limits: 3% a
# layer and for the outer part, 15% for AdamW, which is elementwise alone.
PART_TOL, OPT_TOL = 0.03, 0.15


@pytest.fixture(scope="module")
def wide_pair():
    r = r_smoke("qwen3_8b")
    kw = dict(d_model=r.d_model * 8, d_ff=r.d_ff * 8, vocab=r.vocab * 8)
    return dataclasses.replace(r, **kw), dataclasses.replace(get_smoke_config("qwen3_8b"), **kw)


def test_parts_against_reference_probes(wide_pair):
    from repro.configs import RunConfig as RRun
    from repro.launch import probe as r_probe
    from repro.launch.mesh import make_mesh
    from repro.models.base import ShardCtx as RCtx

    rcfg, cfg = wide_pair
    mesh = make_mesh(dp=1, tp=1)
    B, S = 2, 64
    pairs = B * cfg.n_q_heads * rl.visible_pairs(S, S, True, None, 0)
    every = B * cfg.n_q_heads * S * S
    D, T = cfg.head_dim, B * S
    for kind in ("prefill", "train"):
        ref = r_probe.probe_block(rcfg, "attn", RCtx(), mesh, B, S, kind, remat=False).flops
        got = probe.probe_block(cfg, "attn", SINGLE, None, B, S, kind, remat=False).flops
        if kind == "prefill":  # forward: S and P V, 4 D a pair
            ref += 4 * D * (pairs - every)
        else:  # XLA: 4 D forward + 8 D backward a pair; the kernels: 4 + 6 + 8 D a visible one
            ref += 18 * D * pairs - 12 * D * every
            got -= 2 * T * cfg.d_ff * cfg.d_model  # the last product, dropped by XLA
        assert got == pytest.approx(ref, rel=PART_TOL), kind
        rrun = RRun(model=rcfg, shape=ShapeConfig("x", kind, S, B), dp=1, tp=1, remat="none")
        ref = r_probe.probe_outer(rcfg, rrun, RCtx(), mesh, kind).flops
        got = probe.probe_outer(cfg, _run(cfg, kind, S, B), SINGLE, None, kind).flops
        assert got == pytest.approx(ref, rel=PART_TOL), kind
    rrun = RRun(model=rcfg, shape=ShapeConfig("x", "train", S, B), dp=1, tp=1)
    ref = r_probe.probe_optimizer(rcfg, rrun, RCtx(), mesh).flops
    got = probe.probe_optimizer(cfg, _run(cfg, "train", S, B), SINGLE, None).flops
    assert got == pytest.approx(ref, rel=OPT_TOL)
    assert r_probe.block_counts(rcfg) == probe.block_counts(cfg)


# ------------------------------------------------------ split against whole --

KINDS = [("train", None), ("train", 2), ("prefill", None), ("decode", None)]


@pytest.mark.parametrize("kind,microbatch", KINDS, ids=["train", "train_mb2", "prefill",
                                                        "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_split_equals_whole_step(arch, kind, microbatch):
    """outer + Σ n x group + the extra layers + accumulation (+ AdamW) equals
    the whole step counted at once, flops and bytes, exactly: three pattern
    groups and an extra layer, decode against a 128-slot cache."""
    cfg = _grown(arch)
    run = _run(cfg, kind, 128 if kind == "decode" else 64, microbatch=microbatch)
    whole = dryrun.whole_step_cost(cfg, run, SINGLE, kind)
    split, detail = probe.corrected_costs(cfg, run, SINGLE, None, kind)
    assert (split.flops, split.bytes) == (whole.flops, whole.bytes)
    assert whole.flops > 0 and detail["outer_flops"] > 0


# ------------------------------------------------------------ meta vs cpu --


def _counted_step(cfg, run, device):
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.train.trainstep import init_train_state, make_train_step

    if device == "meta":
        model = probe._meta_model(cfg, SINGLE, trainable=True)
        from repro_torch.train.optimizer import init_opt_state

        state = init_opt_state(model.tree())
        from repro_torch.launch.specs import train_input_specs

        batch = train_input_specs(cfg, run.shape, SINGLE)[0]
    else:
        model, state = init_train_state(cfg, run, seed=3, device=device)
        batch = to_device(batch_at(SynthSpec(vocab=cfg.vocab, seq_len=run.shape.seq_len,
                                             batch=run.shape.global_batch, seed=1), 0), device)
        if cfg.n_vis_tokens:
            batch["vis_embeds"] = torch.zeros((run.shape.global_batch, cfg.n_vis_tokens,
                                               cfg.d_model), dtype=torch.bfloat16)
        if cfg.n_codebooks > 1:
            batch = {k: v[:, None].expand(-1, cfg.n_codebooks, -1).contiguous()
                     for k, v in batch.items()}
    step, _ = make_train_step(cfg, run)
    with ops.local_backend("torch"), rl.count() as c:
        out = step(model, state, batch)
    return c, out


@pytest.mark.parametrize("arch", ["smollm_360m", "granite_moe_3b_a800m", "recurrentgemma_9b",
                                  "mamba2_2p7b", "internvl2_76b", "musicgen_large"])
def test_meta_counts_equal_cpu_counts(arch):
    cfg = _grown(arch)
    run = _run(cfg, "train", microbatch=2)
    meta, _ = _counted_step(cfg, run, "meta")
    cpu, _ = _counted_step(cfg, run, "cpu")
    assert (cpu.cost.flops, cpu.cost.bytes) == (meta.cost.flops, meta.cost.bytes)
    assert cpu.by_op == meta.by_op and cpu.charged == meta.charged
    assert cpu.cost.flops == dryrun.whole_step_cost(cfg, run, SINGLE, "train").flops


def test_charges_follow_the_card_launches():
    """A step charges each kernel as often as the card launches it: the
    attention forward twice a layer and microbatch under remat, each
    backward kernel once; the SSD's intra-chunk kernel and inter-chunk scan
    once a layer, or ssd_recur alone at one-token chunks."""
    cfg = _grown("qwen3_8b")
    c, _ = _counted_step(cfg, _run(cfg, "train", microbatch=2), "meta")
    n = cfg.n_layers * 2
    assert c.charged == {"flash_attention": 2 * n, "flash_attention_bwd_dq": n,
                         "flash_attention_bwd_dkdv": n}
    cfg = _grown("mamba2_2p7b")
    for S, want in ((64, {"ssd_chunk_scan": 1, "ssd_chunk_scan_inter": 1}),
                    (60, {"ssd_chunk_scan_recur": 1})):
        run = _run(cfg, "prefill", S, B=2)
        c = dryrun.whole_step_counter(cfg, run, SINGLE, "prefill")
        assert c.charged == {k: v * cfg.n_layers for k, v in want.items()}, S


def test_ssd_step_charges_the_backward_kernels():
    """A smoke Mamba-2 training step (remat full, two microbatches of 64
    tokens, chunk 32) counts the same on ``meta`` as on the CPU, and
    charges per layer and microbatch the intra-chunk kernel and the
    inter-chunk scan twice (the forward and its recompute) and each of the
    SSD's three backward kernels once, each at ``ssd_bwd_work``'s figure."""
    cfg = _grown("mamba2_2p7b")
    run = _run(cfg, "train", microbatch=2)
    meta, _ = _counted_step(cfg, run, "meta")
    cpu, _ = _counted_step(cfg, run, "cpu")
    assert (cpu.cost.flops, cpu.cost.bytes) == (meta.cost.flops, meta.cost.bytes)
    assert cpu.by_op == meta.by_op
    n = cfg.n_layers * 2
    bwd = ("ssd_chunk_scan_bwd_state", "ssd_chunk_scan_bwd_chunk", "ssd_chunk_scan_bwd_sum")
    assert cpu.charged == meta.charged == {"ssd_chunk_scan": 2 * n, "ssd_chunk_scan_inter": 2 * n,
                                           **{k: n for k in bwd}}
    di = cfg.ssd.expand * cfg.d_model
    work = rl.ssd_bwd_work(2, 64, di // cfg.ssd.head_dim, cfg.ssd.head_dim, cfg.ssd.d_state,
                           cfg.ssd.chunk, 2, False)
    for k in bwd:
        assert cpu.by_op[k] == [n, float(n * work[k][1]), float(n * work[k][0])]


def test_counting_leaves_the_step_unchanged():
    """The counted plain route (its backward recomputed uncounted) gives the
    step's numbers bit for bit."""
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.train.trainstep import init_train_state, make_train_step

    cfg = _grown("smollm_360m")
    run = _run(cfg, "train", microbatch=2)
    outs = []
    for counted in (False, True):
        model, state = init_train_state(cfg, run, seed=5, device="cpu")
        step, _ = make_train_step(cfg, run)
        batch = to_device(batch_at(SynthSpec(vocab=cfg.vocab, seq_len=64, batch=4, seed=2), 0),
                          "cpu")
        with ops.local_backend("torch"):
            if counted:
                with rl.count():
                    model, state, metrics = step(model, state, batch)
            else:
                model, state, metrics = step(model, state, batch)
        outs.append((model.tree(), state, metrics))
    (a, sa, ma), (b, sb, mb) = outs
    from repro_torch.models.base import tree_flatten

    for (_, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)):
        assert torch.equal(x, y)
    assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["grad_norm"], mb["grad_norm"])
    for (_, x), (_, y) in zip(tree_flatten(sa["mu"]), tree_flatten(sb["mu"])):
        assert torch.equal(x, y)


# ------------------------------------------------------------ collectives --


def test_fsdp_collectives_equal_what_the_step_moves(monkeypatch):
    """The state in slices over two distinct CPU devices (``cpu:0``,
    ``cpu:1``): the bytes the step's gathers, gradient adds and gradient
    norm move from one device to another, read off the port's transfer
    points (``Sliced.whole`` and the gather's backward) with each part on
    the device the mesh gave it, equal the reckoning's ``fsdp-gather``,
    ``fsdp-grad-add`` and ``grad-norm``.  A CPU tensor does not keep its
    ``cpu:i`` index, so a row's computing device is read off the row the
    step is in (``trainstep._row_value_and_grad``'s mesh), as a card's
    tensors would carry it."""
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import fsdp
    from repro_torch.train import trainstep
    from repro_torch.train.trainstep import init_placed_state, make_train_step

    moved = {"whole": 0, "add": 0}
    row_dev = {"now": None}
    whole, gather_bwd = fsdp.Sliced.whole, fsdp._Gather.backward
    row_step = trainstep._row_value_and_grad

    def part_bytes(leaf, layer):
        """Bytes of one part of ``leaf`` (of one layer of a stacked leaf)."""
        n = int(np.prod(leaf.shape[0 if layer is None else 1:])) * 4
        return n // (leaf.rows if leaf.dim is not None else 1) // (
            leaf.shards if leaf.tp_dim is not None else 1)

    def spy_row(model, cfg, batch, ctx, remat, mesh, use_ep):
        row_dev["now"] = mesh.first
        try:
            return row_step(model, cfg, batch, ctx, remat, mesh, use_ep)
        finally:
            row_dev["now"] = None

    def spy_whole(self, device, layer=None, shard=None, row=0):
        to = row_dev["now"] or torch.device(device)
        if self.dim is None and row_dev["now"] is not None:  # the row's own copy
            row = next(r for r, devs in enumerate(self.devices) if to in devs)
        rows = range(self.rows) if self.dim is not None else (row,)
        shards = range(self.shards) if shard is None else (shard,)
        moved["whole"] += sum(part_bytes(self, layer) for r in rows for s in shards
                              if self.devices[r][s] != to)
        return whole(self, device, layer, shard, row)

    def spy_backward(ctx, grad):
        leaf, layer, shard = ctx.leaf, ctx.layer, ctx.shard
        rows = range(leaf.grad.rows)
        shards = range(leaf.shards) if shard is None else (shard,)
        moved["add"] += sum(part_bytes(leaf, layer) for r in rows for s in shards
                            if leaf.grad.devices[r][s] != row_dev["now"])
        return gather_bwd(ctx, grad)

    monkeypatch.setattr(trainstep, "_row_value_and_grad", spy_row)
    monkeypatch.setattr(fsdp.Sliced, "whole", spy_whole)
    monkeypatch.setattr(fsdp._Gather, "backward", staticmethod(spy_backward))

    cfg = _grown("qwen3_8b")
    mesh = make_mesh(2, 1, devices=["cpu:0", "cpu:1"])
    run = RunConfig(model=cfg, shape=ShapeConfig("x", "train", 32, 4), dp=2, tp=1,
                    remat="full", microbatch=2)
    step, ctx = make_train_step(cfg, run, mesh=mesh)
    model, state = init_placed_state(cfg, run, ctx, mesh, seed=0)
    batch = to_device(batch_at(SynthSpec(vocab=cfg.vocab, seq_len=32, batch=4, seed=0), 0),
                      "cpu")
    step(model, state, batch)
    want = probe.collective_costs(cfg, run, ctx, "train")
    assert moved["whole"] == want["fsdp-gather"] + want["grad-norm"]
    assert moved["add"] == want["fsdp-grad-add"]
    assert want["whole-leaf-update"] > 0


def test_collective_kinds_by_cell():
    """Which transfers a cell makes: none on one card; the slices' in
    training over data rows, and over the model shards the tensor-parallel
    moves (smollm's 15 q heads keep its attention whole: the sequence
    slices join for it and are cut back), under sequence parallelism; EP
    and split-S at decode over model shards (none for the SSD, whose caches
    split nothing; its projections' moves instead); the logits gathered
    from each serving row."""
    prod = ShardCtx(tp=16, dp=16)
    dec = ShardCtx(tp=16, dp=1)
    cfg = get_config("smollm_360m")
    assert probe.collective_costs(cfg, _run(cfg, "train", 4096, 8, 4), SINGLE, "train") == {}
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], dp=16, tp=16)
    assert set(probe.collective_costs(cfg, run, prod, "train")) == {
        "fsdp-gather", "fsdp-grad-add", "grad-norm", "whole-leaf-update", "tp-broadcast",
        "tp-sum", "tp-join", "tp-scatter", "sp-gather", "sp-scatter"}
    granite = get_config("granite_moe_3b_a800m")
    run = RunConfig(model=granite, shape=SHAPES["decode_32k"], dp=16, tp=16)
    got = probe.collective_costs(granite, run, prod, "decode", ctx_params=dec)
    assert {"ep-dispatch", "ep-combine", "split-s", "logits-gather"} <= set(got)
    assert not {"sp-gather", "sp-scatter"} & set(got)  # a cache: no sequence slices
    mamba = get_config("mamba2_2p7b")
    run = RunConfig(model=mamba, shape=SHAPES["decode_32k"], dp=16, tp=16)
    assert set(probe.collective_costs(mamba, run, prod, "decode", ctx_params=dec)) == {
        "logits-gather", "tp-broadcast", "tp-sum", "tp-join", "tp-scatter"}


# ---------------------------------------------------------------- dry run --


def test_tiny_dryrun_on_meta():
    """Smoke qwen3_8b over a (2, 4) mesh of meta devices, batch 4 x 64:
    positive terms, the reference's row keys, nothing allocated."""
    cfg = get_smoke_config("qwen3_8b")
    shape = ShapeConfig("train_4k", "train", 64, 4)
    row = dryrun.dryrun_cell("qwen3_8b", "train_4k", cfg=cfg, shape=shape,
                             ctx=ShardCtx(tp=4, dp=2), verbose=False)
    assert row["mesh"] == "2x4" and row["chips"] == 8
    terms = (row["hlo_flops_per_dev"] / rl.PEAK_FLOPS, row["bytes_per_dev"] / rl.HBM_BW,
             sum(row["collectives"].values()) / row["chips"] / rl.collective_bw(8))
    assert min(terms) > 0, terms  # row() rounds each to a microsecond
    keys = {"arch", "shape", "mesh", "chips", "t_compute_s", "t_memory_s", "t_collective_s",
            "bottleneck", "model_flops", "hlo_flops_per_dev", "useful_flops_frac",
            "roofline_frac", "peak_mem_gb", "collectives", "raw_scan_flops_per_dev",
            "compile_s", "arg_gb", "temp_gb", "out_gb"}
    assert keys <= set(row)
    whole = dryrun.dryrun_cell("qwen3_8b", "train_4k", cfg=cfg, shape=shape, probe=False,
                               ctx=ShardCtx(tp=4, dp=2), verbose=False)
    assert whole["hlo_flops_per_dev"] == row["hlo_flops_per_dev"]


def test_dryrun_cli_full_cell(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch qwen3_8b --shape
    train_4k`` at full size on the (16, 16) mesh of meta devices."""
    out = tmp_path / "rows.jsonl"
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "qwen3_8b", "--shape", "train_4k", "--out", str(out)])
    assert exc.value.code == 0
    row = json.loads(out.read_text().splitlines()[0])
    assert row["chips"] == 256 and row["mesh"] == "16x16"
    assert row["model_flops"] == r_roofline.model_flops_for(r_config("qwen3_8b"),
                                                            SHAPES["train_4k"])
    assert 0 < row["useful_flops_frac"] < 1 and np.isfinite(row["t_memory_s"])
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == row
