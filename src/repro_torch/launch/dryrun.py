"""The dry run: every (arch x shape x mesh) cell counted on ``meta`` tensors,
one roofline row a cell.

Nothing is allocated on any device: the mesh is
``make_production_mesh(devices=["meta"] * chips)``, (16, 16), or (2, 16,
16) over two pods, and each cell's step is counted by ``launch.probe`` in
parts (``corrected_costs``: outer + Σ n x layer + accumulation + AdamW) or,
with ``--no-probe``, whole.  The per-device figures split the step's work
evenly over the mesh, as the reference's cost analysis of a step sharded by
GSPMD reads it; the port's single-controller model mesh (``launch/mesh.py``)
runs a data row's dense products on the row's first card, so for ``tp > 1``
it realises another split.  The collective term is reckoned from the port's
placements and transfer points (``probe.collective_costs``).  Decode cells
place the parameters over the model axis only unless ``--serve-fsdp``.

``peak_mem_gb`` and ``arg_gb`` are the state and inputs a device holds
under the placements (parameters, AdamW moments and the batch in training;
parameters, the cache and the token in serving); activations are not
reckoned (``temp_gb`` is null).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3_8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.jsonl]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Optional

import torch

from ..configs import RunConfig, all_cells, get_config, get_shape
from ..configs.base import ModelConfig, ShapeConfig
from ..kernels import ops as kops
from ..models.base import ShardCtx, tree_flatten
from ..models.lm import forward, model_spec
from ..train.optimizer import init_opt_state
from ..train.trainstep import make_train_step
from .mesh import make_production_mesh
from .probe import _meta_model, collective_costs, corrected_costs
from .roofline import Cost, Counting, analyze, count, model_flops_for
from .specs import cache_leaves, decode_input_specs, train_input_specs


def whole_step_counter(cfg: ModelConfig, run: RunConfig, ctx: ShardCtx, kind: str,
                       ctx_params: Optional[ShardCtx] = None) -> Counting:
    """The whole step counted on ``meta`` in one go (train: the train step
    with its microbatches and AdamW; prefill: the forward and the last
    logits; decode: one token against the cache), on int32 tokens as the
    data loader gives them; → the counter (``.cost``, ``.by_op``)."""
    ctx_params = ctx_params or ctx
    shape = run.shape
    model = _meta_model(cfg, ctx_params, trainable=kind == "train")
    if kind == "train":
        ins, _ = train_input_specs(cfg, shape, ctx)
        opt_state = init_opt_state(model.tree())
        step, _ = make_train_step(cfg, run)
        with kops.local_backend("torch"), count() as c:
            step(model, opt_state, ins)
        return c
    if kind == "prefill":
        ins, _ = train_input_specs(cfg, shape, ctx)
        with torch.no_grad(), kops.local_backend("torch"), count() as c:
            forward(model, cfg, ins["tokens"], ctx, vis_embeds=ins.get("vis_embeds"))[0][:, -1]
        return c
    ins, _ = decode_input_specs(cfg, shape, ctx)
    with torch.no_grad(), kops.local_backend("torch"), count() as c:
        forward(model, cfg, ins["tokens"], ctx, cache=ins["cache"],
                start_pos=ins["pos"])[0][:, -1]
    return c


def whole_step_cost(cfg: ModelConfig, run: RunConfig, ctx: ShardCtx, kind: str,
                    ctx_params: Optional[ShardCtx] = None) -> Cost:
    """:func:`whole_step_counter`'s cost."""
    return whole_step_counter(cfg, run, ctx, kind, ctx_params).cost


def _spread(shape, placement, mesh_axes) -> int:
    """Over how many mesh positions a leaf of ``placement`` is split."""
    n = 1
    for ax in placement:
        for name in (ax if isinstance(ax, tuple) else (ax,)):
            if name is not None:
                n *= mesh_axes[name]
    return n


def state_bytes(cfg: ModelConfig, shape: ShapeConfig, ctx: ShardCtx, ctx_params: ShardCtx,
                kind: str, mesh_axes) -> float:
    """Bytes of state and inputs one device holds under the placements."""
    from ..models.layers import compute_dtype

    total = 0.0
    for _, spec in tree_flatten(model_spec(cfg, ctx_params)):
        n = int(torch.Size(spec.shape).numel()) / _spread(spec.shape, spec.placement, mesh_axes)
        if kind == "train":
            total += 3 * 4 * n  # float32 weights and two moments
        else:
            total += n * torch.empty((), dtype=spec.dtype(compute_dtype(cfg))).element_size()
    if kind == "decode":
        ins, placed = decode_input_specs(cfg, shape, ctx)
        leaves = dict(cache_leaves(placed["cache"]))
        for path, t in cache_leaves(ins["cache"]):
            total += t.numel() * t.element_size() / _spread(t.shape, leaves[path], mesh_axes)
    else:
        ins, placed = train_input_specs(cfg, shape, ctx)
        for k, t in ins.items():
            total += t.numel() * t.element_size() / _spread(t.shape, placed[k], mesh_axes)
    return total


def dryrun_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    verbose: bool = True,
    remat: str = "full",
    probe: bool = True,
    microbatch: int = 0,          # grad-accumulation microbatch
    capacity_factor: float = 0.0,  # MoE capacity override
    serve_fsdp: bool = False,      # keep the data-axis placements for decode
    tag: str = "",
    cfg: Optional[ModelConfig] = None,
    shape: Optional[ShapeConfig] = None,
    ctx: Optional[ShardCtx] = None,
):
    """One cell's roofline row.  ``cfg`` / ``shape`` / ``ctx`` override the
    registry's config, the named shape and the production mesh's context
    (a smaller mesh of ``ctx``'s shape is made on ``meta``)."""
    cfg = cfg or get_config(arch)
    if capacity_factor and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    shape = shape or get_shape(shape_name)
    pods = 2 if multi_pod else 1
    if ctx is None:
        ctx = ShardCtx(tp=16, dp=16, pods=pods,
                       data_axes=("pod", "data") if multi_pod else ("data",))
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    devices=["meta"] * (pods * 16 * 16))
    else:
        from .mesh import make_mesh

        mesh = make_mesh(ctx.dp, ctx.tp, ctx.pods,
                         devices=["meta"] * (ctx.dp_total * ctx.tp))
    chips = len(mesh.devices)
    mesh_name = "x".join(str(s) for s in mesh.shape)
    run = RunConfig(model=cfg, shape=shape, dp=ctx.dp, tp=ctx.tp, pods=ctx.pods, remat=remat,
                    microbatch=microbatch or None)
    # Serving steps hold no optimizer state: parameters sliced over the data
    # axes would be gathered for every decoded token, so decode cells place
    # them over the model axis only (replicated across the data rows).
    ctx_params = ctx
    if shape.kind == "decode" and not serve_fsdp:
        ctx_params = ShardCtx(tp=ctx.tp, dp=1, pods=1, data_axes=ctx.data_axes)

    t0 = time.time()
    if probe:
        total, detail = corrected_costs(cfg, run, ctx, mesh, shape.kind, ctx_params=ctx_params)
    else:
        total, detail = whole_step_cost(cfg, run, ctx, shape.kind, ctx_params), {}
    dt = time.time() - t0
    total.coll = collective_costs(cfg, run, ctx, shape.kind, ctx_params=ctx_params)
    axes = dict(zip(mesh.axis_names, mesh.shape))
    arg = state_bytes(cfg, shape, ctx, ctx_params, shape.kind, axes)
    report = analyze(arch, shape_name, mesh_name, chips, total, model_flops_for(cfg, shape),
                     peak_memory=arg)
    row = report.row()
    if tag:
        row["tag"] = tag
    row["raw_scan_flops_per_dev"] = report.flops_per_device  # no scan under-count here
    row["bytes_per_dev"] = report.bytes_per_device
    row["compile_s"] = round(dt, 1)  # seconds spent counting
    row["arg_gb"] = round(arg / 2**30, 3)
    row["temp_gb"] = None
    row["out_gb"] = None
    row["detail"] = detail
    if verbose:
        print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="full", choices=["full", "none"])
    ap.add_argument("--no-probe", action="store_true",
                    help="count the whole step in one go instead of in parts")
    ap.add_argument("--out", default=None)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--serve-fsdp", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--worker", default=None,
                    help="i/n: run cell subset i of n (parallel sweeps)")
    args = ap.parse_args(argv)

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    if args.worker:
        i, n = (int(x) for x in args.worker.split("/"))
        cells = [c for j, c in enumerate(cells) if j % n == i]
    out_f = open(args.out, "a") if args.out else None
    failures = 0
    for arch, shape in cells:
        try:
            row = dryrun_cell(
                arch, shape, multi_pod=args.multi_pod, probe=not args.no_probe,
                microbatch=args.microbatch, capacity_factor=args.capacity_factor,
                serve_fsdp=args.serve_fsdp, remat=args.remat, tag=args.tag,
            )
            if out_f:
                out_f.write(json.dumps(row) + "\n")
                out_f.flush()
        except Exception:
            failures += 1
            print(f"FAILED {arch} {shape}", file=sys.stderr)
            traceback.print_exc()
    if out_f:
        out_f.close()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
