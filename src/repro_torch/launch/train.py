"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The reference launcher's flags and defaults, plus ``--device``: the run is
on the CUDA card unless ``--device cpu`` asks for the CPU.  It trains the
smoke-scale variant of the architecture, or the full config with
``--full-config``, through ``train_loop`` (real steps, checkpoints,
resume).  ``--dp × --tp × --pods > 1`` trains over a model mesh
(``launch.mesh.make_mesh``): over the host's first cards, or, with
``--device cpu``, over that many emulated shards on the CPU; a host with
too few cards is refused, naming both counts.

``--fsdp`` (with ``--dp × --pods > 1``) stores the train state in slices
over the mesh's data rows, as the reference's placements say: the port's
counterpart of the input shardings the reference's dry run compiles the
train step with (``launch/dryrun.py``).  Each row then holds its slice of
the float32 weights and AdamW moments and gathers a layer's weights as it
runs it; the run's numbers are those of the replicated run bit for bit.
Without it the state is replicated on each row.

``main(argv)`` returns the loop's ``LoopStats``, so a caller can drive it
in-process.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import RunConfig, get_config, get_smoke_config
from ..configs.base import ShapeConfig
from ..data import SynthSpec
from ..train import AdamWConfig, LoopStats, train_loop
from .mesh import make_mesh


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (not smoke) architecture config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--fsdp", action="store_true",
                    help="store the train state in slices over the data rows "
                         "(needs --dp x --pods > 1)")
    ap.add_argument("--remat", default="none", choices=["none", "full"])
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="failure injection (fault-tolerance demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the CUDA card)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> LoopStats:
    ap = parser()
    args = ap.parse_args(argv)
    devices = args.dp * args.tp * args.pods
    if args.fsdp and args.dp * args.pods < 2:
        ap.error(f"--fsdp slices the state over the data rows: it needs --dp x --pods > 1, "
                 f"not --dp {args.dp} --pods {args.pods}")
    mesh = None
    if devices > 1:
        on_cpu = torch.device(args.device).type == "cpu"
        try:
            mesh = make_mesh(args.dp, args.tp, args.pods,
                             devices=[args.device] * devices if on_cpu else None)
        except RuntimeError as exc:
            ap.error(f"--dp {args.dp} --tp {args.tp} --pods {args.pods}: {exc}")

    cfg = get_config(args.arch) if args.full_config else get_smoke_config(args.arch)
    shape = ShapeConfig("cli", "train", seq_len=args.seq, global_batch=args.batch)
    run = RunConfig(
        model=cfg, shape=shape, dp=args.dp, tp=args.tp, pods=args.pods,
        remat=args.remat, microbatch=args.microbatch or None,
        grad_compression=args.grad_compression,
    )
    data = SynthSpec(
        vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
        n_codebooks=cfg.n_codebooks, seed=args.seed,
    )
    opt = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                      total_steps=args.steps)
    stats = train_loop(
        cfg, run, data, total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, opt=opt, seed=args.seed,
        fail_at_step=args.fail_at_step, log_every=max(1, args.steps // 10),
        device=args.device, mesh=mesh, fsdp=args.fsdp,
    )
    print(
        f"steps={stats.steps} loss {np.mean(stats.losses[:5]):.4f} -> "
        f"{np.mean(stats.losses[-5:]):.4f} stragglers={stats.stragglers} "
        f"ckpts={stats.checkpoints}"
    )
    return stats


if __name__ == "__main__":
    main()
