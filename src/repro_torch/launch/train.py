"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The reference launcher's flags and defaults, plus ``--device``: the run is
on the CUDA card unless ``--device cpu`` asks for the CPU.  It trains the
smoke-scale variant of the architecture, or the full config with
``--full-config``, through ``train_loop`` (real steps, checkpoints,
resume).  ``--dp × --tp × --pods > 1`` trains over a model mesh
(``launch.mesh.make_mesh``): over the host's first cards, or, with
``--device cpu``, over that many emulated shards on the CPU; a host with
too few cards is refused, naming both counts.

``--tp n > 1`` trains tensor parallel (Megatron's placements, as the
reference's): each row's shard ``s`` holds slice ``s`` of every leaf whose
placement names the model axis, the blocks compute on the slices where they
lie, and an MoE runs expert-parallel over the same shards.  A q-head count
``n`` does not divide is refused, naming it; the vocabulary and the experts
are padded (``tp_fit``).  ``--fsdp`` (with ``--dp × --pods > 1``) stores
the train state in slices over the mesh's data rows too, as the reference's
placements say: the port's counterpart of the input shardings the
reference's dry run compiles the train step with (``launch/dryrun.py``), and
with ``--tp`` its TP × FSDP.  Each row then holds its slice of the float32
weights and AdamW moments and gathers a layer's weights as it runs it; the
run's numbers are those of the run held whole on each row bit for bit.
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


def tp_fit(cfg, tp: int):
    """(why ``tp`` model shards cannot train ``cfg`` tensor parallel, or
    None; what they pad).  Refused: a q-head count ``tp`` does not divide,
    whose attention could not be sliced (``attn_tp_eligible``).  Padded, as
    the reference pads them: a vocabulary to a multiple of ``8·tp``
    (``padded_vocab``), an expert count to a multiple of ``tp``."""
    refused = None
    if any(b in ("attn", "local_attn") for b in cfg.block_pattern) \
            and not cfg.attn_tp_eligible(tp):
        refused = (f"{tp} does not divide the {cfg.n_q_heads} q heads of {cfg.name}: its "
                   f"attention cannot be sliced over the model shards")
    padded = []
    if cfg.padded_vocab(tp) != cfg.vocab:
        padded.append(f"the vocabulary of {cfg.vocab} padded to {cfg.padded_vocab(tp)}")
    if cfg.moe is not None and cfg.moe.padded_experts(tp) != cfg.moe.n_experts:
        padded.append(f"the {cfg.moe.n_experts} experts padded to "
                      f"{cfg.moe.padded_experts(tp)}")
    return refused, padded


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
    if args.tp > 1:
        refused, padded = tp_fit(cfg, args.tp)
        if refused:
            ap.error(f"--tp {args.tp}: {refused}")
        for note in padded:
            print(f"--tp {args.tp}: {note}")
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
