"""Fault-tolerant training loop.

* auto-resume from the newest complete checkpoint (atomic manager),
* periodic async checkpoints (the step does not wait for the disk),
* failure injection hook (tests kill the loop mid-run and restart it),
* per-step heartbeat with straggler detection: a step exceeding
  ``straggler_factor ×`` the rolling median is logged and counted,
* stateless data (``data.synth``): the step index alone resumes the stream.

A step's time runs until its loss is read back to the host, as the
reference's ``float(metrics["loss"])`` does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ckpt.manager import CheckpointManager
from ..configs.base import ModelConfig, RunConfig
from ..data.loader import to_device
from ..data.synth import SynthSpec, batch_at
from ..models.base import resolve_device
from .optimizer import AdamWConfig
from .trainstep import init_train_state, make_train_step


@dataclass
class LoopStats:
    steps: int = 0
    losses: List[float] = field(default_factory=list)
    grad_norms: List[float] = field(default_factory=list)  # not in the reference's stats
    step_times: List[float] = field(default_factory=list)
    stragglers: int = 0
    resumed_from: Optional[int] = None
    checkpoints: int = 0


def train_loop(
    cfg: ModelConfig,
    run: RunConfig,
    data: SynthSpec,
    total_steps: int,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    opt: Optional[AdamWConfig] = None,
    seed: int = 0,
    fail_at_step: Optional[int] = None,  # failure injection (tests)
    straggler_factor: float = 3.0,
    log_every: int = 10,
    log_fn: Callable[[str], None] = print,
    device=None,
) -> LoopStats:
    """Train ``cfg`` on ``device`` (the card unless asked) for
    ``total_steps`` steps, resuming from ``ckpt_dir`` if it holds a
    checkpoint; the final state is saved there on the way out."""
    dev = resolve_device(device)
    step_fn, ctx = make_train_step(cfg, run, opt=opt)

    stats = LoopStats()
    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None

    model, opt_state = init_train_state(cfg, run, ctx, seed=seed, device=dev)
    start_step = 0
    if manager is not None and manager.latest_step() is not None:
        start_step = manager.latest_step()
        # restored on the host and copied into the state in place: a second
        # copy on the device would not fit beside a state of half the card
        state = manager.restore(snapshot_of(model, opt_state), device="cpu")
        with torch.no_grad():
            _copy_tree(snapshot_of(model, opt_state), state)
        del state
        stats.resumed_from = start_step
        log_fn(f"[loop] resumed from step {start_step}")

    def snapshot():
        return snapshot_of(model, opt_state)

    try:
        for step in range(start_step, total_steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected node failure at step {step}")
            t0 = time.monotonic()
            batch = to_device(batch_at(data, step), dev)
            model, opt_state, metrics = step_fn(model, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            stats.steps += 1
            stats.losses.append(loss)
            stats.grad_norms.append(float(metrics["grad_norm"]))
            stats.step_times.append(dt)
            if len(stats.step_times) >= 8:
                med = float(np.median(stats.step_times[-32:]))
                if dt > straggler_factor * med:
                    stats.stragglers += 1
                    log_fn(f"[loop] straggler: step {step} took {dt:.3f}s (median {med:.3f}s)")
            if manager is not None and (step + 1) % ckpt_every == 0:
                manager.save_async(step + 1, snapshot())
                stats.checkpoints += 1
            if (step + 1) % log_every == 0:
                log_fn(f"[loop] step {step + 1}/{total_steps} loss {loss:.4f} "
                       f"({dt * 1e3:.0f} ms)")
    finally:
        if manager is not None:
            manager.wait()
            if stats.steps:
                manager.save(start_step + stats.steps, snapshot())
    return stats


def snapshot_of(model, opt_state):
    """The state a checkpoint holds: the parameters and the optimizer state."""
    return {"params": model.tree(), "opt": opt_state}


def _copy_tree(dst, src) -> None:
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_tree(v, src[k])
        else:
            v.copy_(src[k])
