"""The training cells: the port's train step
(``repro_torch.train.trainstep.make_train_step``, the step that
``train_loop`` drives) over a model made from the benchmark's weights.

``train_loop`` makes its own weights and data from its own seed, which the
reference may not take, so the harness drives the step it builds the way
the loop does each step: the batch (made on the device), the step, the
loss and the gradient norm read back to the host.  The loop's host batch
and its copy to the device, and its straggler bookkeeping, are not timed.  Set-up
builds the one state, runs its first three steps (the first builds and
warms every kernel) and keeps what the comparison needs: each step's loss,
the first gradient's per-leaf norm as AdamW got it (from its first moment),
and each leaf's change after the three.  The window runs further steps of
that state on fresh rows until ``--seconds`` have passed.  After it the
state is freed and the plain reference (``harness/mamba_ref.py``) runs the
same three steps from the same weights and rows.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict

import torch

from harness import arith, clock, lm, mamba_ref
from harness.cli import Outcome
from harness.trace import Recorder

CHECK_STEPS = 3
CONTROL = "fp8"  # the precision below the configuration's bfloat16


def batch(seed: int, index: int, seq: int, vocab: int, device):
    t = lm.tokens(seed, index, seq + 1, vocab, device)
    return {"tokens": t[None, :-1].to(torch.int32), "labels": t[None, 1:].to(torch.int32)}


def start(cell, seed: int, device: str):
    """The one training state, built from the seed's weights and driven
    through its first ``CHECK_STEPS`` steps by the window's own call and
    feed → (the step of row i, the readings the comparison needs:
    (losses, |g| of step 1 by leaf as AdamW got it, |p3 - p0| by leaf))."""
    from repro_torch.configs import RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import AdamWConfig
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainstep import make_train_step

    m, t = cell.config["model"], cell.traffic
    seq, vocab = int(t["seq_len"]), int(m["vocab_size"])
    cfg = lm.port_config(m)
    run_cfg = RunConfig(model=cfg, shape=ShapeConfig("bench", "train", seq_len=seq,
                                                     global_batch=1),
                        dp=1, tp=1, remat=t["remat"])
    opt = AdamWConfig(**t["optimizer"])
    step_fn, _ = make_train_step(cfg, run_cfg, opt=opt)
    state = {"model": lm.port_model(m, mamba_ref.make_weights(m, seed, device),
                                    trainable=True)}
    state["opt"] = init_opt_state(state["model"].tree())

    def one_step(i):
        b = batch(seed, i, seq, vocab, device)
        state["model"], state["opt"], met = step_fn(state["model"], state["opt"], b)
        float(met["grad_norm"])
        return float(met["loss"])

    losses, g1 = [], {}
    for i in range(CHECK_STEPS):
        losses.append(one_step(i))
        if i == 0:  # the gradient AdamW got, from its first moment
            g1 = {p: float(mu.norm()) / (1 - opt.b1)
                  for p, mu in lm.flat_paths(state["opt"]["mu"])}
    params = dict(lm.flat_paths(state["model"].tree()))
    with torch.no_grad():
        change = {spec[0]: float((params[spec[0]].float()
                                  - mamba_ref.make_leaf(spec, k, seed, device)).norm())
                  for k, spec in enumerate(mamba_ref.leaf_specs(mamba_ref.dims(m)))}
    return one_step, (losses, g1, change)


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        precision: str = "float32") -> Outcome:
    t = cell.traffic
    seq = int(t["seq_len"])
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    one_step, got = start(cell, seed, device)

    rec = Recorder(trace, float(t["trace_seconds"]))
    i = CHECK_STEPS
    t0 = rec.start_window()
    setup_s = t0 - clock.process_start()
    while time.perf_counter() - t0 < seconds:
        with rec.span("step", tokens=seq):
            one_step(i)
        i += 1
    rec.end_window()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    del one_step
    _free(device)

    t_check = time.perf_counter()
    checks = compare(cell.config, got, reference(cell, seed, device, precision))
    return Outcome(setup_s=setup_s, rec=rec, attempted=i - CHECK_STEPS, failed=0,
                   checks=checks, memory_peak_bytes=peak, config=cell.config, traffic=t,
                   data={"params": arith.mamba2_params(cell.config["model"]), "seq": seq,
                         "check_s": time.perf_counter() - t_check})


def _free(device: str) -> None:
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


def reference(cell, seed: int, device, precision: str = "float32", tokens=None):
    """The plain reference's three steps from the seed's weights on the
    window's first rows; ``tokens`` keeps that many of each row's tokens
    (the fault of a batch half left out)."""
    m, t = cell.config["model"], cell.traffic
    seq, vocab = int(t["seq_len"]), int(m["vocab_size"])
    rows = [batch(seed, i, seq, vocab, device) for i in range(CHECK_STEPS)]
    keep = seq if tokens is None else tokens
    opt = dict(t["optimizer"])
    return mamba_ref.train_readings(
        m, seed, [(b["tokens"][0, :keep], b["labels"][0, :keep]) for b in rows], opt, device,
        precision)


def control(cell, seed: int, device: str = "cuda", faults: bool = True
            ) -> Dict[str, Dict[str, tuple]]:
    """The program's readings (its first steps, no window), then those of
    the control (the reference at float8 in the program's place) and of a
    fault (half of each row's tokens left out, the mean taken over the
    rest), each against the float32 reference.  A step that returns its
    state unchanged reads 1 in ``change_gap`` by definition and needs no
    run."""
    one_step, got = start(cell, seed, device)
    del one_step
    _free(device)
    truth = reference(cell, seed, device)
    out = {"program": compare(cell.config, got, truth)}
    if not faults:
        return out
    out[CONTROL] = compare(cell.config, reference(cell, seed, device, CONTROL), truth)
    half = int(cell.traffic["seq_len"]) // 2
    out["half_batch"] = compare(cell.config, reference(cell, seed, device, tokens=half), truth)
    return out


def compare(config, got, want):
    """The numbers compared, each against its limit: the loss by the widest
    relative gap over the three steps and at the first; the first gradient
    and the change after three steps by leaf (``lm.leaf_gaps``), the worst
    leaf and the median leaf.  Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left out
    of the change."""
    (lp, gp, cp), (lr, gr, cr) = got, want
    lim = config["limits"]
    med = statistics.median(gr.values())
    still = {k for k, v in gr.items() if v < 1e-3 * med}
    loss = [abs(a - b) / abs(b) for a, b in zip(lp, lr)]
    grad, change = lm.leaf_gaps(gp, gr), lm.leaf_gaps(cp, cr, skip=still)
    readings = {"loss_gap": max(loss), "loss_gap_first": loss[0],
                "grad_gap": max(grad), "grad_gap_median": statistics.median(grad),
                "change_gap": max(change), "change_gap_median": statistics.median(change)}
    return {k: (v, float(lim[k])) for k, v in readings.items() if k in lim}
