"""The serving cells: a notebook assistant served through the
port's ``OpportunisticServer`` (``repro_torch.serve.session``), which runs
on the same engine as the notebook's ``Session``.

Each turn registers the mix's anticipated prompts (``anticipate``), thinks
(``think``, simulated seconds: the engine may prefill an anticipated prompt
then), and sends one request (``request``): one of the anticipated prompts
or a new one, for greedy tokens.  A request is timed from the call to its
tokens on the host.

The work is fixed by the mix: turns come in cycles whose request lengths,
anticipated lengths and think times are the same quantiles of the mix's
distributions in every cycle, in an order drawn from the mix's
``stream_seed``, with the same number of requests on an anticipated prompt.
Weights and token ids come from the run's seed.  After the window every
request the window served is held against the plain reference's logits
(``harness/mamba_ref.py``).
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, Iterator, List

import numpy as np
import torch

from harness import arith, clock, lm, mamba_ref
from harness.cli import Outcome
from harness.trace import Recorder


CONTROL = "fp8"  # the precision below the configuration's bfloat16


def _loguniform_quantiles(lo: int, hi: int, n: int) -> List[int]:
    return [int(round(math.exp(math.log(lo) + (j + 0.5) / n * (math.log(hi) - math.log(lo)))))
            for j in range(n)]


def _lognormal_quantiles(median: float, p75: float, n: int) -> List[float]:
    from statistics import NormalDist

    sigma = (math.log(p75) - math.log(median)) / NormalDist().inv_cdf(0.75)
    return [math.exp(math.log(median) + sigma * NormalDist().inv_cdf((j + 0.5) / n))
            for j in range(n)]


def turns(traffic: Dict) -> Iterator[Dict]:
    """Turns, cycle after cycle: each {"anticipated": [lengths], "request":
    index into anticipated or None, "length": the request's length,
    "think": simulated seconds}.  The order is the mix's own, drawn from its
    ``stream_seed``: a run's seed draws the weights and the token ids."""
    n = int(traffic["turns_per_cycle"])
    k = int(traffic["anticipated_per_turn"])
    lo, hi = traffic["prompt_len"]
    req_len = _loguniform_quantiles(lo, hi, n)
    other_len = _loguniform_quantiles(lo, hi, n * k)
    thinks = _lognormal_quantiles(*traffic["think_prior_s"], n)
    n_hit = int(round(traffic["p_anticipated"] * n))
    rng = np.random.default_rng(int(traffic["stream_seed"]))
    while True:
        rl = rng.permutation(req_len)
        ol = list(rng.permutation(other_len))
        th = rng.permutation(thinks)
        hits = set(rng.permutation(n)[:n_hit].tolist())
        for j in range(n):
            ant = [int(ol.pop()) for _ in range(k)]
            which = None
            if j in hits:
                which = int(rng.integers(0, k))
                ant[which] = int(rl[j])
            yield {"anticipated": ant, "request": which, "length": int(rl[j]),
                   "think": float(th[j])}


def _warm(server, vocab: int, device, lengths: List[int]) -> None:
    """Prefill and decode once at each length class the window's prompts
    take (a multiple of the chunk, and any other length), so every kernel
    is built and loaded before the window."""
    for i, n in enumerate(lengths):
        prompt = lm.tokens(987_654_321, i, n, vocab, device).cpu().numpy()
        server.request(prompt, n_tokens=2)
    if device != "cpu":
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        precision: str = "float32") -> Outcome:
    from repro_torch.core.engine import Engine
    from repro_torch.serve.session import OpportunisticServer

    m, t = cell.config["model"], cell.traffic
    vocab, n_tok = int(m["vocab_size"]), int(t["n_tokens"])
    dm = mamba_ref.dims(m)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    model = lm.port_model(m, mamba_ref.make_weights(
        m, seed, device, serve_dtype=torch.bfloat16 if m["dtype"] == "bfloat16" else None),
        trainable=False)

    def new_server():
        return OpportunisticServer(lm.port_config(m), model,
                                   engine=Engine(mode="sim", budget_bytes=int(t["budget_bytes"])),
                                   device=device)

    _warm(new_server(), vocab, device, [dm.chunk * 2, dm.chunk * 2 + 1])
    server = new_server()
    cache = server.engine.cache
    rec = Recorder(trace, float(t["trace_seconds"]))
    served: List[Dict] = []
    failed = 0
    stream = turns(t)
    t0 = rec.start_window()
    setup_s = t0 - clock.process_start()
    i = 0
    while time.perf_counter() - t0 < seconds:
        turn = next(stream)
        prompts = [lm.tokens(seed, 3 * i + j, n, vocab, device).cpu().numpy()
                   for j, n in enumerate(turn["anticipated"])]
        nodes = [server.anticipate(p) for p in prompts]
        with rec.span("think", sim_s=turn["think"]) as sp:
            before = [nd.nid in cache for nd in nodes]
            server.think(turn["think"])
            if device != "cpu":
                torch.cuda.synchronize()
            sp.attrs["prefilled_lengths"] = [len(p) for p, b, nd in zip(prompts, before, nodes)
                                             if not b and nd.nid in cache]
            sp.attrs["prefilled"] = sum(sp.attrs["prefilled_lengths"])
        if turn["request"] is not None:
            prompt = prompts[turn["request"]]
        else:
            prompt = lm.tokens(seed, 3 * i + 2, turn["length"], vocab, device).cpu().numpy()
        hit = server.anticipate(prompt).nid in cache
        with rec.span("request", hit=hit, length=len(prompt), n_tokens=n_tok):
            try:
                out = server.request(prompt, n_tokens=n_tok).tokens
            except Exception as exc:  # counted against the attempts
                failed += 1
                out = exc
        served.append({"prompt": prompt, "tokens": out})
        i += 1
    rec.end_window()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    del server, model
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks = check(cell, served, seed, device, precision)
    return Outcome(setup_s=setup_s, rec=rec, attempted=len(served), failed=failed,
                   checks=checks, memory_peak_bytes=peak, config=cell.config, traffic=t,
                   data={"params": arith.mamba2_params(m), "n_tokens": n_tok,
                         "check_s": time.perf_counter() - t_check})


def token_gaps(m: Dict, weights, prompt: np.ndarray, served: np.ndarray, device,
               precision: str = "float32") -> List[float]:
    """For each served token, how far its reference logit lies below the
    reference's best at its position.  ``precision`` other than float32 is
    the control: the gap of the token that precision puts first instead."""
    dm = mamba_ref.dims(m)
    seq = torch.as_tensor(np.concatenate([prompt, served[:-1]]), device=device)
    pos = list(range(len(prompt) - 1, len(seq)))
    ref = mamba_ref.logits_at(weights, seq, pos, dm, "float32")
    if precision == "float32":
        chosen = torch.as_tensor(served.astype(np.int64), device=device)
    else:
        chosen = mamba_ref.logits_at(weights, seq, pos, dm, precision).argmax(-1)
    best = ref.max(-1).values
    return (best - ref.gather(-1, chosen[:, None])[:, 0]).tolist()


def check(cell, served: List[Dict], seed: int, device, precision: str = "float32"):
    m = cell.config["model"]
    weights = mamba_ref.make_weights(m, seed, device)
    gap, bad = 0.0, 0
    for s in served:
        if isinstance(s["tokens"], Exception):
            bad += 1
            continue
        gap = max(gap, max(token_gaps(m, weights, s["prompt"], np.asarray(s["tokens"]),
                                      device, precision)))
    return {"failed_checked": (float(bad), 0.0),
            "token_gap": (gap, float(cell.config["limits"]["token_gap"]))}


def control(cell, seed: int, device: str = "cuda", faults: bool = True
            ) -> Dict[str, Dict[str, tuple]]:
    """The control's readings: a short window at the cell's own load, each
    request judged by the token that the reference at float8 puts first at
    each served position (the mix's ``control_seconds``)."""
    out = run(cell, seed, float(cell.traffic["control_seconds"]), trace=False, device=device,
              precision=CONTROL)
    return {CONTROL: out.checks}
