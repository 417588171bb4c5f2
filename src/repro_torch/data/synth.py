"""Deterministic synthetic LM data: stateless per-step token generation.

Each (step, dp_rank) slice is generated independently (splitmix64 over the
global token index), so data loading survives restarts and elastic resharding
with zero state — the fault-tolerance property real pipelines get from
checkpointing their reader state, obtained here by construction.

The stream embeds learnable n-gram structure (token t+1 depends on t) so
training-loss curves actually bend — a pure-uniform stream cannot show
learning and would make the train examples meaningless.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


def _splitmix64(x: np.ndarray, salt: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(
            salt * 2_654_435_761 + 1
        )
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


@dataclass(frozen=True)
class SynthSpec:
    vocab: int
    seq_len: int
    batch: int  # local (per-process) batch
    n_codebooks: int = 1
    seed: int = 0
    structure: float = 0.7  # P(next token is a deterministic fn of current)


def batch_at(spec: SynthSpec, step: int, rank: int = 0) -> Dict[str, np.ndarray]:
    """The (step, rank) batch — pure function, any order, any time."""
    b, s, v = spec.batch, spec.seq_len, spec.vocab
    k = spec.n_codebooks
    base = (np.int64(step) * 1_000_003 + rank) * (b * k * (s + 1))
    idx = base + np.arange(b * k * (s + 1), dtype=np.int64)
    u = _splitmix64(idx, spec.seed).reshape(b, k, s + 1)
    rnd_tok = (u % np.uint64(v)).astype(np.int64)
    coin = (_splitmix64(idx, spec.seed ^ 0xABCDEF).reshape(b, k, s + 1)
            >> np.uint64(11)).astype(np.float64) / (1 << 53)
    seq = np.empty((b, k, s + 1), np.int64)
    seq[..., 0] = rnd_tok[..., 0]
    for t in range(1, s + 1):
        det = (seq[..., t - 1] * 31 + 7) % v  # learnable bigram rule
        seq[..., t] = np.where(coin[..., t] < spec.structure, det, rnd_tok[..., t])
    tokens = seq[..., :-1]
    labels = seq[..., 1:]
    if k == 1:
        tokens, labels = tokens[:, 0], labels[:, 0]
    return {"tokens": tokens.astype(np.int32), "labels": labels.astype(np.int32)}


def make_iterator(
    spec: SynthSpec, start_step: int = 0, rank: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(spec, step, rank)
        step += 1


def spec_for(cfg: ModelConfig, shape: ShapeConfig, local_batch: int,
             seed: int = 0) -> SynthSpec:
    return SynthSpec(
        vocab=cfg.vocab,
        seq_len=shape.seq_len,
        batch=local_batch,
        n_codebooks=cfg.n_codebooks,
        seed=seed,
    )


# -- multi-session interaction traces (multi-tenant serving) -------------------
#
# The traffic-replay corpus for `benchmarks/bench_serve.py` and the
# trace-determinism tests: N concurrent sessions, each issuing a Poisson
# process of interactions (exponential inter-arrival = the session's think
# times), with Zipf-popular query templates so cross-tenant dedup has honest
# hit structure (popular templates collide across sessions, parameterised
# variants don't).  Fully determined by the seed — same spec, same trace,
# byte for byte.


@dataclass(frozen=True)
class TraceEvent:
    """One interaction: ``session`` runs query ``(template, param)`` at
    virtual time ``at`` (seconds since replay start)."""

    at: float
    session: int
    template: int
    param: int  # 0 = the template's canonical form; >0 = parameterised variant


@dataclass(frozen=True)
class TraceSpec:
    n_sessions: int = 100
    n_events_per_session: int = 5
    mean_think_s: float = 10.0  # exponential inter-arrival mean (think time)
    n_templates: int = 8
    zipf_a: float = 1.5  # template popularity skew
    param_cardinality: int = 3  # distinct non-zero params per template
    param_frac: float = 0.25  # fraction of events using a non-zero param
    seed: int = 0


def poisson_trace(spec: TraceSpec) -> list[TraceEvent]:
    """Seeded multi-session Poisson interaction trace, globally time-ordered.

    Each session is an independent Poisson process started at its own
    exponential offset (sessions ramp up, they don't all fire at t=0).
    Ties in ``at`` are broken by session index so the total order — and hence
    any replay schedule derived from it — is deterministic."""
    rng = np.random.default_rng(spec.seed)
    events: list[TraceEvent] = []
    for s in range(spec.n_sessions):
        t = float(rng.exponential(spec.mean_think_s))
        for _ in range(spec.n_events_per_session):
            template = min(
                int(rng.zipf(spec.zipf_a)) - 1, spec.n_templates - 1
            )
            param = (
                int(rng.integers(1, spec.param_cardinality + 1))
                if float(rng.random()) < spec.param_frac
                else 0
            )
            events.append(
                TraceEvent(
                    at=round(t, 6), session=s, template=template, param=param
                )
            )
            t += float(rng.exponential(spec.mean_think_s))
    events.sort(key=lambda e: (e.at, e.session))
    return events
