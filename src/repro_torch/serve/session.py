"""Opportunistic serving sessions — the paper's technique as a first-class
feature of the ML-serving layer (DESIGN.md §2.3, §Arch-applicability).

Mapping of the paper's concepts onto interactive LLM serving:

| paper                     | serving                                        |
|---------------------------|------------------------------------------------|
| interaction               | a user request (prefill + N decode steps)      |
| think time                | the gap between user requests                  |
| non-critical operators    | anticipated prompts' prefills, batch jobs      |
| partition (preempt quantum)| one prefill chunk / one decode step           |
| materialised-result cache | prefix KV caches (Eq 2/3 eviction!)            |
| CSE / idempotence         | identical prompt → same prefill node           |
| speculative materialisation| warming caches for *predicted* next prompts   |

A request whose prompt was speculatively prefilled during think time starts
decoding immediately — the serving analogue of Figure 1(b).

A prompt is a sequence of token ids, or for a multi-codebook config
(``cfg.n_codebooks`` K > 1) K such sequences of one length, as
``greedy_generate`` takes them; its tokens come back (K, n).  The
reference's server takes the first form only (ROADMAP C15).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.dag import Node
from ..core.engine import Engine
from ..core.executor import OpRuntime, Unit
from ..models.base import ShardCtx, resolve_device
from ..models.lm import cache_tensors
from .engine import make_serve_fns


@dataclass
class GenResult:
    tokens: np.ndarray

    @property
    def nbytes(self) -> int:
        return int(self.tokens.nbytes)


class CacheResult:
    """A prefix cache (the last logits and every layer's state) as a
    cacheable value (Eq 2/3 sees its true size)."""

    def __init__(self, logits, cache, prompt_len: int):
        self.logits = logits
        self.cache = cache
        self.prompt_len = prompt_len

    @property
    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in [self.logits, *cache_tensors(self.cache)]))


def _literal(prompt) -> tuple:
    """A prompt as a hashable literal: its token ids, or a tuple of each
    codebook's (a prompt of K sequences)."""
    if np.ndim(prompt) == 2:
        return tuple(tuple(int(t) for t in row) for row in prompt)
    return tuple(int(t) for t in prompt)


class OpportunisticServer:
    """Single-model interactive server scheduled by the core engine.  It runs
    on ``device`` (the card unless asked), where ``params`` must lie."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        engine: Optional[Engine] = None,
        capacity: int = 256,
        prefill_chunk: int = 32,
        step_cost_s: float = 0.05,   # simulated per-decode-step latency
        prefill_cost_s: float = 0.02,  # simulated per-chunk latency
        device=None,
    ):
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params lie on {params.device}, the server runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.engine = engine or Engine(mode="sim", budget_bytes=1 << 30)
        self.ctx = ShardCtx()
        self.prefill_chunk = prefill_chunk
        self.step_cost_s = step_cost_s
        self.prefill_cost_s = prefill_cost_s
        self.capacity = capacity
        self._prefill, self._decode, self._new_cache = make_serve_fns(
            cfg, self.ctx, capacity=capacity
        )
        self._tenant_demand: Dict[str, set] = {}
        self._register_ops()

    # ------------------------------------------------------------- op defs --
    def _register_ops(self) -> None:
        eng = self.engine

        def prefill_units(node: Node, inputs) -> List[Unit]:
            prompt = np.asarray(node.literals[0], np.int32)
            chunks = range(0, prompt.shape[-1], self.prefill_chunk)

            def chunk_fn(a):
                def run():
                    return ("chunk", a)  # chunk markers; compute in combine
                return run

            # chunked prefill: each chunk is a preemption quantum
            return [
                Unit(fn=chunk_fn(a), cost_s=self.prefill_cost_s,
                     tag=f"prefill[{a}]")
                for a in chunks
            ]

        def prefill_combine(node: Node, inputs, results):
            prompt = torch.tensor(node.literals[0], dtype=torch.int64,
                                  device=self.device)[None]
            logits, cache = self._prefill(self.params, prompt)
            return CacheResult(logits, cache, prompt.shape[-1])

        eng.register_op(
            "prefill", OpRuntime(units=prefill_units, combine=prefill_combine)
        )

        def gen_units(node: Node, inputs) -> List[Unit]:
            n = int(node.literals[0])
            return [
                Unit(fn=lambda: None, cost_s=self.step_cost_s, tag=f"dec[{t}]")
                for t in range(n)
            ]

        def gen_combine(node: Node, inputs, results):
            pre: CacheResult = inputs[0]
            n = int(node.literals[0])
            logits, cache = pre.logits, pre.cache
            outs = []
            pos = pre.prompt_len
            multi = self.cfg.n_codebooks > 1
            for t in range(n):
                nxt = logits[..., : self.cfg.vocab].argmax(-1)
                outs.append(nxt.cpu().numpy().astype(np.int32))
                logits, cache = self._decode(
                    self.params, cache, nxt[:, :, None] if multi else nxt[:, None],
                    torch.tensor(pos + t, dtype=torch.int32, device=self.device),
                )
            return GenResult(np.stack(outs, -1)[0])

        eng.register_op(
            "generate", OpRuntime(units=gen_units, combine=gen_combine)
        )

    # ---------------------------------------------------------------- API --
    def _subscribe(self, node: Node, tenant: Optional[str]) -> None:
        """Multi-tenant bookkeeping: charge the node's cached value against
        ``tenant``'s fair share and add it to the tenant's demand set so the
        cross-tenant scheduler weights it (serving tenants share one DAG, so
        identical prompts dedup by hash consing — both tenants subscribe)."""
        if tenant is None:
            return
        self.engine.cache.subscribe(node.nid, tenant)
        demand = self._tenant_demand.setdefault(tenant, set())
        demand.add(node.nid)
        self.engine.scheduler.set_tenant_demand(tenant, demand)

    def _prefill_node(
        self, prompt: Sequence[int], tenant: Optional[str] = None
    ) -> Node:
        node = self.engine.add("prefill", literals=[_literal(prompt)])
        self._subscribe(node, tenant)
        return node

    def request(
        self,
        prompt: Sequence[int],
        n_tokens: int = 8,
        tenant: Optional[str] = None,
        progressive: bool = False,
    ):
        """A user request — an *interaction*: preempts background work, runs
        only its critical path (prefill reused if speculatively warmed).

        With ``progressive=True`` returns a ProgressiveResult immediately;
        generation has no running combine, so the channel reports coverage
        (tokens decoded / requested) and ``upgrade()`` yields the exact
        GenResult."""
        pre = self._prefill_node(prompt, tenant)
        gen = self.engine.add("generate", parents=[pre], literals=[int(n_tokens)])
        self._subscribe(gen, tenant)
        if progressive:
            return self.engine.interact(gen, tenant=tenant, progressive=True)
        return self.engine.display(gen, tenant=tenant)

    def anticipate(
        self, prompt: Sequence[int], tenant: Optional[str] = None
    ) -> Node:
        """Register a *predicted* future prompt: its prefill becomes a
        non-critical operator the scheduler may run during think time
        (speculative materialisation of the prefix cache)."""
        return self._prefill_node(prompt, tenant)

    def think(self, seconds: float, tenant: Optional[str] = None) -> dict:
        return self.engine.think(seconds, tenant=tenant)

    @property
    def metrics(self):
        return self.engine.metrics
