"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs an opportunistic serving session (the paper's technique at the serving
layer): a stream of requests with think-time gaps, anticipated-prompt
prefill warming, and per-request latency reporting.  The reference
launcher's flags and defaults, plus ``--device``: the CUDA card unless
``--device cpu`` asks for the CPU.

``main(argv)`` returns each request's tokens and simulated latency.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..configs import get_smoke_config
from ..models import ShardCtx, init_model
from ..serve import OpportunisticServer


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--tokens", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--think", type=float, default=8.0)
    ap.add_argument("--no-anticipate", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the CUDA card)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    args = parser().parse_args(argv)

    cfg = get_smoke_config(args.arch)
    params = init_model(cfg, ShardCtx(), seed=args.seed, device=args.device)
    server = OpportunisticServer(cfg, params, step_cost_s=0.05,
                                 prefill_cost_s=0.12, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = [
        tuple(int(t) for t in rng.integers(0, cfg.vocab, args.prompt_len))
        for _ in range(args.requests)
    ]
    results = []
    for i, p in enumerate(prompts):
        if not args.no_anticipate and i + 1 < len(prompts):
            server.anticipate(prompts[i + 1])
        out = server.request(p, n_tokens=args.tokens)
        lat = server.metrics.interactions[-1].latency_s
        results.append({"tokens": out.tokens.tolist(), "latency_s": lat})
        print(f"request {i}: latency {lat:.3f}s  tokens {out.tokens.tolist()}")
        server.think(args.think)
    lats = [r.latency_s for r in server.metrics.interactions]
    print(f"\nmean latency {np.mean(lats):.3f}s  p95 {np.percentile(lats, 95):.3f}s")
    print("engine:", server.metrics.summary())
    return results


if __name__ == "__main__":
    main()
