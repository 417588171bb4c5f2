"""Opportunistic LLM serving on the PyTorch / CUDA port, the program of
``examples/serve_opportunistic.py``: the paper's technique at the serving
layer.

User requests are interactions; between requests (think time) the engine
speculatively prefills *anticipated* prompts, so predicted requests start
decoding immediately; identical prompts are pure cache hits (CSE +
materialised KV caches with Eq 2/3 eviction).  Serves on the CUDA card;
``--device cpu`` serves on the CPU.

Run:  python examples/torch_serve_opportunistic.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.models import ShardCtx, init_model
from repro_torch.serve import OpportunisticServer


def main(argv=None) -> dict:
    """Serve the three requests → their tokens and simulated latencies."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config("qwen3_8b")
    params = init_model(cfg, ShardCtx(), seed=0, device=args.device)
    server = OpportunisticServer(cfg, params, step_cost_s=0.05, prefill_cost_s=0.12,
                                 device=args.device)

    rng = np.random.default_rng(0)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab, 32)) for _ in range(4)]
    tokens, latencies = [], []

    def record(out):
        tokens.append(out.tokens.tolist())
        latencies.append(server.metrics.interactions[-1].latency_s)

    print("cold request (pays prefill + decode):")
    out = server.request(prompts[0], n_tokens=6)
    record(out)
    print(f"  latency {latencies[-1]:.3f}s tokens={tokens[-1]}")

    print("\nanticipating the next prompt; user thinks for 10 s ...")
    server.anticipate(prompts[1])
    server.think(10.0)

    print("anticipated request (prefix cache warmed during think time):")
    record(server.request(prompts[1], n_tokens=6))
    print(f"  latency {latencies[-1]:.3f}s")

    print("\nidentical resubmission (CSE + cache: instant):")
    record(server.request(prompts[1], n_tokens=6))
    print(f"  latency {latencies[-1]:.3f}s")

    metrics = server.metrics.summary()
    print("\nmetrics:", metrics)
    return {"tokens": tokens, "latencies": latencies, "metrics": metrics}


if __name__ == "__main__":
    main()
