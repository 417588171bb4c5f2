"""Phase 4g of ``chip_smoke.py`` alone, over four cards of one host.

Builds the attention kernels, then runs ``chip_smoke.mesh_phase`` with
every card a shard: granite-MoE at ``ShardCtx(tp=4)`` served over
``make_mesh(1, 4)`` (each card holds its ten experts and its quarter of
every attention cache; split-S decode), its layer-0 checks and a repeat
in a fresh mesh bit for bit, then smollm's step over ``make_mesh(4, 1)``
(each card a data row, its gradient added on the first card) bit for bit
the microbatch-2 step on one card.  Prints the walls beside the no-mesh
run's.  Exits 2 on a host with fewer than four cards.

    python3 tools/model_mesh_cards.py
"""
from __future__ import annotations

import importlib.util
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cards = torch.cuda.device_count()
    if cards < smoke.MESH_TP:
        print(f"model_mesh_cards: needs {smoke.MESH_TP} cards, found {cards}", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: IEEE f32 products
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all(("flash_attention",))
    print(f"[build] flash_attention in {time.perf_counter() - t0} s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().replace("\n", "; ")
    print(f"[card] {smi}", flush=True)
    smoke.mesh_phase(torch, ops, [torch.device("cuda", i) for i in range(smoke.MESH_TP)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
