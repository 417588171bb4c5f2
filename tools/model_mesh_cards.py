"""Phase 4g of ``chip_smoke.py`` alone, over four cards of one host.

Builds the attention kernels, then runs ``chip_smoke.mesh_phase`` with
every card a shard: granite-MoE at ``ShardCtx(tp=4)`` served over
``make_mesh(1, 4)`` (each card holds its ten experts and its quarter of
every attention cache; split-S decode), its layer-0 checks and a repeat
in a fresh mesh bit for bit, then smollm's step over ``make_mesh(4, 1)``
(each card a data row, its gradient added on the first card) bit for bit
the microbatch-2 step on one card.  Prints the walls beside the no-mesh
run's.  Then phase 4h, ``chip_smoke.fsdp_phase``, over ``make_mesh(4, 1)``
with every card a data row: smollm's sliced step bit for bit the
replicated one, and ``qwen3_8b`` at full width cut to 8 layers, each card
holding its quarter of the state; then ``qwen3_8b`` at full width and
depth (36 layers, 8.19e9 parameters: 131 GB of float32 weights, gradients
and moments whole, 32.77 GB a card sliced), three steps of 4 x 4,096
tokens, with step ms, tokens/s and each card's peak.  Exits 2 on a host
with fewer than four cards.

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
    devices = [torch.device("cuda", i) for i in range(smoke.MESH_TP)]
    smoke.mesh_phase(torch, ops, devices)
    smoke.fsdp_phase(torch, ops, devices)
    t0 = time.perf_counter()
    smoke.fsdp_qwen(torch, ops, devices, layers=36, steps=3, repeat=False, peak_limit=80e9)
    print(f"[fsdp] qwen3_8b at full depth over four cards took {time.perf_counter() - t0} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
