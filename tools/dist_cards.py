"""Phase 3c of ``chip_smoke.py`` alone, on a host with 2^k >= 2 cards.

Builds the dataframe kernels, then runs ``chip_smoke.dist_phase``: the seven
notebook cells over four shards emulated on ``cuda:0`` and over
``data_mesh()`` with every card a shard, each bit for bit against the host
path, with a sharded call of every family, the kernel launched inside each,
no "sharded" breaker failure, and the 4,000,000-row ``accounts`` join taking
the partition-parallel build under "auto".  Prints each cell's wall beside
the host path's.  Exits 2 without such a host.

    python3 tools/dist_cards.py
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

    cards = torch.cuda.device_count()
    if cards < 2 or cards & (cards - 1):
        print(f"dist_cards: needs 2^k >= 2 cards, found {cards}", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.frame import backend as BK
    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    _build.build_all(smoke.DATAFRAME)
    print(f"[build] {', '.join(smoke.DATAFRAME)} in {time.perf_counter() - t0} s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().replace("\n", "; ")
    t0 = time.perf_counter()
    _, record = smoke.recorder({name: mod for name, mod in ops.KERNELS.items()
                                if name not in smoke.TRAINING})
    launches = smoke.dist_phase(torch, ops, BK, record, smi)
    print(f"[dist] phase took {time.perf_counter() - t0} s; launches on the emulated mesh "
          + ", ".join(f"{k} {launches[k]}" for k in smoke.DIST_KERNELS), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
