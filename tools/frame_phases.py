"""The frame phases of ``chip_smoke.py`` alone, on one card (about 3-4
minutes of command time, against about 12 for the whole script).

Builds every kernel, then runs phase 3 (the 10M-row notebook in a cuda and a
numpy session), phase 3c (the notebook over four data-mesh shards on the
card), phase 3d (the engine's contracts: ``warm_device_cache``, progressive
== blocking, batched == unbatched, fused == unfused, faulty == clean) and
granite-MoE's serving of phase 4d (with its layer-0 ``moe_ffn`` forward under
``set_sync_debug_mode("error")``).  Every check of those phases holds as in
the whole script; the kernels' timing (phase 5) does not run.  Exits 2
without a card.

    python3 tools/frame_phases.py
"""
from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("frame_phases: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.frame import backend as BK
    from repro_torch.kernels import ops

    smi = smoke.card_setup(torch)
    _, record = smoke.recorder({name: mod for name, mod in ops.KERNELS.items()
                                if name not in smoke.TRAINING})
    t0 = time.perf_counter()
    ref, cold, _, cold_lat = smoke.main_path(torch, ops, BK, record)
    print(f"[main] phase took {time.perf_counter() - t0} s", flush=True)
    t0 = time.perf_counter()
    smoke.dist_phase(torch, ops, BK, record, smi)
    print(f"[dist] phase took {time.perf_counter() - t0} s", flush=True)
    smoke.contracts_phase(torch, ops, BK, ref, cold, cold_lat)
    t0 = time.perf_counter()
    smoke.serving_hybrid(torch, ops, "granite_moe_3b_a800m", torch.device("cuda"))
    print(f"[serve-hybrid] phase took {time.perf_counter() - t0} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
