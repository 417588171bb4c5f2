"""The SSD-gradient phases of ``chip_smoke.py`` alone, on one card (about 2.5
minutes of command time, against about 15 for the whole script).

Builds the SSD's forward and backward kernels (``ssd_chunk.cu``,
``ssd_bwd.cu``), then runs phase 2c (the three backward kernels against the
plain backward and float64 autograd), the backward's timing of phase 5 at
mamba2_2p7b's training launch, and phase 4j (``mamba2_2p7b`` at full width
and depth trained through the train launcher, the repeated step, the
profiled step, the C14 check at 2 layers and the 2-layer step counted on the
card against meta).  Every check of those phases holds as in the whole
script.  Exits 2 without a card.

    python3 tools/ssd_train_phases.py
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ssd_train_phases: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import ops

    smoke.card_setup(torch, ["ssd_chunk", "ssd_bwd"])
    dev, rng = torch.device("cuda"), np.random.default_rng(0)
    t0 = time.perf_counter()
    errs = smoke.ssd_bwd_parity(torch, rng, dev)
    print(f"[parity] ssd backward, max |err|: {json.dumps(errs)}; phase took "
          f"{time.perf_counter() - t0} s", flush=True)
    smoke.ssd_bwd_timing(torch, rng, dev)
    t0 = time.perf_counter()
    launches = smoke.training_ssd(torch, ops, dev)
    print(f"[train-ssd] launches {json.dumps(launches)}; phase took "
          f"{time.perf_counter() - t0} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
