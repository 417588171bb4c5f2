"""Phase 4k of ``chip_smoke.py`` alone, on one card, with phase 5's parts for
its five training shapes.

Builds the attention kernels (``flash_attention.cu``), then runs phase 4k
(``musicgen_large``, ``h2o_danube_3_4b``, ``starcoder2_7b``,
``qwen3_moe_30b_a3b`` and ``internvl2_76b``, each at the depth reckoned and
printed first: served behind an OpportunisticServer, decoded at 2 layers
against a cache-free forward, trained 4 steps of one 4,096-token sequence,
the step repeated, counted against meta and profiled, check 2 at 2 layers),
then the kernels against the plain attention at the five training shapes
(output and the three gradients within ATTN_TOL) and their forward, dQ and
dK/dV timed beside their bounds, SDPA and the plain version.  Every check
holds as in the whole script.  Exits 2 without a card.

    python3 tools/registry_phases.py
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
        print("registry_phases: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import ops

    smoke.card_setup(torch, ["flash_attention"])
    dev, rng = torch.device("cuda"), np.random.default_rng(0)
    launches = smoke.registry_phase(torch, ops, dev)
    t0 = time.perf_counter()
    errs = smoke.attention_parity(torch, rng, dev, tuple(smoke.REG_ATTN.values()), "4k training")
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    for name, t in smoke.reg_attention_timings(torch, rng, dev, flush).items():
        print(f"[time] {name} shape {t['shape']}: kernel {t['ms']} ms, plain {t['plain_ms']} ms, "
              f"library {t['library_ms']} ms, bound {t['bound'][0]} ms ({t['bound'][1]})")
    print(f"[reg] launches {json.dumps(launches)}; attention max |err| {json.dumps(errs)}; "
          f"phase 5's part took {time.perf_counter() - t0} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
