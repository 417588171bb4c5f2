"""Phase 4m of ``chip_smoke.py`` alone, on one card: training over four model
shards emulated on it (``chip_smoke.tp_train_phase``: qwen3_moe_30b_a3b's TP
step against the no-mesh step, TP × FSDP against TP bit for bit, the SSD and
RG-LRU blocks served and trained with their projections in slices, a resume
bit for bit; the SSD and RG-LRU caches placed over the shards), then the
attention kernels at TP training's four shard shapes (``chip_smoke.TPT_ATTN``)
against the plain attention and timed beside their bounds and SDPA, and the
SSD kernels at one shard's heads of the served prefill
(``chip_smoke.TPT_SSD_SHARD``, ``ssd_shard_rows``) against the plain SSD and
timed beside their bounds.  Starts as the script does
(``chip_smoke.card_setup``: TF32 off, the attention and SSD kernels built,
the card's line).

    python3 tools/tp_train_phases.py
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
        print("tp_train_phases: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import ops

    smoke.card_setup(torch, ["flash_attention", "ssd_chunk", "ssd_bwd"])
    dev, rng = torch.device("cuda"), np.random.default_rng(0)
    t0 = time.perf_counter()
    launches = smoke.tp_train_phase(torch, ops, dev)
    print(f"[tp-train] launches {json.dumps(launches)}; phase took {time.perf_counter() - t0} s",
          flush=True)
    errs = smoke.attention_parity(torch, rng, dev, tuple(smoke.TPT_ATTN.values()), "training")
    print(f"[shapes] attention kernels vs plain at the shard shapes, max |err|: "
          f"{json.dumps(errs)}", flush=True)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    smoke.reg_attention_timings(torch, rng, dev, flush, smoke.TPT_ATTN, "4m")
    K = {name: mod for name, mod in ops.KERNELS.items() if name not in smoke.TRAINING}
    ssd_errs = {name: 0.0 for name in smoke.SERVING}
    for name, t in smoke.ssd_shard_rows(torch, K, rng, dev, flush, ssd_errs).items():
        print(f"[time] {name} shape {t['shape']}: kernel {t['ms']} ms, plain {t['plain_ms']} "
              f"ms, library {t['library_ms']} ms, bound {t['bound'][0]} ms ({t['bound'][1]})",
              flush=True)
    print(f"[shapes] the SSD kernels vs plain at {smoke.TPT_SSD_SHARD}, max |err|: "
          f"{json.dumps(ssd_errs)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
