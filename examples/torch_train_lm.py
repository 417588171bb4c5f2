"""End-to-end training on the PyTorch / CUDA port, the program of
``examples/train_lm.py``: a ~100M-class LM for a few hundred steps on
synthetic structured data, with checkpointing + auto-resume.

Any assigned arch family works via --arch (reduced config).  Trains on the
CUDA card; ``--device cpu`` trains on the CPU.  Checkpoints go to
/tmp/repro_torch_ckpt unless --ckpt-dir says otherwise, so a run never
resumes from a checkpoint of the JAX example (/tmp/repro_ckpt).

Run:  python examples/torch_train_lm.py --steps 200 --arch smollm_360m [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SynthSpec
from repro_torch.train import AdamWConfig, train_loop


def main(argv=None):
    """Train → the loop's ``LoopStats``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    shape = ShapeConfig("example", "train", seq_len=args.seq,
                        global_batch=args.batch)
    run = RunConfig(
        model=cfg, shape=shape, dp=1, tp=1, remat="none",
        grad_compression=args.grad_compression,
    )
    data = SynthSpec(
        vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
        n_codebooks=cfg.n_codebooks, seed=0,
    )
    opt = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)

    stats = train_loop(
        cfg, run, data, total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=50, opt=opt, log_every=20, device=args.device,
    )
    first = float(np.mean(stats.losses[:10]))
    last = float(np.mean(stats.losses[-10:]))
    print(
        f"\ndone: {stats.steps} steps, loss {first:.3f} -> {last:.3f}, "
        f"{stats.checkpoints} checkpoints, "
        f"median step {np.median(stats.step_times)*1e3:.0f} ms"
        + (f", resumed from {stats.resumed_from}" if stats.resumed_from else "")
    )
    return stats


if __name__ == "__main__":
    main()
