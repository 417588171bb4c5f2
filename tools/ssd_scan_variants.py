#!/usr/bin/env python3
"""Where ``ssd_scan``'s time goes on the card, and how many chunks a block
should take.

Run from the repository root on a machine with one CUDA card and ``nvcc``::

    python3 tools/ssd_scan_variants.py

1. Builds copies of ``src/repro_torch/kernels/csrc/ssd_chunk.cu`` that each
   change one thing (all at once, one ``nvcc`` each, into the kernels'
   ``_build/variants/``): the walk to a block's first chunk cut, the
   tensor-core product cut, one block an SM (``__launch_bounds__``), tiles
   of 128 rows at chunks of 128.  Times each
   copy's ``repro_ssd_scan`` C entry at the 1,024-token serving shape (1 x
   1,024 x 80 x 64, N 128, chunk 128, bf16; cold L2, device time by CUDA
   events), in two rounds.  The copies that keep the function whole must
   give h_final equal to the plain version's bit for bit; the cut ones
   give wrong answers by design and time only what is left.
2. Times the tree's own kernel at short chunks over the chunks a block
   takes (``cpb``), beside what ``ssd_chunk.scan_chunks`` picks.

Prints the card's ``nvidia-smi`` name and power limit first.  Imports
nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (name, [(text in csrc/ssd_chunk.cu, replacement)])
CUT_WALK = ("  for (int k = 0; k < k0; ++k) {", "  for (int k = 0; k < 0 * k0; ++k) {")
CUT_PRODUCT = ("        for (int k16 = 0; k16 < N16; k16 += 16) {",
               "        for (int k16 = 0; k16 < 0 * N16; k16 += 16) {")
ONE_BLOCK = ("__launch_bounds__(SCAN_THREADS, 2)", "__launch_bounds__(SCAN_THREADS, 1)")
TILE128 = ("    REPRO_SCAN(8, 64);", "    REPRO_SCAN(8, 128);")
VARIANTS = (("as built", [], True), ("walk cut", [CUT_WALK], False),
            ("product cut", [CUT_PRODUCT], False), ("one block an SM", [ONE_BLOCK], True),
            ("128-row tiles", [TILE128], True))
SHORT_SHAPES = ((1, 1000, 80, 64, 128, 1), (1, 1000, 80, 64, 128, 2), (1, 1024, 80, 64, 128, 16),
                (1, 1024, 80, 64, 128, 32))


def build(_build, out_dir: Path) -> dict:
    """name → path of the built library, one nvcc each, all started at once."""
    src = (_build.CSRC / "ssd_chunk.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs, _) in enumerate(VARIANTS):
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"ssd_scan_variants: {old!r} is no longer in ssd_chunk.cu")
            text = text.replace(old, new)
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(out_dir / f"variant{i}.so"), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                       out_dir / f"variant{i}.so")
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ssd_scan_variants: nvcc failed for {name}:\n{log.decode()}")
        libs[name] = so
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ssd_scan_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_chunk as SC
    from repro_torch.kernels._launch import I32, P

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def timed(fn, iters):
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        return total / iters

    def inputs(bt, S, H, Pd, N, L):
        def t(a, dt=torch.bfloat16):
            return torch.as_tensor(a, device=dev).to(dt).contiguous()

        x, la, b, c = (t(rng.normal(0, 1, (bt, S, H, Pd))),
                       t(-rng.uniform(1e-3, 0.5, (bt, S, H)), torch.float32),
                       t(rng.normal(0, 0.3, (bt, S, N))), t(rng.normal(0, 0.3, (bt, S, N))))
        y_intra, state = SC.ssd_chunk_intra(x, la, b, c, L)
        return (y_intra, state, SC.chunk_decays(la, S // L), c,
                SC.ssd_chunk_inter_plain(y_intra, state, la, c))

    def runner(fn, args, bt, S, H, Pd, N, L, cpb):
        y_intra, state, ecum, c, _ = args
        y = torch.empty_like(y_intra)
        hf = torch.empty((bt, H, N, Pd), device=dev)

        def run():
            err = fn(y_intra.data_ptr(), state.data_ptr(), ecum.data_ptr(), c.data_ptr(), bt, S,
                     H, Pd, N, L, cpb, 1, y.data_ptr(), hf.data_ptr(), stream)
            if err:
                raise SystemExit(f"ssd_scan_variants: launch failed with cudaError_t {err}")

        return run, hf

    libs = build(_build, _build.BUILD_DIR / "variants")
    shape = (1, 1024, 80, 64, 128, 128)
    args = inputs(*shape)
    for rnd in (1, 2):
        for name, _, whole in VARIANTS:
            fn = getattr(ctypes.CDLL(str(libs[name])), "repro_ssd_scan")
            fn.argtypes, fn.restype = [P] * 4 + [I32] * 8 + [P] * 3, ctypes.c_int
            run, hf = runner(fn, args, *shape, 1)
            run()
            torch.cuda.synchronize()
            if whole and not torch.equal(hf, args[4][1]):
                raise SystemExit(f"ssd_scan_variants: {name}: h_final differs from the plain "
                                 "version's")
            print(f"[variant] round {rnd}, {name}: C entry {timed(run, 20)} ms at {list(shape)}",
                  flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for sh in SHORT_SHAPES:
        bt, S, H, Pd, N, L = sh
        nc, args = S // L, inputs(*sh)
        pick = SC.scan_chunks(bt, nc, H, Pd, L, sms)
        times = []
        for segments in (1, 2, 4, 8, 16):
            cpb = -(-nc // segments)
            run, hf = runner(SC._fns()["scan"], args, *sh, cpb)
            run()
            torch.cuda.synchronize()
            if not torch.equal(hf, args[4][1]):
                raise SystemExit(f"ssd_scan_variants: {sh} at {cpb} chunks a block: h_final "
                                 "differs from the plain version's")
            times.append((cpb, timed(run, 5)))
        print(f"[chunks] {list(sh)}: ms by chunks a block {times}; scan_chunks picks {pick}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
