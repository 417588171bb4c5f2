#!/usr/bin/env python3
"""Where the SSD backward's tensor-core kernels spend their time on the card.

Run from the repository root on a machine with one CUDA card and ``nvcc``::

    python3 tools/ssd_bwd_variants.py

Builds copies of ``src/repro_torch/kernels/csrc/ssd_bwd.cu`` (and of
``hopper.cuh`` where a change lies there) that each change one thing (all at once, one ``nvcc`` each, into the kernels'
``_build/bwd_variants/``) and times the C entries of ``ssd_bwd_chunk_wgmma``
and ``ssd_bwd_state_wgmma`` of each copy at mamba2_2p7b's training launch (1
x 4,096 x 80 x 64, N 128, chunk 128, bf16, no dh; cold L2, device time by
CUDA events), in two rounds, beside the float32 FMA kernels of the same
library on the same inputs:

* as built;
* one stage: the chunk kernel's ring of X and dY holds one head, not two;
* registers 208 / 88: the chunk kernel's consumer warpgroups keep 208
  registers a thread (setmaxnreg), its producer warpgroup 88, not 232 and 40;
* tile loops unrolled: the chunk kernel's loops over 64-row tiles (and over
  a product's m tiles) unrolled, as the rest of its loops are;
* state terms cut: the products with g and h_in (B g, X gᵀ, dY h_inᵀ) do
  nothing, so dx, db, dc and dlog_a lose their state terms;
* L x L products cut: Mᵀ dY, Zᵀ C and Z B do nothing;
* state product cut: the state kernel's per-chunk products do nothing, so it
  walks D_k alone;
* phases counted: built with ``-DSSD_BWD_PHASES``, so the chunk kernel's
  ``PHASE`` marks read ``clock64()`` at the boundaries of its per-head
  phases (the wait for X and dY, the three state-term products with their
  staging, each accumulator's load from the staging buffer, the L x L
  products of db, dx and dc, and their stores) and thread 0 of each
  consumer warpgroup adds each phase's cycles to a counter.  After the
  rounds one launch of it prints the cycles a head and warpgroup, averaged
  over the launch;
* phase fences: each ``PHASE`` mark a compiler memory fence (``asm
  volatile("" ::: "memory")``), nothing counted;
* phase clock reads: each ``PHASE`` mark one ``clock64`` read into a
  register, nothing counted.

Copies that keep the function whole must give the tree's own kernels' bits;
the cut ones give wrong answers by design and time only what is left.  Also
prints each copy's registers and spills (``ptxas -v``) for the two kernels.
Prints the card's ``nvidia-smi`` name, power limit and SM clock first.
Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (file in csrc/, text, replacement)
ONE_STAGE = ("ssd_bwd.cu", "<= SMEM_BUDGET ? 2 : 1;", "<= SMEM_BUDGET ? 1 : 1;")
REGS = ("ssd_bwd.cu", "PRODUCER_REGS = 40, CONSUMER_REGS = 232;",
        "PRODUCER_REGS = 88, CONSUMER_REGS = 208;")
UNROLL = ("ssd_bwd.cu", "#pragma unroll 1\n", "#pragma unroll\n")
CUT_T = ("ssd_bwd.cu", "    for (int u = 0; u < 3; ++u) wgmma_rs_n64_k(d, fr[kk][u], db);",
         "    for (int u = 0; u < 0; ++u) wgmma_rs_n64_k(d, fr[kk][u], db);")
CUT_LL = ("ssd_bwd.cu", "  for (int kk = 0; kk < 4; ++kk) {\n    const uint64_t db = sw128_desc(b + kk * 16",
          "  for (int kk = 0; kk < 0 * 4; ++kk) {\n    const uint64_t db = sw128_desc(b + kk * 16")
CUT_STATE = ("hopper.cuh", "  for (int rt = 0; rt < L / 64; ++rt) {\n    uint32_t fr[4][3][4];",
             "  for (int rt = 0; rt < 0 * L / 64; ++rt) {\n    uint32_t fr[4][3][4];")
PHASES_ON = "-DSSD_BWD_PHASES"
NO_PHASE = "#define PHASE(k) \\\n  do {           \\\n  } while (0)\n"
FENCES = ("ssd_bwd.cu", NO_PHASE, '#define PHASE(k) asm volatile("" ::: "memory")\n')
CLOCKS = ("ssd_bwd.cu", NO_PHASE, "#define PHASE(k) \\\n  do { long long t_; asm volatile(\"mov.u64 "
          "%0, %%clock64;\" : \"=l\"(t_)); } while (0)\n")
# (name, substitutions or nvcc flags, whole)
VARIANTS = (("as built", [], True), ("one stage", [ONE_STAGE], True),
            ("registers 208 / 88", [REGS], True), ("tile loops unrolled", [UNROLL], True),
            ("state terms cut", [CUT_T], False), ("L x L products cut", [CUT_LL], False),
            ("state product cut", [CUT_STATE], False), ("phases counted", [PHASES_ON], True),
            ("phase fences", [FENCES], True), ("phase clock reads", [CLOCKS], True))
# the chunk kernel's phases, as its PHASE(k) marks number them
PHASES = ["wait for X and dY", "g Xᵀ", "db from staging", "db L x L", "db store", "gᵀ Bᵀ",
          "dx from staging", "dx L x L", "dx store", "h_in dYᵀ", "dc from staging", "dc L x L",
          "dc store and rows"]
SHAPE = (1, 4096, 80, 64, 128, 128)  # batch, S, H, P, N, L


def build(_build, out_dir: Path) -> dict:
    """name → (path of the built library, its ptxas report), one nvcc each,
    all started at once.  A variant's patched files go to a directory of its
    own, where its ssd_bwd.cu finds a patched hopper.cuh before csrc/'s."""
    procs = {}
    for i, (name, subs, _) in enumerate(VARIANTS):
        vdir = out_dir / f"variant{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        texts = {"ssd_bwd.cu": (_build.CSRC / "ssd_bwd.cu").read_text()}
        flags = [f for f in subs if isinstance(f, str)]
        for fname, old, new in (f for f in subs if not isinstance(f, str)):
            text = texts.get(fname) or (_build.CSRC / fname).read_text()
            if old not in text:
                raise SystemExit(f"ssd_bwd_variants: {old!r} is no longer in {fname}")
            texts[fname] = text.replace(old, new)
        for fname, text in texts.items():
            (vdir / fname).write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC), "-o",
               str(vdir / "variant.so"), str(vdir / "ssd_bwd.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                       vdir / "variant.so")
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ssd_bwd_variants: nvcc failed for {name}:\n{log.decode()}")
        libs[name] = (so, log.decode(errors="replace"))
    return libs


def ptxas_lines(log: str) -> list:
    """[(kernel<template arguments>, registers, spill stores, spill loads)]
    of the tensor-core kernels at the training launch's templates."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(ssd_bwd_(?:chunk|state)_wgmma)I(\S*?)EEv",
                      line)
        if m:
            name = f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"
            spills = (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            if name in ("ssd_bwd_chunk_wgmma<128,128,64>", "ssd_bwd_state_wgmma<128,64>"):
                out.append((name, int(m.group(1))) + spills)
            name = None
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ssd_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_chunk as SC
    from repro_torch.kernels._launch import I32, P

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
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

    bt, S, H, Pd, N, L = SHAPE
    nc = S // L

    def t(a, dt=torch.bfloat16):
        return torch.as_tensor(a, device=dev).to(dt).contiguous()

    x, la, b, c, dy = (t(rng.normal(0, 1, (bt, S, H, Pd))),
                       t(-rng.uniform(1e-3, 0.5, (bt, S, H)), torch.float32),
                       t(rng.normal(0, 0.3, (bt, S, N))), t(rng.normal(0, 0.3, (bt, S, N))),
                       t(rng.normal(0, 1, (bt, S, H, Pd))))
    want_hin, want_g = SC.ssd_bwd_states(x, la, b, c, L, dy)
    hin, g = torch.empty_like(want_hin), torch.empty_like(want_g)
    dbp = torch.empty((bt, nc, H, L, N), device=dev)
    dcp, dx, dla = torch.empty_like(dbp), torch.empty_like(x), torch.empty((bt, S, H), device=dev)
    G = SC.heads_per_block(bt, nc, H, torch.cuda.get_device_properties(dev).multi_processor_count)
    ins = (x.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr())

    def entries(lib):
        st = getattr(lib, "repro_ssd_bwd_state_wgmma")
        st.argtypes, st.restype = [P] * 6 + [I32] * 6 + [P] * 3, ctypes.c_int
        ch = getattr(lib, "repro_ssd_bwd_chunk_wgmma")
        ch.argtypes, ch.restype = [P] * 7 + [I32] * 7 + [P] * 5, ctypes.c_int

        def state():
            err = st(*ins, 0, *SHAPE, hin.data_ptr(), g.data_ptr(), stream)
            if err:
                raise SystemExit(f"ssd_bwd_variants: state launch failed with {err}")

        def chunk():  # on the tree's own h_in and g
            err = ch(*ins, want_hin.data_ptr(), want_g.data_ptr(), *SHAPE, G, dx.data_ptr(),
                     dla.data_ptr(), dbp.data_ptr(), dcp.data_ptr(), stream)
            if err:
                raise SystemExit(f"ssd_bwd_variants: chunk launch failed with {err}")

        return state, chunk

    libs = build(_build, _build.BUILD_DIR / "bwd_variants")
    for name, (_, log) in libs.items():
        print(f"[ptxas] {name}: " + "; ".join(f"{k} {r} registers, spills {st}/{ld} bytes"
                                             for k, r, st, ld in ptxas_lines(log)), flush=True)
    state, chunk = entries(ctypes.CDLL(str(libs["as built"][0])))
    state()
    chunk()
    torch.cuda.synchronize()
    ref = [a.clone() for a in (hin, g, dx, dla, dbp, dcp)]
    if not (torch.equal(hin, want_hin) and torch.equal(g, want_g)):
        raise SystemExit("ssd_bwd_variants: the built copy differs from the tree's kernels")
    fns = SC._bwd_fns()
    cells = {
        "ssd_bwd_state (FMA)": lambda: fns["state"](*ins, 0, *SHAPE, 1, hin.data_ptr(),
                                                    g.data_ptr(), stream),
        "ssd_bwd_chunk (FMA)": lambda: fns["chunk"](
            *ins, want_hin.data_ptr(), want_g.data_ptr(), *SHAPE, 1, dx.data_ptr(),
            dla.data_ptr(), dbp.data_ptr(), dcp.data_ptr(), stream),
    }
    for rnd in (1, 2):
        for name, _, whole in VARIANTS:
            state, chunk = entries(ctypes.CDLL(str(libs[name][0])))
            state()
            chunk()
            torch.cuda.synchronize()
            if whole and not all(torch.equal(p, q) for p, q in
                                 zip((hin, g, dx, dla, dbp, dcp), ref)):
                raise SystemExit(f"ssd_bwd_variants: {name}: the outputs differ from the "
                                 "tree's kernels")
            print(f"[variant] round {rnd}, {name}: ssd_bwd_chunk_wgmma {timed(chunk, 10)} ms, "
                  f"ssd_bwd_state_wgmma {timed(state, 10)} ms at {list(SHAPE)}, {G} heads a "
                  "block", flush=True)
        print(f"[variant] round {rnd}, the FMA kernels on the same inputs: " + ", ".join(
            f"{k} {timed(fn, 3)} ms" for k, fn in cells.items()), flush=True)

    lib = ctypes.CDLL(str(libs["phases counted"][0]))
    lib.repro_ssd_bwd_phases.argtypes, lib.repro_ssd_bwd_phases.restype = [P], ctypes.c_int
    _, chunk = entries(lib)
    if lib.repro_ssd_bwd_phases(None):
        raise SystemExit("ssd_bwd_variants: the phase counters cannot be set to 0")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    chunk()
    stop.record()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 32)()
    if lib.repro_ssd_bwd_phases(ctypes.addressof(buf)):
        raise SystemExit("ssd_bwd_variants: the phase counters cannot be read")
    cycles = np.array(list(buf), dtype=np.float64).reshape(2, 16)
    print(f"[phases] ssd_bwd_chunk_wgmma at {list(SHAPE)}, {G} heads a block: one launch "
          f"{start.elapsed_time(stop)} ms with the counters", flush=True)
    for w in range(2):
        row = {name: round(cycles[w, k] / (nc * H)) for k, name in enumerate(PHASES)}
        print(f"[phases] warpgroup {w}, cycles a head: all {round(cycles[w].sum() / (nc * H))}; "
              + "; ".join(f"{k} {v}" for k, v in row.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
