"""The benchmark's arithmetic: percentiles, unions of device
intervals, and the peaks and work formulas of the rooflines and the MFU.

The work formulas are a frozen copy of ``repro_torch.launch.roofline``'s
(``ssd_work``, ``scan_work``, ``ssd_bwd_total``) and of the parameter count
behind its ``model_flops_for``: the program may change its own, the
yardstick stays.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

# One NVIDIA H100 SXM (data sheet, dense): bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals: Iterable[Tuple[float, float]],
                 lo: float = -math.inf, hi: float = math.inf) -> float:
    """Total length of the union of ``intervals``, clipped to [lo, hi]."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM's rate and the operations over the bf16 peak."""
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)


# -- the SSD's work (frozen copy of launch/roofline.py's formulas) -----------

def ssd_work(bt, S, H, Pd, N, L, esize):
    """(bytes, flops) of the intra-chunk pass at chunk L."""
    nc, tri = S // L, L * (L + 1) // 2
    nbytes = bt * (esize * (2 * S * H * Pd + 2 * S * N) + 4 * S * H + 4 * nc * H * N * Pd)
    return nbytes, bt * nc * H * 2 * (tri * N + tri * Pd + N * L * Pd)


def scan_work(bt, S, H, Pd, N, L, esize):
    """(bytes, flops) of the inter-chunk pass at chunk L."""
    nc = S // L
    nbytes = bt * (esize * (2 * S * H * Pd + S * N) + 4 * (nc * H * N * Pd + S * H + H * N * Pd))
    return nbytes, bt * 2 * H * Pd * (S * N + nc * N + S)


def ssd_bwd_total(bt, S, H, Pd, N, L, esize, dh=True):
    """(bytes, flops) of the SSD backward as one function."""
    nc, tri = S // L, L * (L + 1) // 2
    flops = (bt * H * max(nc - 1, 0) * 4 * N * Pd * (L + 1)
             + bt * nc * (2 * tri * N + H * (4 * tri * N + 4 * tri * Pd + 6 * tri
                                            + 6 * L * N * Pd + 4 * L * Pd + 6 * L * N
                                            + 2 * N * Pd + 6 * L))
             + bt * S * N * 2 * H)
    nbytes = bt * (esize * (3 * S * H * Pd + 4 * S * N) + 4 * 2 * S * H)
    if dh:
        nbytes += 4 * bt * H * N * Pd
    return nbytes, flops


def ssd_forward_need(S, H, Pd, N, L, esize=2):
    """(bytes, flops) that one sequence of S tokens needs of the SSD
    forward, whatever route the program takes: x, B, C and log a read
    once, y and the final state written once; the operations of the
    chunked algorithm at chunk L over ceil(S / L) chunks (the last chunk
    charged whole)."""
    Sp = -(-S // L) * L
    nbytes = esize * (2 * S * H * Pd + 2 * S * N) + 4 * S * H + 4 * H * N * Pd
    flops = ssd_work(1, Sp, H, Pd, N, L, esize)[1] + scan_work(1, Sp, H, Pd, N, L, esize)[1]
    return nbytes, flops


def mamba2_params(m: dict) -> int:
    """Parameters of a Mamba-2 language model from its configuration file
    (``ModelConfig.param_count``'s formula for an SSD model), over the
    embedding's rows: the vocabulary padded to ``pad_vocab_size_multiple``."""
    k = int(m.get("pad_vocab_size_multiple", 1))
    d, v, n = m["d_model"], -(-int(m["vocab_size"]) // k) * k, m["n_layer"]
    di = m["expand"] * d
    ns, nh = m["d_state"], di // m["headdim"]
    per_layer = d * (2 * di + 2 * ns + nh) + di * m["d_conv"] + di * d + 2 * d
    return v * d * (1 if m["tie_embeddings"] else 2) + n * per_layer
