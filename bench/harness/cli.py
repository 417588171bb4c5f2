"""One run of one cell: look up the cell, check the cards, hand it to its
kind, read its metrics, check the imports, print the result line.

The kind (``bench/kinds/<kind>.py``) exposes ``run(cell, seed, seconds,
trace, device) -> Outcome``: it sets up, measures the window, reads the
peak memory, frees the program's state and decides ``correct``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import spec
from .trace import Recorder

# top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Outcome:
    setup_s: float
    rec: Recorder
    attempted: int
    failed: int
    # short name -> (value, limit): the numbers compared, each <= its limit
    checks: Dict[str, Tuple[float, float]]
    memory_peak_bytes: int
    # anything a metric reader needs beyond the spans (counts, work)
    data: Dict[str, Any] = field(default_factory=dict)
    config: Dict[str, Any] = field(default_factory=dict)
    traffic: Dict[str, Any] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for v, lim in self.checks.values())


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def require_cards(n: int) -> None:
    """Refuse to run without ``n`` CUDA cards: no CPU fallback."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell needs {n} CUDA devices, {torch.cuda.device_count()} "
                         "are visible")


def forbidden_modules() -> List[str]:
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def metrics_of(out: Outcome, metrics: List[Dict[str, Any]], required: bool
               ) -> Dict[str, Dict[str, Any]]:
    res = {}
    for m in metrics:
        value = spec.metric_reader(m["name"]).read(out)
        if value is None:
            if required:
                raise RuntimeError(f"metric {m['name']} read nothing")
            continue
        res[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return res


def result_line(cell: spec.Cell, out: Outcome, trace: bool, device_kind: str) -> Dict[str, Any]:
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    line: Dict[str, Any] = {"correct": out.correct, "attempted": out.attempted,
                            "failed": out.failed}
    if trace:
        dt = out.rec.device_trace
        line["metrics"] = metrics_of(out, cell.per_layer, required=False)
        device["busy_s"] = dt.busy_s()
        device["window_s"] = dt.window_s
        line["device"] = device
        line["breakdown"] = dt.breakdown()
    else:
        line["metrics"] = metrics_of(out, cell.end_to_end, required=True)
        line["device"] = device
    # a gap with no bound (a NaN against a number) prints as the largest float
    line["checks"] = {k: {"value": v if math.isfinite(v) else sys.float_info.max, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(args.workload, bench)
    require_cards(cell.chips)
    import torch

    kind = spec.kind_module(cell.traffic["kind"])
    out = kind.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     device="cuda")
    line = result_line(cell, out, bool(args.trace), torch.cuda.get_device_name(0))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the benchmark's process: {bad}", file=sys.stderr)
        return 3
    for sp in out.rec.spans:  # every span of the window, for the record
        attrs = " ".join(f"{k}={v}" for k, v in sp.attrs.items() if not isinstance(v, list))
        print(f"span {sp.kind}#{sp.index} {1e3 * sp.seconds:.3f} ms {attrs}", file=sys.stderr)
    if "check_s" in out.data:
        print(f"comparison with the reference: {out.data['check_s']:.1f} s", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
