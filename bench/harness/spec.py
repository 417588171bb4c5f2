"""Finding a cell and everything it names, by name alone.

``BENCHMARK.json`` (at the checkout's root) names the cell's configuration
and traffic mix.  The configuration's file is the one its ``file`` entry
gives; the traffic mix is ``bench/traffic/<traffic>.json``; its ``kind``
picks the module ``bench/kinds/<kind>.py``; each metric is read by
``bench/metrics/<metric>.py``.  A later change adds a configuration, a mix,
a kind or a metric as new files and entries, and edits none of these.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    return _module(BENCH / "metrics" / f"{name}.py", "bench_metric_" + name.replace(".", "_"))


def kind_module(kind: str) -> ModuleType:
    return _module(BENCH / "kinds" / f"{kind}.py", "bench_kind_" + kind)


def cell(name: str, bench: Dict[str, Any], root: Path = ROOT) -> Cell:
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    # a metric without a workload list is read in every cell that reports
    # the end-to-end metric it moves
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=layer)
