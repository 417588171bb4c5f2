"""``BENCHMARK.json`` keeps to the benchmark's rules; everything a cell names
is found by name alone, so that a configuration, a traffic mix or a metric
is added as new files; no file of the benchmark loads JAX or the JAX
package, nor reads the old ``benchmarks/`` folder, and the plain references
import nothing of the port; a run that finds no card fails and prints no
result."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from harness import spec  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
REFERENCES = ("frame_ref.py", "mamba_ref.py", "arith.py", "tpch.py", "notebook.py")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units_keep_to_the_rules():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and len(b["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in b["paths"])
    assert all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].split("/")[0] in b["paths"] and (ROOT / c["file"]).is_file()
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        cells.add(w["name"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", cells)) <= cells
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_reports_set_up_another_end_to_end_metric_and_a_layer():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    for w in BENCHMARK["workloads"]:
        cell = spec.cell(w["name"], BENCHMARK)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        for m in cell.per_layer:  # each moves an end-to-end metric of its cell
            assert m["moves"] in reported and m["moves"] in e2e


def test_everything_a_cell_names_is_found_by_name():
    for w in BENCHMARK["workloads"]:
        cell = spec.cell(w["name"], BENCHMARK)
        assert hasattr(spec.kind_module(cell.traffic["kind"]), "run")
        assert hasattr(spec.kind_module(cell.traffic["kind"]), "control")
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(m["name"]).read)


def test_a_configuration_a_mix_and_a_metric_are_added_as_new_files(tmp_path):
    """A copy of the benchmark, given a new configuration, traffic mix,
    cell and per-layer metric as new files and entries alone, finds them."""
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    b = json.loads(json.dumps(BENCHMARK))
    b["configs"].append({"name": "tpch_sf1", "source": "TPC-H v3 at scale factor 1",
                         "file": "bench/configs/tpch_sf1.json", "reduced": [],
                         "why": "a smaller deployment"})
    b["workloads"].append({"name": "tpch_sf1.explore_short", "config": "tpch_sf1",
                           "traffic": "explore_short", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "think_count.nb", "unit": "count", "better": "higher",
                           "source": "host_clock", "layer": "engine, scheduler and cache",
                           "moves": "interaction_mean_ms",
                           "workloads": ["tpch_sf1.explore_short"]})
    b["end_to_end"][0]["workloads"].append("tpch_sf1.explore_short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cfg = json.loads((BENCH / "configs" / "tpch_sf1.json").read_text())
    cfg.update(name="tpch_sf1", scale_factor=1)
    (tmp_path / "bench/configs/tpch_sf1.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "explore.json").read_text())
    mix["cells_per_notebook"] = 4
    (tmp_path / "bench/traffic/explore_short.json").write_text(json.dumps(mix))
    (tmp_path / "bench/metrics/think_count.nb.py").write_text(
        "def read(out):\n    return len(out.rec.of('think'))\n")
    code = ("import sys; sys.path.insert(0, 'bench'); from harness import spec; "
            "c = spec.cell('tpch_sf1.explore_short', spec.load_benchmark()); "
            "print(c.config['scale_factor'], c.traffic['cells_per_notebook'], "
            "[m['name'] for m in c.per_layer][-1], "
            "spec.metric_reader('think_count.nb').__name__)")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["1", "4", "think_count.nb", "bench_metric_think_count_nb"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _strings(path):
    """The string constants of a file's code, its docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_no_file_imports_jax_or_the_jax_package_or_reads_the_old_benchmarks():
    for path in BENCH.rglob("*.py"):
        tops = {m.partition(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, path
        if path.name != Path(__file__).name:
            assert not any("benchmarks" in s for s in _strings(path)), path


def test_the_references_import_nothing_of_the_port():
    for name in REFERENCES:
        tops = {m.partition(".")[0] for m in _imports(BENCH / "harness" / name)}
        assert "repro_torch" not in tops, name


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """The harness, every kind and metric it names, and a small run of
    each cell's kind on the CPU, in a fresh process: then no loaded
    module's top-level name is jax, jaxlib, flax or repro."""
    code = """
import sys
sys.path[:0] = ['bench', 'src']
from harness import cli, small, spec
b = spec.load_benchmark()
for w in b['workloads']:
    cell = small.small_cell(w['name'])
    for m in cell.end_to_end + cell.per_layer:
        spec.metric_reader(m['name'])
    small.kind_of(cell).run(cell, seed=1, seconds=0.2, trace=False, device='cpu')
print(sorted({m.partition('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'repro'}))
print('repro_torch' in sys.modules)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split("\n")[-3:-1] == ["[]", "True"]


@pytest.fixture()
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would not take the no-card path")


def test_a_run_without_a_card_fails_and_prints_no_result(no_card, tmp_path):
    res = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "tpch_sf1.run_all", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA" in res.stderr


def test_a_run_from_the_benchmark_alone_fails_and_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files
    (no program), a run fails and prints no result."""
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "bench/run.py", "--workload", "tpch_sf1.run_all",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0 and res.stdout == ""
