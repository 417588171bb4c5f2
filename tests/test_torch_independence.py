"""The PyTorch port stands alone: ``repro_torch``, ``chip_smoke.py``,
``tools/ssd_scan_variants.py`` and ``examples/torch_*.py`` import neither
JAX nor the JAX package,
``repro_torch`` keeps the reference's module layout, and the smoke script
refuses to run without the package or a CUDA card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"


def _absolute_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py", "tools/ssd_scan_variants.py"]
    + sorted(str(p.relative_to(ROOT)) for p in (ROOT / "examples").glob("torch_*.py")),
)
def test_no_jax_or_reference_import(path):
    bad = [m for m in _absolute_imports(ROOT / path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_and_reference_out_of_sys_modules():
    code = (
        "import sys\n"
        "import repro_torch.frame, repro_torch.kernels.ops, repro_torch.frame.convert\n"
        "import repro_torch.models, repro_torch.serve, repro_torch.configs\n"
        "import repro_torch.serve.multitenant\n"
        "import repro_torch.models.convert\n"
        "import repro_torch.train, repro_torch.ckpt, repro_torch.data\n"
        "import repro_torch.launch.train, repro_torch.launch.serve\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_layout_mirrors_reference():
    """Every ported module keeps its reference module's path and name."""
    for sub in ("core", "frame", "kernels", "models", "serve", "configs", "train", "ckpt",
                "data", "launch"):
        for p in (PORT / sub).glob("*.py"):
            if p.name in ("convert.py", "_build.py", "_launch.py"):
                continue  # port-only modules
            if sub == "launch" and p.name == "__init__.py":
                continue  # the reference's launch/ is a namespace package
            assert (REF / sub / p.name).exists(), f"{sub}/{p.name} has no counterpart"
    for name in ("quickstart", "interactive_session", "serve_opportunistic", "train_lm"):
        assert (ROOT / "examples" / f"torch_{name}.py").exists(), f"examples/{name}.py"
    for name in ("masked_stats", "segment_reduce", "topk", "filter_compact", "join_probe",
                 "ssd_chunk", "flash_attention"):
        assert (PORT / "kernels" / "csrc" / f"{name}.cu").exists()


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """In a directory holding only chip_smoke.py (and on a host without a
    card) the script exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
