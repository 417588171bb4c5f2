"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on first use into its own shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and the shared header, so an
edited kernel is rebuilt and a stale one is never loaded.  Libraries go to
``_build/`` beside this file (listed in ``.gitignore``).  :func:`build_all`
starts one ``nvcc`` per source at once; a wrapper's first launch builds only
its own source.  ``ptxas -v``'s report (each kernel's registers and
spills) of every source built in this process is kept in :data:`LOGS`.
Libraries are loaded with :mod:`ctypes`; nothing here imports torch, so the
CPU tests can import every kernel module without a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("masked_stats", "segment_reduce", "topk", "filter_compact", "join_probe",
           "ssd_chunk", "ssd_bwd", "flash_attention")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

BUILD_DIR = Path(__file__).resolve().parent / "_build"

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
LOGS: Dict[str, str] = {}  # source name → nvcc's output (ptxas -v) when built here


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc on the GPU host")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start(name: str) -> subprocess.Popen:
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    proc.repro_paths = (tmp, out)  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    tmp, out = proc.repro_paths  # type: ignore[attr-defined]
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
    LOGS[name] = log.decode(errors="replace")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> List[str]:
    """Compile every missing library, one ``nvcc`` per source, all at once.
    Returns the names that were compiled."""
    with _LOCK:
        todo = [n for n in names if not library_path(n).exists()]
        procs = [(n, _start(n)) for n in todo]
        errors = []
        for n, p in procs:
            try:
                _finish(n, p)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
        return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
    return lib
