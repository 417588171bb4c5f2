"""Fault-tolerant checkpointing: async, atomic, keep-k, restore onto any
device — in the reference's on-disk format, so that a checkpoint written by
either package restores in the other.

Layout:
    <dir>/step_000123/           (atomic: written as .tmp_step_000123, renamed)
        manifest.json            {step, leaves: [{key, file, shape, dtype}]}
        arr_00000.npy ...        one file per leaf
    <dir>/LATEST                 text file with the newest complete step

Leaves are the tree's tensors in JAX's flattening order (dict keys sorted at
every level), each keyed as ``jax.tree_util.keystr`` writes its path
(``['params']['embed']['tok']``).

* **async**: ``save_async`` copies every leaf to host memory on the caller's
  thread and writes files on a daemon thread, so the train loop never blocks
  on disk.
* **atomic**: the directory is renamed into place only after every leaf and
  the fsync'd manifest are written; a crash mid-write leaves only a .tmp dir,
  which restore ignores and the next save removes.
* **restore**: leaves are loaded as host arrays and placed on ``device``
  (default: the device of each template leaf).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.base import keystr, tree_flatten, tree_unflatten


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf``: the train step updates the tensors in place
    while an async save is still writing."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
    return np.array(leaf)


def _leaf_paths(tree) -> List[Tuple[str, object]]:
    return [(keystr(path), leaf) for path, leaf in tree_flatten(tree)]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save --
    def save(self, step: int, tree) -> str:
        """Synchronous save (used by tests and at shutdown)."""
        return self._write(step, [(k, _host(v)) for k, v in _leaf_paths(tree)])

    def save_async(self, step: int, tree) -> None:
        self.wait()  # one in-flight save at a time
        host = [(k, _host(v)) for k, v in _leaf_paths(tree)]

        def work():
            try:
                self._write(step, host)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host: List[Tuple[str, np.ndarray]]) -> str:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, f".tmp_{name}")
        final = os.path.join(self.dir, name)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (key, arr) in enumerate(host):
            fname = f"arr_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"key": key, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, "LATEST"), "w") as f:
            f.write(name)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.dir) if d.startswith("step_"))
        for d in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
        for d in os.listdir(self.dir):
            if d.startswith(".tmp_"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # --------------------------------------------------------------- restore --
    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.dir, "LATEST")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.dir, name, "manifest.json")):
            return None
        return int(name.split("_")[1])

    def restore(self, template, step: Optional[int] = None, device=None):
        """Restore into the structure of ``template`` (a nested dict of
        tensors): each leaf as a tensor on ``device``, or on its template
        leaf's device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {entry["key"]: entry for entry in manifest["leaves"]}
        flat = tree_flatten(template)
        leaves = []
        for path, tmpl in flat:
            key = keystr(path)
            arr = np.load(os.path.join(d, by_key[key]["file"]))
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"checkpoint leaf {key} shape {arr.shape} != expected "
                                 f"{tuple(tmpl.shape)}")
            dev = device if device is not None else getattr(tmpl, "device", "cpu")
            leaves.append(torch.from_numpy(arr).to(dev))
        return tree_unflatten([p for p, _ in flat], leaves)
