"""Prefetching data loader: a background thread keeps a bounded queue of
host batches ready so the accelerator never waits on data (compute/IO
overlap — the data-pipeline analogue of the paper's think-time principle:
useful work during the gaps).

Given a ``device``, each batch of numpy arrays comes out as torch tensors on
that device (copied as it is taken from the queue); without one, batches
pass through as they are, or through ``device_put`` when that is given.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays → torch tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


class PrefetchLoader:
    def __init__(
        self,
        it: Iterator[Dict[str, np.ndarray]],
        depth: int = 2,
        device_put: Optional[Callable[[Dict[str, np.ndarray]], Any]] = None,
        device=None,
    ):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        if device_put is None:
            device_put = (lambda b: b) if device is None else (lambda b: to_device(b, device))
        self._device_put = device_put
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                self._q.put(batch)
        except BaseException as e:
            self._err = e
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return self._device_put(item)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
