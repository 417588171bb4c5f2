"""Shared plumbing of the kernel wrappers: launch counters, argument checks,
and the error check after every launch."""
from __future__ import annotations

import ctypes
import threading

import torch

P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int
F32 = ctypes.c_float
U64 = ctypes.c_ulonglong


class LaunchCounter:
    """Thread-safe count of kernel launches: the real-mode background worker
    launches concurrently with foreground interactions."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def bind(lib: ctypes.CDLL, fn: str, argtypes) -> ctypes._CFuncPtr:
    f = getattr(lib, fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(device: torch.device) -> int:
    """The current stream's ``cudaStream_t`` on ``device``, as an integer.
    ``torch.cuda.current_stream(device).cuda_stream`` builds a Stream object
    to read it, several microseconds of host time a launch; this reads the
    handle alone (the call PyTorch's own generated kernels make)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def on_device(device: torch.device):
    """``device`` as the calling thread's current CUDA device around a
    launch: a kernel launched into another card's stream fails, and the C
    entry points size and configure their kernels (``cudaGetDevice``,
    ``cudaFuncSetAttribute``) on the current device."""
    return torch.cuda.device(device)


def require(t: torch.Tensor, name: str, dtype=None, ndim=None, device=None) -> None:
    """Raise on anything the kernel does not take: wrong dtype, rank,
    device, or a non-contiguous layout."""
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
