"""Pluggable columnar kernel backend for the frame layer.

The blocking operators in :mod:`repro_torch.frame.blocking` are written as
scalar numpy partial/combine pairs.  This module is the dispatch seam that
routes the same partial computations to :mod:`repro_torch.kernels.ops`:

========================  =============================================
frame partial             kernel
========================  =============================================
``partial_stats``         ``masked_stats`` (batched over columns)
``partial_groupby``       ``segment_reduce`` (dictionary-coded keys)
``partial_value_counts``  ``segment_reduce`` (counts only)
``partial_sort(limit=k)`` ``topk`` (threshold + small residual argsort)
``partial_sort`` (full)   ``argsort_f64`` (native f64 stable sort)
``merge_sort`` (full)     sample-sort range split + ``argsort_f64``
``select_rows``           ``filter_compact`` (every column, any dtype)
``join_partition``        ``join_probe`` (native numeric keys)
========================  =============================================

Backend selection is per-call via a policy chain, strongest first:

1. explicit ``backend=`` argument,
2. a process-global override (``set_frame_backend`` / ``use_backend``),
3. the ``REPRO_TORCH_FRAME_BACKEND`` environment variable,
4. the engine's configured default (``Engine(kernel_backend=...)``),
5. ``"cuda"``.

``"numpy"`` is the scalar host path, ``"torch"`` the plain PyTorch versions
on the caller's ``device`` (the CUDA device unless asked), and ``"cuda"`` the
hand-written kernels on the CUDA device.  The device is per call: the frame
runtime passes its session's device to every entry point.  Every accelerated function falls
back to the numpy implementation for shapes it cannot handle (string sort
keys, callable aggs, empty partitions, non-dictionary group keys).

Host data stays numpy; each Column caches its device copies (keyed by
device), and results come back with ``.cpu().numpy()``.  The accelerated
backends accumulate in float32; the numpy path uses float64.  Parity is to
~1e-4 relative, which the parity tests pin down.
"""
from __future__ import annotations

import logging
import math
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import faults as _faults
from ..kernels import ops
from ..kernels.segment_reduce import MAX_BUCKETS
from . import blocking as B
from .blocking import BUILTIN_AGGS, ColStats
from .table import Column, Partition, PTable

logger = logging.getLogger("repro_torch.frame.backend")

BACKENDS = ("numpy", "torch", "cuda")
ENV_VAR = "REPRO_TORCH_FRAME_BACKEND"
DEFAULT_BACKEND = "cuda"

_GLOBAL: Optional[str] = None


def _check(name: str) -> str:
    if name not in BACKENDS:
        raise ValueError(f"unknown frame backend {name!r}; expected one of {BACKENDS}")
    return name


def set_frame_backend(name: Optional[str]) -> None:
    """Process-global backend override (None = clear)."""
    global _GLOBAL
    _GLOBAL = _check(name) if name is not None else None


@contextmanager
def use_backend(name: Optional[str]):
    """Scoped backend override (tests / benchmarks)."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = _check(name) if name is not None else None
    try:
        yield
    finally:
        _GLOBAL = prev


def device_of(bk: str, device=None) -> torch.device:
    """The device a dispatch runs on: ``cuda`` on the CUDA device, ``torch``
    on the caller's device, which is the CUDA device unless asked."""
    if bk == "cuda" or device is None:
        return torch.device("cuda")
    return torch.device(device)


def require_device(bk: str, device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU: a
    ``cuda`` backend, or ``torch`` on a CUDA device, raises when no CUDA
    device is present instead of running on the CPU quietly.  Returns the
    device the caller's dispatches run on."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if bk == "numpy":
        return dev
    if bk == "cuda" and dev.type != "cuda":
        raise ValueError(f"kernel_backend='cuda' runs on a CUDA device, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"kernel_backend={bk!r} needs a CUDA device and none is available; "
            "pass kernel_backend='numpy', or kernel_backend='torch' with "
            "device='cpu', to run on the CPU"
        )
    return dev


@dataclass
class BackendPolicy:
    """Per-engine backend resolution (engine config is the weakest override)."""

    engine_default: Optional[str] = None

    def resolve(self, override: Optional[str] = None) -> str:
        return self.resolve_tier(override)[0]

    def resolve_tier(self, override: Optional[str] = None) -> Tuple[str, str]:
        """``resolve()`` plus WHICH precedence tier answered.  The planner
        (``frame/planner.py``) only governs the ``"engine"`` and
        ``"default"`` tiers; a stronger override bypasses it."""
        for cand, tier in (
            (override, "call"),
            (_GLOBAL, "global"),
            (os.environ.get(ENV_VAR), "env"),
            (self.engine_default, "engine"),
        ):
            if cand:
                return _check(cand), tier
        return DEFAULT_BACKEND, "default"


_DEFAULT_POLICY = BackendPolicy()


def active_backend(override: Optional[str] = None) -> str:
    return _DEFAULT_POLICY.resolve(override)


def _kernel(backend: str):
    """Route kernels.ops dispatch to the requested backend (thread-local:
    the real-mode background worker runs units concurrently)."""
    return ops.local_backend(backend)


# --------------------------------------------------------------------------- #
# runtime fault tolerance: per-(op, backend) circuit breakers                  #
#                                                                              #
# The eligibility gates in this module are *ahead-of-time*.  Kernels can also  #
# fail at RUN time.  Every kernel call goes through _guarded(): a contained    #
# failure falls back to the numpy reference for THAT dispatch, and repeated    #
# failures trip a circuit breaker so subsequent dispatches skip the kernel     #
# until a half-open probe proves it healthy again.  On a CUDA device only      #
# injected chaos faults (``core.faults``) are contained: any other error (a    #
# failed build or launch, out of memory, a wrapper bug) raises to the caller   #
# and scores no breaker, so nothing runs on the host quietly while its inputs  #
# are on the card.  On the CPU every runtime error is contained.               #
# ``breaker_board().snapshot()`` shows every failure and fallback, so a run    #
# can prove no kernel hid behind numpy.                                        #
# --------------------------------------------------------------------------- #


@dataclass
class _BreakerState:
    state: str = "closed"  # "closed" | "open" | "half_open"
    consecutive_failures: int = 0
    opened_at: float = 0.0
    open_count: int = 0  # times tripped (drives the exponential backoff)
    failures: int = 0
    successes: int = 0
    fallbacks: int = 0  # dispatches served by numpy while not closed
    last_error: str = ""


class BreakerBoard:
    """Thread-safe registry of per-(op, backend) circuit breakers."""

    def __init__(
        self,
        failure_threshold: int = 3,
        backoff_s: float = 5.0,
        backoff_max_s: float = 300.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.clock = clock
        self._lock = threading.Lock()
        self._states: Dict[Tuple[str, str], _BreakerState] = {}

    def _state(self, op: str, bk: str) -> _BreakerState:
        st = self._states.get((op, bk))
        if st is None:
            st = self._states[(op, bk)] = _BreakerState()
        return st

    def _backoff(self, st: _BreakerState) -> float:
        return min(self.backoff_s * (2 ** max(st.open_count - 1, 0)), self.backoff_max_s)

    def allow(self, op: str, bk: str) -> bool:
        """May this dispatch try the kernel?  An open breaker whose backoff
        has elapsed transitions to half-open and admits exactly this call as
        the recovery probe."""
        with self._lock:
            st = self._state(op, bk)
            if st.state == "closed":
                return True
            if st.state == "open" and (
                self.clock() - st.opened_at >= self._backoff(st)
            ):
                st.state = "half_open"
                return True  # this dispatch is the probe
            st.fallbacks += 1
            return False

    def record_success(self, op: str, bk: str) -> None:
        with self._lock:
            st = self._state(op, bk)
            if st.state == "half_open":
                logger.info("breaker (%s, %s) closed: probe succeeded", op, bk)
            st.state = "closed"
            st.consecutive_failures = 0
            st.successes += 1

    def record_failure(self, op: str, bk: str, error: str = "") -> None:
        with self._lock:
            st = self._state(op, bk)
            st.failures += 1
            st.consecutive_failures += 1
            st.last_error = error[:200]
            if st.state == "half_open" or (
                st.state == "closed"
                and st.consecutive_failures >= self.failure_threshold
            ):
                st.state = "open"
                st.opened_at = self.clock()
                st.open_count += 1
                logger.warning(
                    "breaker (%s, %s) OPEN after %d consecutive failure(s); "
                    "numpy fallback for %.1fs (%s)",
                    op, bk, st.consecutive_failures, self._backoff(st), error,
                )

    def is_closed(self, op: str, bk: str) -> bool:
        """Read-only planning gate (no probe grant, no fallback counting)."""
        with self._lock:
            return self._state(op, bk).state == "closed"

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {
                f"{op}|{bk}": {
                    "state": st.state,
                    "failures": st.failures,
                    "successes": st.successes,
                    "fallbacks": st.fallbacks,
                    "open_count": st.open_count,
                    "last_error": st.last_error,
                }
                for (op, bk), st in sorted(self._states.items())
            }

    def reset(self) -> None:
        with self._lock:
            self._states.clear()


_BOARD = BreakerBoard()


def breaker_board() -> BreakerBoard:
    return _BOARD


def reset_breakers() -> None:
    """Clear all breaker state (tests / between benchmark phases)."""
    _BOARD.reset()


# the backend that actually served the current unit's dispatch — consumed by
# the frame runtime so calibration samples attribute time to the path that
# really ran, not the one requested
_SERVED = threading.local()


def note_reset() -> None:
    _SERVED.backend = None
    _SERVED.reason = None


def served_backend(default: str) -> Tuple[str, Optional[str]]:
    """(backend that served the last guarded dispatch, fallback reason)."""
    return (
        getattr(_SERVED, "backend", None) or default,
        getattr(_SERVED, "reason", None),
    )


def _note(bk: str, reason: Optional[str]) -> None:
    _SERVED.backend = bk
    _SERVED.reason = reason


def _contained(exc: BaseException, dev: torch.device) -> bool:
    """May this dispatch error fall back to numpy?  On a CUDA device only an
    injected chaos fault; on the CPU any runtime error."""
    return isinstance(exc, _faults.InjectedFault) or dev.type != "cuda"


def _guarded(op: str, bk: str, dev: torch.device, kernel_fn: Callable[[], Any],
             fallback_fn: Callable[[], Any]) -> Any:
    """Runtime dispatch guard: breaker gate → fault injection → kernel call.
    A contained exception (see :func:`_contained`) is absorbed into a numpy
    fallback for this dispatch and scored against the (op, backend) breaker;
    any other raises.  On the card a breaker opens only on injected faults,
    so its numpy fallback serves only the chaos feature."""
    if not _BOARD.allow(op, bk):
        _note("numpy", "breaker_open")
        return fallback_fn()
    try:
        mode = _faults.fire("kernel", op=op)  # chaos: may raise / sleep
        if mode == "corrupt":
            raise _faults.InjectedFault(f"corrupted kernel output at {op}")
        out = kernel_fn()
    except Exception as exc:
        if not _contained(exc, dev):
            raise
        _BOARD.record_failure(op, bk, error=f"{type(exc).__name__}: {exc}")
        _note("numpy", "runtime_error")
        logger.warning(
            "kernel dispatch (%s, %s) failed at run time (%s: %s); "
            "numpy fallback for this dispatch",
            op, bk, type(exc).__name__, exc,
        )
        return fallback_fn()
    _BOARD.record_success(op, bk)
    _note(bk, None)
    return out


@contextmanager
def _breaker_watch(op: str, bk: str, dev: torch.device):
    """Batched dispatches don't fall back per-call (the whole batch raises to
    the executor, whose fault boundary quarantines the node) — but their
    contained failures (see :func:`_contained`) still score the breaker.
    Fires the kernel chaos site on entry, like _guarded."""
    try:
        mode = _faults.fire("kernel", op=op)
        if mode == "corrupt":
            raise _faults.InjectedFault(f"corrupted kernel output at {op}")
        yield
    except Exception as exc:
        if _contained(exc, dev):
            _BOARD.record_failure(op, bk, error=f"{type(exc).__name__}: {exc}")
        raise
    else:
        _BOARD.record_success(op, bk)


# --------------------------------------------------------------------------- #
# device-resident column cache                                                 #
#                                                                              #
# Columns are immutable by construction (every frame op builds new Columns),   #
# so each device copy a kernel consumes is made once and stashed on the        #
# Column instance, keyed by kind and device.  Columns live device-resident     #
# between think-time quanta.  Compaction stores its device output on the new   #
# Column too, so a filtered partition never goes back up to the device.        #
# --------------------------------------------------------------------------- #


def device_key(dev) -> str:
    """The cache key of a device: an index-less ``cuda`` names the current
    card, so a session's ``cuda`` and a data mesh's ``cuda:0`` share one
    copy of a column on one card (a host with no card counts as card 0)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return str(dev)


def _cached(obj, key: str, make: Callable[[], Any]):
    val = obj.__dict__.get(key)
    if val is None:
        val = make()
        obj.__dict__[key] = val
    return val


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _dev_native(col: Column, dev: torch.device) -> torch.Tensor:
    """The column's data in its own dtype (what compaction moves)."""
    return _cached(col, f"_dev_native@{device_key(dev)}", lambda: _upload(col.data, dev))


def _dev_mask(col: Column, dev: torch.device) -> torch.Tensor:
    """The column's explicit mask (callers check ``col.mask is not None``)."""
    return _cached(col, f"_dev_mask@{device_key(dev)}", lambda: _upload(col.mask, dev))


def _dev_f32(col: Column, dev: torch.device) -> torch.Tensor:
    """f32 values, converted on the device from the native copy (float64 →
    float32 rounds to nearest on both host and device: the same bits)."""
    return _cached(
        col, f"_dev_f32@{device_key(dev)}",
        lambda: _dev_native(col, dev).to(torch.float32).contiguous(),
    )


def _dev_i32(col: Column, dev: torch.device) -> torch.Tensor:
    return _cached(
        col, f"_dev_i32@{device_key(dev)}",
        lambda: _dev_native(col, dev).to(torch.int32).contiguous(),
    )


def _dev_valid(col: Column, dev: torch.device) -> torch.Tensor:
    if col.mask is not None:
        return _dev_mask(col, dev)
    return _cached(
        col, f"_dev_valid@{device_key(dev)}",
        lambda: torch.ones(col.nrows, dtype=torch.bool, device=dev),
    )


def _compactable(col: Column) -> bool:
    """Compaction moves 1-, 4- and 8-byte elements; other widths (and object
    arrays) select on the host."""
    return col.data.dtype.kind in "biuf" and col.data.dtype.itemsize in (1, 4, 8)


# --------------------------------------------------------------------------- #
# describe / mean — masked_stats                                               #
# --------------------------------------------------------------------------- #


def _dev_stats_stack(part: Partition, names: Sequence[str], dev: torch.device):
    """The stacked + shape-bucketed (C, nb) value/validity matrices, cached
    per partition so steady-state describe partials skip all host work."""
    key = tuple(names)
    slot = f"_dev_stats@{device_key(dev)}"
    cached = part.__dict__.get(slot)
    if cached is None or cached[0] != key:
        nb = ops.pad_len(part.nrows)
        xs = torch.zeros((len(names), nb), dtype=torch.float32, device=dev)
        ms = torch.zeros((len(names), nb), dtype=torch.bool, device=dev)
        for i, n in enumerate(names):
            xs[i, : part.nrows] = _dev_f32(part.columns[n], dev)
            ms[i, : part.nrows] = _dev_valid(part.columns[n], dev)
        cached = (key, xs, ms)
        part.__dict__[slot] = cached
    return cached[1], cached[2]


def warm_device_cache(table, device=None) -> None:
    """Make every device copy the partial functions read, for every
    partition of ``table`` (production preloading: think-time partials then
    skip every host→device copy of a column).  Per column: the native copy
    (compaction, sort and probe keys derive from it) and the mask; the
    float32 values of a numeric column (stats, groupby values); the int32
    codes of a dictionary column (groupby keys, value_counts); its validity.
    Then each partition's stacked describe matrices.  ``device`` is the
    card unless the caller passes ``"cpu"``; without a card that raises."""
    dev = require_device("cuda" if device is None else "torch", device)
    for part in table.partitions:
        for name in part.order:
            c = part.columns[name]
            if c.data.dtype.kind not in "biuf":
                continue  # object columns never leave the host
            _dev_native(c, dev)
            if c.is_string:
                _dev_i32(c, dev)
            else:
                _dev_f32(c, dev)
            _dev_valid(c, dev)
        numeric = B.numeric_columns(part)
        if numeric and part.nrows:
            _dev_stats_stack(part, numeric, dev)


def _stats_from_raw(names: Sequence[str], raw: np.ndarray) -> Dict[str, ColStats]:
    """(C, 5) kernel rows of (count, sum, m2, min, max) → per-column
    ColStats — the shared host postprocessing of the batched and unbatched
    paths (bit-for-bit by construction)."""
    out: Dict[str, ColStats] = {}
    for i, name in enumerate(names):
        count, s, m2, mn, mx = raw[i]
        if count == 0:
            out[name] = ColStats(0.0, 0.0, 0.0, np.inf, -np.inf)
        else:
            mean = s / count
            out[name] = ColStats(
                float(count), float(mean), float(max(m2, 0.0)), float(mn), float(mx)
            )
    return out


def partial_stats(
    part: Partition,
    cols: Optional[Sequence[str]] = None,
    backend: Optional[str] = None,
    device=None,
) -> Dict[str, ColStats]:
    bk = active_backend(backend)
    dev = device_of(bk, device)
    names = list(cols) if cols is not None else B.numeric_columns(part)
    if bk == "numpy" or not names or part.nrows == 0:
        return B.partial_stats(part, cols)

    def _run():
        xs, ms = _dev_stats_stack(part, names, dev)
        with _kernel(bk):
            raw = _host(ops.masked_stats_batch(xs, ms)).astype(np.float64)
        return _stats_from_raw(names, raw)

    return _guarded("stats", bk, dev, _run, lambda: B.partial_stats(part, cols))


# --------------------------------------------------------------------------- #
# groupby / value_counts — segment_reduce on dictionary codes                  #
# --------------------------------------------------------------------------- #

_SEG_MODE = {"sum": "sum", "count": "sum", "mean": "sum", "min": "min", "max": "max"}


def _groupby_supported(part: Partition, by: str, aggs, topk_keys) -> bool:
    key_col = part.columns.get(by)
    if key_col is None or key_col.dictionary is None:
        return False  # segment_reduce needs dense [0, nb) codes
    if topk_keys is not None or part.nrows == 0:
        return False
    for _, col, fn in aggs:
        if callable(fn) or fn not in BUILTIN_AGGS:
            return False
        if part.columns[col].is_string:
            return False
    return True


def _groupby_plan(part: Partition, by: str, aggs, dev, dedup_by_name: bool = False) -> tuple:
    """Assemble ONE batched kernel call for the whole agg set.  Validity rows
    are deduplicated (by the agg column's mask identity, or by column name
    for the fused path, whose filtered partition would hold one fresh mask
    per column) so unmasked columns share a single count row.  Returns
    (keys, values, valids, modes, valid_idx, agg_plan)."""
    key_col = part.columns[by]
    kvalid = _dev_valid(key_col, dev)
    values: list = []
    modes: list = []
    valid_idx: list = []
    valids: list = [kvalid]  # row 0: key presence
    valid_row_of: Dict[Any, int] = {}
    agg_plan: list = []  # (out_name, fn, value_row | None, valid_row)
    for out_name, col, fn in aggs:
        vcol = part.columns[col]
        if vcol.mask is None:
            vrow = 0
        else:
            key = col if dedup_by_name else id(vcol.mask)
            vrow = valid_row_of.get(key)
            if vrow is None:
                vrow = len(valids)
                valids.append(kvalid & _dev_valid(vcol, dev))
                valid_row_of[key] = vrow
        if fn == "count":
            agg_plan.append((out_name, fn, None, vrow))
            continue
        values.append(_dev_f32(vcol, dev))
        modes.append(_SEG_MODE[fn])
        valid_idx.append(vrow)
        agg_plan.append((out_name, fn, len(values) - 1, vrow))
    return _dev_i32(key_col, dev), values, valids, modes, valid_idx, agg_plan


def _groupby_from_raw(
    key_dtype, agg_plan, reds: np.ndarray, cnts: np.ndarray
) -> dict:
    """Kernel rows → the dense partial-groupby dict (shared by the batched and
    unbatched paths — bit-for-bit by construction)."""
    reds = np.asarray(reds, np.float64)
    cnts = np.asarray(cnts, np.float64)
    present = cnts[0] > 0
    dense: Dict[str, Tuple[str, Any]] = {}
    for out_name, fn, srow, vrow in agg_plan:
        if fn == "sum":
            dense[out_name] = ("sum", reds[srow][present])
        elif fn == "count":
            dense[out_name] = ("sum", cnts[vrow][present])
        elif fn == "mean":
            dense[out_name] = ("sum_count", (reds[srow][present], cnts[vrow][present]))
        else:  # min / max: empty (all-null) groups keep the ±inf neutral
            dense[out_name] = (fn, reds[srow][present])
    uniq = np.nonzero(present)[0].astype(key_dtype)
    return {"keys": uniq, "aggs": dense}


def partial_groupby(
    part: Partition,
    by: str,
    aggs: Sequence[Tuple[str, str, Any]],
    topk_keys: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> dict:
    bk = active_backend(backend)
    dev = device_of(bk, device)
    if bk == "numpy" or not _groupby_supported(part, by, aggs, topk_keys):
        return B.partial_groupby(part, by, aggs, topk_keys)
    key_col = part.columns[by]
    nb = len(key_col.dictionary)

    def _run():
        keys, values, valids, modes, valid_idx, agg_plan = _groupby_plan(
            part, by, aggs, dev
        )
        with _kernel(bk):
            reds, cnts = ops.segment_reduce_batch(
                keys, values, valids, nb, modes, valid_idx
            )
        return _groupby_from_raw(key_col.data.dtype, agg_plan, _host(reds), _host(cnts))

    return _guarded(
        "groupby", bk, dev, _run, lambda: B.partial_groupby(part, by, aggs, topk_keys)
    )


def _vc_supported(part: Partition, col: str) -> bool:
    c = part.columns[col]
    return c.dictionary is not None and part.nrows > 0


def _vc_from_raw(key_dtype, cnt_row: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    cnt = np.asarray(cnt_row)
    present = cnt > 0
    values = np.nonzero(present)[0].astype(key_dtype)
    return values, cnt[present].astype(np.int64)


def partial_value_counts(
    part: Partition, col: str, backend: Optional[str] = None, device=None
) -> Tuple[np.ndarray, np.ndarray]:
    bk = active_backend(backend)
    dev = device_of(bk, device)
    c = part.columns[col]
    if bk == "numpy" or not _vc_supported(part, col):
        return B.partial_value_counts(part, col)

    def _run():
        with _kernel(bk):
            _, cnts = ops.segment_reduce_batch(
                _dev_i32(c, dev), [], [_dev_valid(c, dev)], len(c.dictionary), [], []
            )
        return _vc_from_raw(c.data.dtype, _host(cnts)[0])

    return _guarded(
        "value_counts", bk, dev, _run, lambda: B.partial_value_counts(part, col)
    )


# --------------------------------------------------------------------------- #
# sort — full: native f64 stable sort; limit: topk threshold + residual sort  #
# --------------------------------------------------------------------------- #

TOPK_MAX_K = 128  # the topk kernel keeps at most 128 winners a row


def _sort_keys(key_col: Column, ascending: bool) -> np.ndarray:
    """f64 sort keys with the numpy reference's null handling (nulls last)."""
    keys = np.asarray(key_col.data, np.float64)
    if key_col.mask is not None:
        m = np.asarray(key_col.mask)
        keys = np.where(m, keys, np.inf if ascending else -np.inf)
    return keys


def _dev_sort_keys(key_col: Column, ascending: bool, dev: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """``_sort_keys`` on the device in ``dtype`` (float64 for a full sort,
    float32 for top-k), negated for a descending float64 sort: made from the
    column's cached native copy and mask (int → float64 → ``dtype`` rounds
    to nearest there as on the host: the same bits), so a warmed column
    sorts without an upload.  uint64 columns (no conversion on the card)
    upload their host keys."""
    if key_col.data.dtype == _U64:
        x = _upload(_sort_keys(key_col, ascending), dev)
    else:
        x = _dev_native(key_col, dev).to(torch.float64)
        if key_col.mask is not None:
            x = torch.where(_dev_mask(key_col, dev), x, math.inf if ascending else -math.inf)
    if dtype == torch.float64:
        return x if ascending else -x
    return x.to(dtype)


def partial_sort(
    part: Partition,
    by: str,
    ascending: bool,
    limit: Optional[int],
    n_samples: int = 32,
    backend: Optional[str] = None,
    device=None,
) -> Tuple[Partition, np.ndarray]:
    bk = active_backend(backend)
    dev = device_of(bk, device)
    key_col = part.columns.get(by)
    if bk == "numpy" or key_col is None or part.nrows == 0:
        return B.partial_sort(part, by, ascending, limit, n_samples)
    if limit is None:
        return _partial_sort_full(part, key_col, by, ascending, n_samples, bk, dev)
    return _partial_sort_limit(part, key_col, by, ascending, limit, n_samples, bk, dev)


def _sorted_result(
    part: Partition, keys: np.ndarray, idx: np.ndarray, n_samples: int
) -> Tuple[Partition, np.ndarray]:
    sorted_part = part.take(idx)
    skeys = keys[idx]
    if len(skeys) == 0:
        samples = np.array([])
    else:
        samples = skeys[
            np.linspace(0, len(skeys) - 1, min(n_samples, len(skeys))).astype(int)
        ]
    return sorted_part, samples


def _partial_sort_full(
    part: Partition,
    key_col: Column,
    by: str,
    ascending: bool,
    n_samples: int,
    bk: str,
    dev: torch.device,
) -> Tuple[Partition, np.ndarray]:
    """Full (non-limit) partition sort: one stable f64 device sort — bit-for-
    bit the numpy stable argsort, including null-last ordering and ties.
    Unmasked NaN keys have no total order to reproduce: numpy's path."""
    keys = _sort_keys(key_col, ascending)
    if np.isnan(keys).any():
        return B.partial_sort(part, by, ascending, None, n_samples)

    def _run():
        with _kernel(bk):
            order = _host(ops.argsort_f64(
                _dev_sort_keys(key_col, ascending, dev, torch.float64)))
        return _sorted_result(part, keys, order, n_samples)

    return _guarded(
        "sort", bk, dev, _run, lambda: B.partial_sort(part, by, ascending, None, n_samples)
    )


def _partial_sort_limit(
    part: Partition,
    key_col: Column,
    by: str,
    ascending: bool,
    limit: int,
    n_samples: int,
    bk: str,
    dev: torch.device,
) -> Tuple[Partition, np.ndarray]:
    if not (1 <= limit <= TOPK_MAX_K) or key_col.is_string or part.nrows <= limit:
        return B.partial_sort(part, by, ascending, limit, n_samples)
    keys = _sort_keys(key_col, ascending)
    if np.isnan(keys).any():
        # unmasked NaN keys would poison the threshold — numpy's argsort-
        # NaN-last semantics instead
        return B.partial_sort(part, by, ascending, limit, n_samples)
    kf32 = keys.astype(np.float32)

    def _run():
        with _kernel(bk):
            winners = _host(ops.topk_padded(
                _dev_sort_keys(key_col, ascending, dev, torch.float32), limit,
                largest=not ascending))
        return _limit_select(part, keys, kf32, winners, ascending, limit, n_samples)

    return _guarded(
        "topk", bk, dev, _run, lambda: B.partial_sort(part, by, ascending, limit, n_samples)
    )


def _limit_select(
    part: Partition,
    keys: np.ndarray,
    kf32: np.ndarray,
    winners: np.ndarray,
    ascending: bool,
    limit: int,
    n_samples: int,
) -> Tuple[Partition, np.ndarray]:
    """Winner values → final limit-sort result — the shared host step of the
    batched and unbatched limit paths.  Threshold in f32 space: rounding is
    monotone, so rows whose f32 key beats the f32 k-th winner are a superset
    of the true top-k (ties included)."""
    kth = winners[-1]
    cand = np.nonzero(kf32 <= kth if ascending else kf32 >= kth)[0]
    order_local = np.argsort(keys[cand] if ascending else -keys[cand], kind="stable")
    idx = cand[order_local][:limit]
    return _sorted_result(part, keys, idx, n_samples)


def merge_sort(
    partials: Sequence[Tuple[Partition, np.ndarray]],
    by: str,
    ascending: bool,
    limit: Optional[int],
    backend: Optional[str] = None,
    device=None,
) -> "PTable":
    """Combine step of a full sort as a *sample sort* (paper §5.1): pick
    pivots from the partials' key samples, range-split every (already sorted)
    partition with one vectorised ``searchsorted``, then order each range with
    the same stable device argsort.  Ranges partition rows purely by key
    value, so equal keys never straddle a boundary and stable in-range sorting
    reproduces the global stable merge bit-for-bit.

    Falls back to the numpy merge for limit-sorts (tiny inputs), ≤1 non-empty
    partial, or NaN keys."""
    bk = active_backend(backend)
    dev = device_of(bk, device)
    if bk == "numpy" or limit is not None:
        return B.merge_sort(partials, by, ascending, limit)
    parts = [p for p, _ in partials if p.nrows > 0]
    if len(parts) <= 1:
        return B.merge_sort(partials, by, ascending, limit)
    keys: List[np.ndarray] = []
    for p in parts:
        k = _sort_keys(p.columns[by], ascending)
        if np.isnan(k).any():
            return B.merge_sort(partials, by, ascending, limit)
        keys.append(k if ascending else -k)  # sign-adjusted: each ascending
    samples = [np.asarray(s, np.float64) for _, s in partials if len(s)]
    if not samples:
        return B.merge_sort(partials, by, ascending, limit)
    sall = np.sort(np.concatenate(samples) if ascending else -np.concatenate(samples))
    nparts = len(parts)
    pivots = sall[np.linspace(0, len(sall) - 1, nparts + 1).astype(int)[1:-1]]
    splits = [np.searchsorted(k, pivots, side="left") for k in keys]

    def _run():
        out_parts: List[Partition] = []
        for r in range(nparts):
            slices: List[Partition] = []
            skeys: List[np.ndarray] = []
            for p, k, sp in zip(parts, keys, splits):
                a = int(sp[r - 1]) if r > 0 else 0
                b = int(sp[r]) if r < nparts - 1 else p.nrows
                if b > a:
                    slices.append(p.slice(a, b))
                    skeys.append(k[a:b])
            if not slices:
                continue
            chunk = PTable(slices).concat()
            with _kernel(bk):
                order = _host(ops.argsort_f64(_upload(np.concatenate(skeys), dev)))
            out_parts.append(chunk.take(order))
        return PTable(out_parts or [parts[0].slice(0, 0)])

    return _guarded(
        "merge_sort", bk, dev, _run, lambda: B.merge_sort(partials, by, ascending, limit)
    )


# --------------------------------------------------------------------------- #
# join — sorted right side built once, device-resident; join_probe kernel      #
# --------------------------------------------------------------------------- #

_PROBE_TORCH = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
}
_U64 = np.dtype(np.uint64)


def _probe_dtype(left: np.dtype, right: np.dtype) -> Optional[np.dtype]:
    """The one key type both sides are compared in: numpy's promotion of the
    two (what the numpy reference compares in), widened to float32,
    float64, int32, int64 or uint64; ``None`` for non-numeric keys."""
    if left.kind not in "biuf" or right.kind not in "biuf":
        return None
    dt = np.result_type(left, right)
    if dt.kind == "f":
        return np.dtype(np.float32 if dt == np.float32 else np.float64)
    if dt == _U64:
        return _U64
    small = dt.itemsize <= 2 or (dt.kind != "u" and dt.itemsize == 4)
    return np.dtype(np.int32 if small else np.int64)


def _probe_host(keys: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Host keys in the kernel's type.  uint64 keys become int64 with the
    sign bit flipped, a map that keeps their order and equality."""
    if dtype == _U64:
        return (keys.astype(_U64) ^ np.uint64(1 << 63)).view(np.int64)
    return keys.astype(dtype)


def _join_build_cached(right: "PTable", on: str, dtype: np.dtype, dev: torch.device):
    """Build phase, cached on the (immutable) right PTable: merge + sort +
    uniqueness check once per ``on``, and the sorted keys' device copy once
    per (``on``, key type, device), resident across every left partition
    and every think-time re-probe."""
    cache = right.__dict__.setdefault("_join_build", {})
    host = cache.get(on)
    if host is None:
        host = cache[on] = B.join_build(right, on)
    key = (on, dtype.str, device_key(dev))
    r_dev = cache.get(key)
    if r_dev is None and len(host[1]):
        r_dev = cache[key] = _upload(_probe_host(host[1], dtype), dev)
    return (*host, r_dev)


def _dev_probe_keys(col: Column, dtype: np.dtype, dev: torch.device) -> torch.Tensor:
    if dtype == _U64:
        make = lambda: _upload(_probe_host(col.data, dtype), dev)  # noqa: E731
    else:
        make = lambda: _dev_native(col, dev).to(_PROBE_TORCH[dtype]).contiguous()  # noqa: E731
    return _cached(col, f"_dev_probe_{dtype.str}@{device_key(dev)}", make)


def join_partition(
    left: Partition,
    right: "PTable",
    on: str,
    how: str = "inner",
    backend: Optional[str] = None,
    device=None,
) -> Partition:
    """Broadcast join of one left partition: the ``join_probe`` kernel finds
    each left key in the right side's sorted keys on the device; only
    ``pos`` and ``hit`` come back, and the rows are assembled on the host
    (``blocking.join_assemble``).  String keys, and ``how`` other than inner
    or left, run the numpy reference."""
    bk = active_backend(backend)
    dev = device_of(bk, device)
    lcol = left.columns.get(on)
    rcol = right.partitions[0].columns.get(on) if right.partitions else None
    dtype = (
        _probe_dtype(lcol.data.dtype, rcol.data.dtype)
        if lcol is not None and rcol is not None
        and not lcol.is_string and not rcol.is_string
        else None
    )
    eligible = how in ("inner", "left") and dtype is not None and left.nrows > 0
    if eligible and sharded_available(dev):
        # the sharded build is size/mode-gated, not backend-gated: a right
        # side too big to broadcast takes the partition-parallel path even
        # when the planner demoted the *probe* to numpy (the broadcast build
        # is exactly the cost being avoided)
        sharded = _sharded_join_build_cached(right, on, dtype)
        if sharded is not None:
            from . import dist

            rmerged_s, sb = sharded

            def _run_sharded():
                l_keys = [_dev_probe_keys(lcol, dtype, d) for d in sb.mesh]
                gather, hit = dist.join_probe(sb, l_keys, _mesh_kernel(bk))
                if lcol.mask is not None:
                    hit = hit & np.asarray(lcol.mask)  # null left keys never match
                return B.join_assemble(left, rmerged_s, gather, hit, how, on)

            out = _guarded("join", "sharded", sb.mesh[0], _run_sharded, lambda: None)
            if out is not None:
                return out
    if bk == "numpy" or not eligible:
        return B.join_partition(left, right, on, how)

    def _run():
        rmerged, r_sorted, r_order, r_dev = _join_build_cached(right, on, dtype, dev)
        if len(r_sorted) == 0:
            hit = np.zeros(left.nrows, dtype=bool)
            gather = np.zeros(left.nrows, dtype=np.intp)
        else:
            with _kernel(bk):
                pos, hit_dev = ops.join_probe_padded(r_dev, _dev_probe_keys(lcol, dtype, dev))
            hit = _host(hit_dev)
            gather = r_order[_host(pos)]
        if lcol.mask is not None:
            hit = hit & np.asarray(lcol.mask)  # null left keys never match
        return B.join_assemble(left, rmerged, gather, hit, how, on)

    return _guarded(
        "join", bk, dev, _run, lambda: B.join_partition(left, right, on, how)
    )


# --------------------------------------------------------------------------- #
# predicate compaction — filter_compact                                        #
# --------------------------------------------------------------------------- #


def _new_column(data_dev, mask_dev, like: Column, count: int, dev) -> Column:
    """A compacted Column: host copies for the numpy world, and the device
    copies kept in its cache so later kernels skip the upload."""
    data = data_dev[:count]
    mask = None if mask_dev is None else mask_dev[:count]
    col = Column(
        data=_host(data), mask=None if mask is None else _host(mask),
        dictionary=like.dictionary,
    )
    col.__dict__[f"_dev_native@{device_key(dev)}"] = data
    if mask is not None:
        col.__dict__[f"_dev_mask@{device_key(dev)}"] = mask
    return col


def select_rows(
    part: Partition, keep: np.ndarray, backend: Optional[str] = None,
    device=None,
) -> Partition:
    """Row selection by a boolean mask: every column (data and mask, any
    1/4/8-byte dtype) compacts on the device, bit for bit."""
    bk = active_backend(backend)
    dev = device_of(bk, device)
    keep = np.asarray(keep, bool)
    if bk == "numpy" or part.nrows == 0:
        return part.select_rows(keep)

    def _run():
        count = int(keep.sum())
        keep_dev = _upload(keep, dev)
        new_cols: Dict[str, Column] = {}
        with _kernel(bk):
            for name in part.order:
                c = part.columns[name]
                if not _compactable(c):
                    new_cols[name] = c.select(keep)
                    continue
                data, _ = ops.filter_compact_padded(_dev_native(c, dev), keep_dev)
                mask = None
                if c.mask is not None:
                    mask, _ = ops.filter_compact_padded(_dev_mask(c, dev), keep_dev, False)
                new_cols[name] = _new_column(data, mask, c, count, dev)
        return Partition(new_cols, list(part.order))

    return _guarded("filter", bk, dev, _run, lambda: part.select_rows(keep))


# --------------------------------------------------------------------------- #
# fused multi-partition batch plans                                            #
#                                                                              #
# Each planner inspects a group of partitions (same shape bucket — the caller  #
# groups by `ops.pad_len`) and returns a two-phase ``(dispatch, finalize)``    #
# pair for the executor's UnitBatch, or ``None`` when any partition falls      #
# outside the kernel envelope.  ``dispatch()`` launches the kernels for the    #
# whole group and returns device tensors without waiting; ``finalize(handle)`` #
# pulls results to host and reuses the *same* postprocessing helpers as the    #
# unbatched paths — batched results are bit-for-bit identical.                 #
# --------------------------------------------------------------------------- #

BatchPlan = Tuple[Any, Any]  # (dispatch: () -> handle, finalize: handle -> list)


def shape_bucket(part: Partition) -> int:
    """The shape bucket a partition pads to (runtime groups batches by it)."""
    return ops.pad_len(part.nrows)


def _same_bucket(parts: Sequence[Partition]) -> bool:
    return len({ops.pad_len(p.nrows) for p in parts}) == 1


def plan_stats_batch(
    parts: Sequence[Partition],
    cols: Optional[Sequence[str]] = None,
    backend: Optional[str] = None,
    device=None,
) -> Optional[BatchPlan]:
    bk = active_backend(backend)
    dev = device_of(bk, device)
    if bk == "numpy" or not parts or not _same_bucket(parts):
        return None
    if not _BOARD.is_closed("stats", bk):
        return None  # units fall back one at a time through _guarded
    names = list(cols) if cols is not None else B.numeric_columns(parts[0])
    if not names:
        return None
    for p in parts:
        p_names = list(cols) if cols is not None else B.numeric_columns(p)
        if p_names != names or p.nrows == 0:
            return None
    C = len(names)

    def dispatch():
        with _breaker_watch("stats", bk, dev):
            stacks = [_dev_stats_stack(p, names, dev) for p in parts]
            with _kernel(bk):
                return ops.masked_stats_batch_parts(
                    [xs for xs, _ in stacks], [ms for _, ms in stacks]
                )

    def finalize(raw):
        raw = _host(raw).astype(np.float64)
        return [
            _stats_from_raw(names, raw[i * C:(i + 1) * C])
            for i in range(len(parts))
        ]

    return dispatch, finalize


def plan_groupby_batch(
    parts: Sequence[Partition],
    by: str,
    aggs: Sequence[Tuple[str, str, Any]],
    topk_keys: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> Optional[BatchPlan]:
    bk = active_backend(backend)
    dev = device_of(bk, device)
    if bk == "numpy" or not parts or not _same_bucket(parts):
        return None
    if not _BOARD.is_closed("groupby", bk):
        return None
    if any(not _groupby_supported(p, by, aggs, topk_keys) for p in parts):
        return None
    nb = len(parts[0].columns[by].dictionary)
    plans = [_groupby_plan(p, by, aggs, dev) for p in parts]
    _, _, valids0, modes0, vidx0, aplan0 = plans[0]
    for pl in plans[1:]:
        # one batch shares one (modes, valid_idx) plan: partitions whose mask
        # layout differs get different plan structures and cannot ride along
        if pl[3] != modes0 or pl[4] != vidx0 or len(pl[2]) != len(valids0):
            return None
        if [(n, f, s, v) for n, f, s, v in pl[5]] != aplan0:
            return None

    def dispatch():
        with _breaker_watch("groupby", bk, dev):
            with _kernel(bk):
                return ops.segment_reduce_batch_parts(
                    [pl[0] for pl in plans],
                    [pl[1] for pl in plans],
                    [pl[2] for pl in plans],
                    nb, modes0, vidx0,
                )

    def finalize(handle):
        reds, cnts = _host(handle[0]), _host(handle[1])
        return [
            _groupby_from_raw(
                parts[i].columns[by].data.dtype, plans[i][5], reds[i], cnts[i]
            )
            for i in range(len(parts))
        ]

    return dispatch, finalize


def plan_value_counts_batch(
    parts: Sequence[Partition], col: str, backend: Optional[str] = None,
    device=None,
) -> Optional[BatchPlan]:
    bk = active_backend(backend)
    dev = device_of(bk, device)
    if bk == "numpy" or not parts or not _same_bucket(parts):
        return None
    if not _BOARD.is_closed("value_counts", bk):
        return None
    if any(not _vc_supported(p, col) for p in parts):
        return None
    nb = len(parts[0].columns[col].dictionary)

    def dispatch():
        with _breaker_watch("value_counts", bk, dev):
            with _kernel(bk):
                return ops.segment_reduce_batch_parts(
                    [_dev_i32(p.columns[col], dev) for p in parts],
                    [[] for _ in parts],
                    [[_dev_valid(p.columns[col], dev)] for p in parts],
                    nb, [], [],
                )

    def finalize(handle):
        cnts = _host(handle[1])
        return [
            _vc_from_raw(parts[i].columns[col].data.dtype, cnts[i][0])
            for i in range(len(parts))
        ]

    return dispatch, finalize


def plan_sort_batch(
    parts: Sequence[Partition],
    by: str,
    ascending: bool,
    limit: Optional[int],
    n_samples: int = 32,
    backend: Optional[str] = None,
    device=None,
) -> Optional[BatchPlan]:
    bk = active_backend(backend)
    dev = device_of(bk, device)
    if bk == "numpy" or not parts or not _same_bucket(parts):
        return None
    if any(p.columns.get(by) is None or p.nrows == 0 for p in parts):
        return None
    if limit is None:
        if not _BOARD.is_closed("sort", bk):
            return None
        keys_list = [_sort_keys(p.columns[by], ascending) for p in parts]
        if any(np.isnan(k).any() for k in keys_list):
            return None

        def dispatch():
            with _breaker_watch("sort", bk, dev):
                with _kernel(bk):
                    return ops.argsort_f64_parts(
                        [_dev_sort_keys(p.columns[by], ascending, dev, torch.float64)
                         for p in parts]
                    )

        def finalize(handle):
            orders = _host(handle)
            return [
                _sorted_result(
                    parts[i], keys_list[i], orders[i][: parts[i].nrows], n_samples
                )
                for i in range(len(parts))
            ]

        return dispatch, finalize

    if not (1 <= limit <= TOPK_MAX_K):
        return None
    if not _BOARD.is_closed("topk", bk):
        return None
    if any(p.columns[by].is_string or p.nrows <= limit for p in parts):
        return None
    keys_list = [_sort_keys(p.columns[by], ascending) for p in parts]
    if any(np.isnan(k).any() for k in keys_list):
        return None  # NaN keys poison the thresholds (see the unbatched path)
    kf32s = [k.astype(np.float32) for k in keys_list]

    def dispatch():
        with _breaker_watch("topk", bk, dev):
            with _kernel(bk):
                return ops.topk_padded_parts(
                    [_dev_sort_keys(p.columns[by], ascending, dev, torch.float32)
                     for p in parts],
                    limit, largest=not ascending,
                )

    def finalize(handle):
        winners = _host(handle)
        return [
            _limit_select(
                parts[i], keys_list[i], kf32s[i], winners[i],
                ascending, limit, n_samples,
            )
            for i in range(len(parts))
        ]

    return dispatch, finalize


def plan_select_rows_batch(
    parts: Sequence[Partition],
    keeps_fn,
    backend: Optional[str] = None,
    device=None,
) -> Optional[BatchPlan]:
    """Fused filter compaction over a partition group.  ``keeps_fn()`` is
    called at *dispatch* time and must return one boolean keep mask per
    partition — predicate evaluation is part of the unit's work.  Rows of
    one element width (across columns and partitions) compact in one
    dispatch."""
    bk = active_backend(backend)
    dev = device_of(bk, device)
    if bk == "numpy" or not parts or not _same_bucket(parts):
        return None
    if not _BOARD.is_closed("filter", bk):
        return None
    if any(p.nrows == 0 for p in parts):
        return None

    def dispatch():
        with _breaker_watch("filter", bk, dev):
            keeps = [np.asarray(k, bool) for k in keeps_fn()]
            groups: Dict[int, list] = {}  # element size -> [(slot, row, keep)]
            for i, (p, keep) in enumerate(zip(parts, keeps)):
                keep_dev = _upload(keep, dev)
                for name in p.order:
                    c = p.columns[name]
                    if not _compactable(c):
                        continue
                    x = _dev_native(c, dev)
                    groups.setdefault(x.element_size(), []).append(
                        ((i, name, "data"), x, keep_dev))
                    if c.mask is not None:
                        groups.setdefault(1, []).append(
                            ((i, name, "mask"), _dev_mask(c, dev), keep_dev))
            out: Dict[Tuple[int, str, str], torch.Tensor] = {}
            with _kernel(bk):
                for size, rows in groups.items():
                    bits = {1: torch.uint8, 4: torch.int32, 8: torch.int64}[size]
                    packed, _ = ops.filter_compact_padded_parts(
                        [x.view(bits) for _, x, _ in rows], [k for _, _, k in rows]
                    )
                    for j, (slot, x, _) in enumerate(rows):
                        out[slot] = packed[j].view(x.dtype)
            return keeps, out

    def finalize(handle):
        keeps, out = handle
        results = []
        for i, p in enumerate(parts):
            count = int(keeps[i].sum())
            new_cols: Dict[str, Column] = {}
            for name in p.order:
                c = p.columns[name]
                data = out.get((i, name, "data"))
                if data is None:
                    new_cols[name] = c.select(keeps[i])
                    continue
                new_cols[name] = _new_column(
                    data, out.get((i, name, "mask")), c, count, dev
                )
            results.append(Partition(new_cols, list(p.order)))
        return results

    return dispatch, finalize


# --------------------------------------------------------------------------- #
# Fused composites: filter→reduce chains as ONE guarded dispatch chain         #
#                                                                              #
# Partition-level entry points for the planner's fusion path                   #
# (``FrameRuntime``'s try_fused hooks): each takes the UNFILTERED partition    #
# plus the host-evaluated keep mask, compacts on the device and reduces,      #
# skipping the intermediate filtered partition.  Each returns ``None`` when    #
# fusion is not eligible for this partition — the caller then falls back to   #
# the unfused two-dispatch sequence.  Zero kept rows always declines.          #
# --------------------------------------------------------------------------- #


def fused_stats_partition(
    part: Partition,
    keep: np.ndarray,
    cols: Optional[Sequence[str]] = None,
    backend: Optional[str] = None,
    device=None,
) -> Optional[Dict[str, ColStats]]:
    """Fused filter→describe partial: masked stats over the kept rows only."""
    bk = active_backend(backend)
    dev = device_of(bk, device)
    names = list(cols) if cols is not None else B.numeric_columns(part)
    if bk == "numpy" or not names or part.nrows == 0:
        return None
    keep = np.asarray(keep, bool)
    if not keep.any():
        return None

    def _run():
        xs, ms = _dev_stats_stack(part, names, dev)
        with _kernel(bk):
            raw = _host(ops.filter_then_masked_stats(xs, ms, _upload(keep, dev)))
        return _stats_from_raw(names, raw.astype(np.float64))

    return _guarded("fused_stats", bk, dev, _run, lambda: None)


def fused_groupby_partition(
    part: Partition,
    keep: np.ndarray,
    by: str,
    aggs: Sequence[Tuple[str, str, Any]],
    topk_keys: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> Optional[dict]:
    """Fused filter→groupby partial: segment reductions over kept rows."""
    bk = active_backend(backend)
    dev = device_of(bk, device)
    if bk == "numpy" or not _groupby_supported(part, by, aggs, topk_keys):
        return None
    key_col = part.columns[by]
    nb = len(key_col.dictionary)
    keep = np.asarray(keep, bool)
    if not keep.any():
        return None

    def _run():
        keys, values, valids, modes, valid_idx, agg_plan = _groupby_plan(
            part, by, aggs, dev, dedup_by_name=True
        )
        with _kernel(bk):
            reds, cnts = ops.filter_then_segment_reduce(
                keys, values, valids, _upload(keep, dev), nb, modes, valid_idx
            )
        return _groupby_from_raw(key_col.data.dtype, agg_plan, _host(reds), _host(cnts))

    return _guarded("fused_groupby", bk, dev, _run, lambda: None)


def fused_topk_partition(
    part: Partition,
    keep: np.ndarray,
    by: str,
    ascending: bool,
    limit: Optional[int],
    n_samples: int = 32,
    backend: Optional[str] = None,
    device=None,
) -> Optional[Tuple[Partition, np.ndarray]]:
    """Fused filter→topk partial: winners from the masked parent keys, final
    rows gathered straight from the parent partition (identical math to
    ``_limit_select``, expressed in kept-row coordinates)."""
    bk = active_backend(backend)
    dev = device_of(bk, device)
    key_col = part.columns.get(by)
    if bk == "numpy" or key_col is None or limit is None or part.nrows == 0:
        return None
    if not (1 <= limit <= TOPK_MAX_K) or key_col.is_string:
        return None
    keep = np.asarray(keep, bool)
    kept_idx = np.nonzero(keep)[0]
    if len(kept_idx) <= limit:
        return None  # the unfused path host-sorts this tiny case anyway
    keys = _sort_keys(key_col, ascending)  # parent-row key space
    kkeys = keys[kept_idx]
    if np.isnan(kkeys).any():
        return None  # NaN poisons the threshold (see _partial_sort_limit)
    kf32 = keys.astype(np.float32)

    def _run():
        with _kernel(bk):
            winners = _host(ops.topk_masked_padded(
                _dev_sort_keys(key_col, ascending, dev, torch.float32), _upload(keep, dev),
                limit, largest=not ascending,
            ))
        kth = winners[-1]
        kk32 = kf32[kept_idx]
        cand = np.nonzero(kk32 <= kth if ascending else kk32 >= kth)[0]
        order_local = np.argsort(
            kkeys[cand] if ascending else -kkeys[cand], kind="stable"
        )
        idx_local = cand[order_local][:limit]
        sorted_part = part.take(kept_idx[idx_local])
        skeys = kkeys[idx_local]
        if len(skeys) == 0:
            samples = np.array([])
        else:
            samples = skeys[
                np.linspace(0, len(skeys) - 1, min(n_samples, len(skeys))).astype(int)
            ]
        return sorted_part, samples

    return _guarded("fused_topk", bk, dev, _run, lambda: None)


# --------------------------------------------------------------------------- #
# sharded (data-mesh) dispatch paths                                           #
#                                                                              #
# Whole-node entry points over the ``data`` mesh (frame/dist.py): one call     #
# covers every partition of the node and the combine gathers onto the mesh's  #
# first device, replacing P per-partition dispatches + the host-side merge    #
# loop.  Each returns None when it declines (no mesh, op outside the          #
# envelope) — callers fall through to the ordinary paths.  "sharded" is a     #
# breaker/cost-model backend key only; it never flows through the BACKENDS    #
# policy chain (resolve() would reject it).                                    #
# --------------------------------------------------------------------------- #

# Right sides whose key array (in the probe's key type) is at most this
# broadcast to every probe as one device-resident array; above it, the
# partition-parallel build shards the sort across ``data`` and probes
# locally (env-tunable so tests and benches can exercise the sharded build
# without gigabyte tables).
JOIN_BROADCAST_MAX_BYTES = int(
    os.environ.get("REPRO_JOIN_BROADCAST_MAX", 8 << 20)
)


def sharded_available(device=None) -> bool:
    """A usable data mesh and sharding not forced off; given ``device`` (a
    session's), the mesh must also be on that kind of device, so a session
    asked onto the CPU never reaches the cards and the other way round."""
    from . import dist

    if not dist.sharded_available():
        return False
    return device is None or dist.data_mesh()[0].type == torch.device(device).type


def _mesh_kernel(backend: Optional[str]) -> str:
    """The kernel backend a sharded dispatch runs under: a ``cuda`` or
    ``torch`` session's own, so its shards compute what its host path
    computes; a ``numpy`` session's sharded path runs the kernels, as the
    JAX package's runs its xla kernels."""
    bk = active_backend(backend)
    return bk if bk in ("cuda", "torch") else "cuda"


def sharded_stats(table: "PTable", cols: Optional[Sequence[str]] = None,
                  backend: Optional[str] = None):
    """Merged ColStats for the table's numeric columns in one sharded call —
    bit-for-bit ``B.merge_stats`` over the per-partition kernel partials.
    Returns ``None`` when declined (no mesh, <2 partitions, no numeric
    columns)."""
    from . import dist

    if not dist.sharded_available() or len(table.partitions) < 2:
        return None
    names = list(cols) if cols is not None else B.numeric_columns(
        table.partitions[0]
    )
    if not names:
        return None
    st = dist.ShardedPTable.from_table(table, names)
    if st is None:
        return None
    kb = _mesh_kernel(backend)

    def _run():
        raw = dist.stats_combined(st, kb)  # (C, 5) f64: n, mean, m2, mn, mx
        return {
            nm: ColStats(
                float(r[0]), float(r[1]), float(r[2]), float(r[3]), float(r[4])
            )
            for nm, r in zip(names, raw)
        }

    return _guarded("stats", "sharded", st.mesh[0], _run, lambda: None)


def sharded_stats_raws(table: "PTable", names: Sequence[str], backend: Optional[str] = None):
    """Per-partition (count, sum, m2, min, max) raws for EVERY partition in
    one call — the sharded UnitBatch's kernel.  Row i sliced through
    ``_stats_from_raw`` is bit-identical to ``partial_stats(partitions[i])``.
    Cached on the table: think-time batches after the first are host-only."""
    from . import dist

    if not dist.sharded_available():
        return None
    st = dist.ShardedPTable.from_table(table, names)
    if st is None:
        return None
    kb = _mesh_kernel(backend)

    def build():
        return _guarded("stats", "sharded", st.mesh[0], lambda: dist.stats_raws(st, kb),
                        lambda: None)

    # a failed call is not kept: the next batch tries again
    return dist.mesh_cached(table, "raws", (tuple(names), kb), build, keep_none=False)


def _shared_dictionary(table: "PTable", col: str):
    """The column's dictionary when every partition shares the same object
    (from_pydict encodes once, so derived tables keep sharing); None otherwise
    — cross-partition codes are only comparable against one dictionary."""
    d0 = table.partitions[0].columns[col].dictionary
    if d0 is None:
        return None
    for p in table.partitions[1:]:
        c = p.columns.get(col)
        if c is None or c.dictionary is not d0:
            return None
    return d0


def _sharded_seg_plan(part: Partition, by: str, aggs, dev: torch.device) -> tuple:
    """One partition's segment-reduction plan on its shard's device: the
    host path's own ``_groupby_plan`` (so the two cannot drift), its
    structure — modes, valid rows, agg plan — as tuples that partitions must
    share to stack into one call."""
    keys, values, valids, modes, valid_idx, agg_plan = _groupby_plan(part, by, aggs, dev)
    return (keys, values, valids, tuple(modes), tuple(valid_idx),
            [tuple(a) for a in agg_plan])


def _sharded_seg_stack(table: "PTable", by: str, aggs):
    """Per-shard stacked (keys, values, valids) device matrices for a
    whole-table segment reduction, plus the shared plan.  None when the plan
    structure differs across partitions (mask layout drift) — the
    per-partition path handles those."""
    from . import dist

    mesh = dist.data_mesh()
    if mesh is None:
        return None
    parts = table.partitions

    def build():
        _, pl, _ = dist._padded_layout(len(parts), mesh)
        plans = [_sharded_seg_plan(p, by, aggs, mesh[i // pl]) for i, p in enumerate(parts)]
        _, v0, m0, modes0, vidx0, plan0 = plans[0]
        for pl_ in plans[1:]:
            if pl_[3] != modes0 or pl_[4] != vidx0 or len(pl_[2]) != len(m0) or pl_[5] != plan0:
                return None
        nb = dist._common_bucket([p.nrows for p in parts])

        def stack(field, width, dtype):
            return dist.stack_rows(mesh, len(parts), nb, width, dtype, 0,
                                   lambda i, dev: field(plans[i]))

        keys = tuple(k[:, 0] for k in stack(lambda pln: [pln[0]], 1, torch.int32))
        return (keys, stack(lambda pln: pln[1], len(v0), torch.float32),
                stack(lambda pln: pln[2], len(m0), torch.bool), modes0, vidx0, plan0, pl)

    return dist.mesh_cached(table, "segments", (by, tuple(aggs)), build)


def sharded_value_counts(table: "PTable", col: str, backend: Optional[str] = None):
    """One sharded call for a whole-table value_counts over a dictionary
    column: per-partition count rows + an exact integer sum.  Returns ONE
    (values, counts) partial — feed ``B.merge_value_counts``."""
    from . import dist

    if not dist.sharded_available() or len(table.partitions) < 2:
        return None
    c0 = table.partitions[0].columns.get(col)
    if c0 is None:
        return None
    dictionary = _shared_dictionary(table, col)
    if dictionary is None or not 0 < len(dictionary) < MAX_BUCKETS:
        return None
    stack = _sharded_seg_stack(table, col, ())
    if stack is None:
        return None
    keys, values, valids, modes, vidx, _, pl = stack
    mesh = dist.data_mesh()
    kb = _mesh_kernel(backend)

    def _run():
        _, cnts = dist.segment_fold(
            mesh, keys, values, valids, len(dictionary), modes, vidx, pl,
            len(table.partitions), kb,
        )
        return _vc_from_raw(c0.data.dtype, cnts[0])

    return _guarded("value_counts", "sharded", mesh[0], _run, lambda: None)


def sharded_groupby(table: "PTable", by: str, aggs, backend: Optional[str] = None):
    """One sharded call for a whole-table groupby: per-partition segment
    reductions + a float64 fold in global partition order (the host combine
    is a flat left fold — np.add.at over payloads in partition order —
    replayed exactly).  Returns ONE partial dict — feed
    ``B.merge_groupby``."""
    from . import dist

    if not dist.sharded_available() or len(table.partitions) < 2:
        return None
    parts = table.partitions
    for p in parts:
        if not _groupby_supported(p, by, aggs, None):
            return None
    dictionary = _shared_dictionary(table, by)
    if dictionary is None or not 0 < len(dictionary) < MAX_BUCKETS:
        return None
    stack = _sharded_seg_stack(table, by, tuple(aggs))
    if stack is None:
        return None
    keys, values, valids, modes, vidx, agg_plan, pl = stack
    key_dtype = parts[0].columns[by].data.dtype
    mesh = dist.data_mesh()
    kb = _mesh_kernel(backend)

    def _run():
        reds, cnts = dist.segment_fold(
            mesh, keys, values, valids, len(dictionary), modes, vidx, pl, len(parts), kb,
        )
        return _groupby_from_raw(key_dtype, agg_plan, reds, cnts)

    return _guarded("groupby", "sharded", mesh[0], _run, lambda: None)


def sharded_topk(
    table: "PTable", by: str, ascending: bool, limit: int, n_samples: int = 32,
    backend: Optional[str] = None,
):
    """One sharded call for every partition's top-k winners, then the same
    host candidate selection (``_limit_select``) the per-partition path
    runs — partials are bit-identical to it.  Partitions outside the kernel
    envelope (≤ limit rows, NaN keys) take the numpy partial individually,
    exactly as the host path would.  Returns the (partition, samples) partial
    list — feed ``B.merge_sort``."""
    from . import dist

    if not dist.sharded_available() or len(table.partitions) < 2:
        return None
    if not (1 <= limit <= TOPK_MAX_K):
        return None
    parts = table.partitions
    for p in parts:
        c = p.columns.get(by)
        if c is None or c.is_string:
            return None
    mesh = dist.data_mesh()

    def build():
        nb = dist._common_bucket([p.nrows for p in parts])
        kf64s = [_sort_keys(p.columns[by], ascending) for p in parts]
        kf32s = [k.astype(np.float32) for k in kf64s]
        sentinel = float("inf") if ascending else float("-inf")
        stack = dist.stack_rows(mesh, len(parts), nb, 1, torch.float32, sentinel,
                                lambda i, dev: [_upload(kf32s[i], dev)])
        return kf64s, kf32s, tuple(x[:, 0] for x in stack)

    kf64s, kf32s, stack = dist.mesh_cached(table, "topk", (by, ascending), build)
    kb = _mesh_kernel(backend)

    def _run():
        winners = dist.topk_winners(mesh, stack, limit, not ascending, kb)
        out = []
        for i, part in enumerate(parts):
            if part.nrows <= limit or np.isnan(kf64s[i]).any():
                out.append(B.partial_sort(part, by, ascending, limit, n_samples))
            else:
                out.append(
                    _limit_select(
                        part, kf64s[i], kf32s[i], winners[i],
                        ascending, limit, n_samples,
                    )
                )
        return out

    return _guarded("topk", "sharded", mesh[0], _run, lambda: None)


def plan_stats_sharded_batch(
    table: "PTable", indices: Sequence[int], backend: Optional[str] = None,
    device=None,
):
    """Sharded :class:`UnitBatch` plan for the stats family: ONE call
    produces every partition's (count, sum, m2, min, max) raw row, and
    ``finalize`` slices the listed slots through ``_stats_from_raw`` — each
    slot bit-identical to ``partial_stats`` of that partition.  Returns
    ``(dispatch, finalize, n_devices)`` or ``None`` when the table is outside
    the sharded envelope.  ``backend`` picks the shards' kernel backend and
    serves, with ``device``, the host per-unit fallback."""
    from . import dist

    if not dist.sharded_available() or len(table.partitions) < 2:
        return None
    names = tuple(B.numeric_columns(table.partitions[0]))
    if not names or dist.ShardedPTable.from_table(table, names) is None:
        return None

    def dispatch():
        return sharded_stats_raws(table, names, backend)

    def finalize(raws):
        if raws is None:  # sharded call declined at run time: host per-unit path
            return [partial_stats(table.partitions[i], backend=backend, device=device)
                    for i in indices]
        return [
            _stats_from_raw(names, np.asarray(raws[i], np.float64))
            for i in indices
        ]

    return dispatch, finalize, dist.device_count()


def _sharded_join_build_cached(right: "PTable", on: str, dtype: np.dtype):
    """Partition-parallel build, cached on the right table: shard the valid
    (key, row-id) pairs across ``data`` and sort each shard on its own
    device — for right sides whose broadcast key array would exceed
    ``JOIN_BROADCAST_MAX_BYTES`` (or when sharding is forced on).  ``None``
    marks a right side outside the gate or the envelope (NaN keys, or
    integer keys a float64 probe would not hold exactly); the broadcast path
    covers it."""
    from . import dist

    total = sum(p.nrows for p in right.partitions)
    if not (
        dist.sharded_available()
        and total > 0
        and (total * dtype.itemsize > JOIN_BROADCAST_MAX_BYTES or dist.mode() == "on")
    ):
        return None

    def build():
        rmerged = right.concat()
        rcol = rmerged.columns[on]
        native = np.asarray(rcol.data)
        ridx = np.nonzero(np.asarray(rcol.valid_mask()))[0]
        if (dtype.kind == "f" and native.dtype.kind in "iu" and len(ridx)
                and float(np.abs(native[ridx]).max()) > 2.0 ** (np.finfo(dtype).nmant + 1)):
            return None
        keys = _probe_host(native[ridx], dtype)
        if dtype.kind == "f" and np.isnan(keys).any():
            return None
        # duplicate keys raise here, the host build's error
        return rmerged, dist.join_build(keys, ridx.astype(np.int64))

    return dist.mesh_cached(right, "join", (on, dtype.str), build)
