"""What a run records: host-clock spans always, and in a traced run the
profiler's device intervals and span annotations.

Spans come from the benchmark's own code: each interaction, think,
request and step is a ``Span`` on the host clock (``time.perf_counter``)
and, in a traced run, a ``torch.profiler.record_function`` range named
``bench.<kind>#<index>``.  The traced part of the window is read from the
profiler's raw Kineto events (``kineto_results.events()``), which skips
the slow building of ``FunctionEvent`` trees.  Device intervals and the
annotations share the profiler's clock.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import arith

SPAN_PREFIX = "bench."


@dataclass
class Span:
    kind: str  # "interaction" | "think" | "request" | "step" | ...
    index: int
    t0: float
    t1: float
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclass
class DeviceTrace:
    """The traced part of a window, all times in seconds on the profiler's
    clock: ``window`` its bounds, ``spans`` the benchmark's annotations
    (kind, index, start, end), ``device`` every kernel, copy and set on the
    card (name, start, end, category)."""

    window: Tuple[float, float]
    spans: List[Tuple[str, int, float, float]]
    device: List[Tuple[str, float, float, str]]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self, lo: Optional[float] = None, hi: Optional[float] = None) -> float:
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        return arith.union_length(((s, e) for _, s, e, _ in self.device), lo, hi)

    def spans_of(self, kind: str) -> List[Tuple[int, float, float]]:
        return [(i, s, e) for k, i, s, e in self.spans if k == kind]

    def kernel_s(self, pred, lo: float, hi: float) -> float:
        """Device seconds, clipped to [lo, hi], of the kernels whose name
        satisfies ``pred``."""
        return sum(max(0.0, min(e, hi) - max(s, lo)) for n, s, e, c in self.device
                   if c == "kernel" and pred(n))

    def breakdown(self) -> Dict[str, List[List[Any]]]:
        """The ten device operations that took most time (summed by name)
        and the ten longest idle gaps, each named by the benchmark span the
        host was in (or "outside spans")."""
        by_name: Dict[str, float] = {}
        for n, s, e, _ in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(arith.gaps(((s, e) for _, s, e, _ in self.device), *self.window),
                      key=lambda g: g[0] - g[1])[:10]
        out = []
        for s, e in idle:
            mid = 0.5 * (s + e)
            host = [k for k, _, a, b in self.spans if a <= mid <= b]
            out.append([host[-1] if host else "outside spans", e - s])
        return {"device_ops": [[n[:120], t] for n, t in top], "idle_gaps": out}


class Recorder:
    """Host-clock spans for the whole window, and the profiler over its
    first ``trace_s`` seconds when tracing."""

    def __init__(self, trace: bool, trace_s: float):
        self.trace = trace
        self.trace_s = trace_s
        self.spans: List[Span] = []
        self.window: Optional[Tuple[float, float]] = None
        self.device_trace: Optional[DeviceTrace] = None
        self._prof = None
        self._prof_t0 = 0.0
        self._window_range = None

    def start_window(self) -> float:
        t0 = time.perf_counter()
        self.window = (t0, t0)
        if self.trace:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._window_range = torch.profiler.record_function(SPAN_PREFIX + "window#0")
            self._window_range.__enter__()
            self._prof_t0 = time.perf_counter()
        return t0

    def maybe_stop_trace(self) -> None:
        """Close the profiled part once ``trace_s`` seconds have passed."""
        if self._prof is not None and time.perf_counter() - self._prof_t0 >= self.trace_s:
            self._stop_trace()

    def end_window(self) -> None:
        self.window = (self.window[0], time.perf_counter())
        if self._prof is not None:
            self._stop_trace()

    def _stop_trace(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window_range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.device_trace = read_kineto(self._prof.profiler.kineto_results.events())
        self._prof = None

    @contextlib.contextmanager
    def span(self, kind: str, **attrs):
        """Time a span on the host clock; annotate it while profiling."""
        index = len(self.spans)
        rng = None
        if self._prof is not None:
            import torch

            rng = torch.profiler.record_function(f"{SPAN_PREFIX}{kind}#{index}")
            rng.__enter__()
        sp = Span(kind, index, time.perf_counter(), 0.0, dict(attrs))
        try:
            yield sp
        finally:
            sp.t1 = time.perf_counter()
            if rng is not None:
                rng.__exit__(None, None, None)
            self.spans.append(sp)
            self.maybe_stop_trace()

    def of(self, kind: str) -> List[Span]:
        return [s for s in self.spans if s.kind == kind]


def _category(ev, host_names) -> Optional[str]:
    """'kernel', 'copy' or 'set' for an event on the card, else None.  A
    ``record_function`` range is also projected onto the card's timeline
    under its own name; it is told apart by that name, which the host's
    side of the trace carries too (no kernel is named like a host event)."""
    if "cuda" not in str(ev.device_type()).lower():
        return None
    name = ev.name()
    act = getattr(ev, "activity_type", None)
    if act is not None:  # newer torch: Kineto's own activity type
        act = str(act()).lower()
        if "memcpy" in act:
            return "copy"
        if "memset" in act:
            return "set"
        return "kernel" if "kernel" in act else None
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "set"
    if name.startswith(SPAN_PREFIX) or name in host_names:
        return None
    return "kernel"


def read_kineto(events) -> DeviceTrace:
    events = list(events)
    host_names = {ev.name() for ev in events if "cpu" in str(ev.device_type()).lower()}
    spans, device = [], []
    window = None
    for ev in events:
        name = ev.name()
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        cat = _category(ev, host_names)
        if cat is not None:
            device.append((name, s, e, cat))
            continue
        if name.startswith(SPAN_PREFIX) and "cpu" in str(ev.device_type()).lower():
            kind, _, idx = name[len(SPAN_PREFIX):].partition("#")
            if kind == "window":
                window = (s, e)
            else:
                spans.append((kind, int(idx), s, e))
    if window is None:
        raise RuntimeError("the profiler recorded no window annotation")
    return DeviceTrace(window=window, spans=spans, device=device)
