"""The roofline: a step's work counted against an H100's peaks.

Terms (per device, each the least time the card could take):
    compute    = flops            / PEAK_FLOPS (bf16 on the tensor cores)
    memory     = bytes            / HBM_BW
    collective = bytes moved away / collective_bw(chips)

The reference reads flops and bytes from XLA's cost analysis of a compiled
step and its collective bytes from the HLO.  Torch compiles nothing, so the
port counts the step as it runs, on ``meta`` tensors (no allocation) or on
real ones: :func:`count` is a ``TorchDispatchMode`` that sees every aten op.

* Matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions)
  cost ``torch.utils.flop_counter``'s formulas (2 M N K).
* Every other op costs one flop per output element, the convention of
  XLA's cost analysis; views and allocations cost nothing.
* Bytes are each op's tensor inputs read once plus its outputs written
  once, op by op, as if nothing fused: an upper bound on the traffic a
  fused step would make.
* A kernel entry point (``kernels.ops.attention``, ``kernels.ops.ssd_scan``
  and their backward) charges its own work formula once (:func:`charge`:
  :func:`attention_work`, :func:`ssd_work` with :func:`scan_work`,
  :func:`recur_work`, :func:`ssd_bwd_work`) and counts nothing inside, so the
  count is the same whichever route implements it: the CUDA kernels (whose
  ``ctypes`` launches no dispatch mode sees), the plain version on the CPU
  or on ``meta``.  Attention counts the visible (query, key) pairs only.
* Copies from one device to another add their bytes to ``coll`` under
  ``"transfer"``: what the single-controller mesh moves between cards.

The constants are the H100 SXM data sheet's (dense, no sparsity).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import Counter as _Tally
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12  # bf16 on the tensor cores, dense (H100 SXM data sheet)
PEAK_FLOPS_F32 = 67e12  # float32 outside the tensor cores (H100 SXM data sheet)
HBM_BW = 3.35e12  # HBM3, B/s per card (H100 SXM data sheet)
NVLINK_BW = 450e9  # NVLink 4, B/s each way per card, within one host (900 GB/s both ways)
NET_BW = 50e9  # one 400 Gb/s InfiniBand NDR port per card, B/s each way, beyond one host
HOST_CARDS = 8  # cards one NVLink host holds (HGX H100 8-GPU)


def collective_bw(chips: int) -> float:
    """B/s a card moves to the others: NVLink within one host, the network
    beyond it."""
    return NVLINK_BW if chips <= HOST_CARDS else NET_BW


# ---------------------------------------------------------- kernel formulas --


def bound(nbytes, nops, ops_per_s=PEAK_FLOPS_F32):
    """The least time (ms) and what bounds it: bytes over the memory rate, or
    operations over the peak rate of the operands' type."""
    tb, to = nbytes / HBM_BW * 1e3, nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ssd_work(bt, S, H, Pd, N, L, esize):
    """(bytes, flops) of one intra-chunk launch: each input read once, each
    output written once; per cell, C·Bᵀ and M·X over the causal triangle
    (T = L (L + 1) / 2 entries, the rest is masked to 0) and the chunk
    state in full: 2 (T N + T P + N L P) flops."""
    nc, tri = S // L, L * (L + 1) // 2
    nbytes = bt * (esize * (2 * S * H * Pd + 2 * S * N) + 4 * S * H + 4 * nc * H * N * Pd)
    return nbytes, bt * nc * H * 2 * (tri * N + tri * Pd + N * L * Pd)


def scan_work(bt, S, H, Pd, N, L, esize):
    """(bytes, flops) of the inter-chunk pass: y_intra, the chunk states,
    log_a and c read once, y and h_final written once; C h_in (2 S H N P),
    the recurrence (2 nc H N P) and the correction (2 S H P)."""
    nc = S // L
    nbytes = bt * (esize * (2 * S * H * Pd + S * N) + 4 * (nc * H * N * Pd + S * H + H * N * Pd))
    return nbytes, bt * 2 * H * Pd * (S * N + nc * N + S)


def ssd_bwd_work(bt, S, H, Pd, N, L, esize, dh=True):
    """{kernel: (bytes, flops)} of the SSD backward's three launches, by the
    conventions of :func:`ssd_work`: each input read once, each output and
    scratch written once (and read once by the launch after), flops over
    the causal triangle (T = L (L + 1) / 2 entries).
    ``ssd_chunk_scan_bwd_state``: the walk to each h_in_k (S_k, 2 L N P,
    and D h + S, 2 N P, for every chunk but the last) and back to each g_k
    (Q_k and Q + D g, for every chunk but the first); x, dy, b, c, log_a
    and ``dh`` (if given) read, h_in and g written.
    ``ssd_chunk_scan_bwd_chunk``: C Bᵀ (2 T N) once per chunk, since b and
    c are shared by the heads (the kernel recomputes it for each head), and
    per (chunk, head) Zᵀ C and Z B (2 T N each), dY Xᵀ and Mᵀ dY (2 T P
    each), E, M, Z, A and A's row and column sums (6 T), B g, X gᵀ and dY
    h_inᵀ (2 L N P each), their scalings and the partial dot products of
    dcum (4 L P + 6 L N), ⟨g, h_in⟩ (2 N P) and dcum to dlog_a (6 L); the
    inputs, h_in and g read, dx, dlog_a and the heads' db and dc terms
    written.
    ``ssd_chunk_scan_bwd_sum``: the heads' terms read, db and dc written."""
    nc, tri = S // L, L * (L + 1) // 2
    state = bt * nc * H * N * Pd * 4  # bytes of h_in, and of g
    ins = bt * (esize * (2 * S * H * Pd + 2 * S * N) + 4 * S * H)
    terms = bt * nc * H * L * N * 4  # bytes of the heads' db terms, and of dc's
    return {
        "ssd_chunk_scan_bwd_state": (
            ins + (4 * bt * H * N * Pd if dh else 0) + 2 * state,
            bt * H * max(nc - 1, 0) * 4 * N * Pd * (L + 1)),
        "ssd_chunk_scan_bwd_chunk": (
            ins + 2 * state + bt * (esize * S * H * Pd + 4 * S * H) + 2 * terms,
            bt * nc * (2 * tri * N + H * (2 * tri * (2 * N + 2 * Pd + 3) + 6 * L * N * Pd
                                          + 4 * L * Pd + 6 * L * N + 2 * N * Pd + 6 * L))),
        "ssd_chunk_scan_bwd_sum": (2 * terms + 2 * bt * S * N * esize, 2 * bt * S * N * H),
    }


def ssd_bwd_total(bt, S, H, Pd, N, L, esize, dh=True):
    """(bytes, flops) of the SSD backward as one function: x, dy, b, c,
    log_a and ``dh`` (if given) read once, dx, dlog_a, db and dc written
    once, and no scratch (h_in, g and the heads' db and dc terms are the
    three-launch split's own); the flops of :func:`ssd_bwd_work`'s three
    launches."""
    work = ssd_bwd_work(bt, S, H, Pd, N, L, esize, dh)
    nbytes = bt * (esize * (3 * S * H * Pd + 4 * S * N) + 4 * 2 * S * H)  # x dy dx, b c db dc
    if dh:
        nbytes += 4 * bt * H * N * Pd
    return nbytes, sum(fl for _, fl in work.values())


def recur_work(bt, S, H, Pd, N, esize):
    """(bytes, flops) of the whole function at one-token chunks: x, log_a,
    b and c read once, y and h_final written once; c·h (2 S H N P), the
    update d h + b xᵀ (3 S H N P), c·b (2 S N) and y's three operations a
    value (3 S H P)."""
    nbytes = bt * (esize * (2 * S * H * Pd + 2 * S * N) + 4 * (S * H + H * N * Pd))
    return nbytes, bt * (5 * S * H * N * Pd + 2 * S * N + 3 * S * H * Pd)


def visible_pairs(Sq, Skv, causal, window, q_offset):
    """The (query, key) pairs the mask lets through, per (batch, q-head)."""
    p = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(p, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, p - window + 1) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_work(shape):
    """(bytes, flops) of the three kernels at ``shape`` = (B, Hq, Hkv, Sq,
    Skv, D, dtype name, causal, window, q_offset), each input read once and
    each output written once; flops over the visible pairs only: forward S
    and P V (4 D a pair), dQ S, dP and dS K (6 D), dK/dV S, dP, Pᵀ dO and
    dSᵀ Q (8 D)."""
    B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, off = shape
    e = 2 if dtype == "bfloat16" else 4
    qn, kn, rows = B * Hq * Sq * D, B * Hkv * Skv * D, B * Hq * Sq
    pairs = B * Hq * visible_pairs(Sq, Skv, causal, window, off)
    return {
        "flash_attention": (e * (2 * qn + 2 * kn) + 4 * rows, 4 * D * pairs),
        "flash_attention_bwd_dq": (e * (3 * qn + 2 * kn) + 4 * qn + 8 * rows, 6 * D * pairs),
        "flash_attention_bwd_dkdv": (e * (2 * qn + 4 * kn) + 8 * rows, 8 * D * pairs),
    }


def attention_shape(q, k, causal, window, q_offset):
    """:func:`attention_work`'s shape tuple of one call."""
    B, Hq, Sq, D = q.shape
    dtype = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    return (B, Hq, k.shape[1], Sq, k.shape[2], D, dtype, bool(causal), window, int(q_offset))


# ------------------------------------------------------------------ counting --


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __add__(self, o: "Cost") -> "Cost":
        c = _Tally(self.coll)
        c.update(o.coll)
        return Cost(self.flops + o.flops, self.bytes + o.bytes, dict(c))

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k, {n: int(v * k) for n, v in self.coll.items()})

    __rmul__ = __mul__


def _free_ops():
    a = torch.ops.aten
    names = ("empty", "empty_like", "empty_strided", "detach", "alias", "lift_fresh",
             "_local_scalar_dense", "set_", "resize_", "_unsafe_view", "sym_size",
             "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size", "record_stream")
    return {getattr(a, n) for n in names if hasattr(a, n)}


_FREE = None


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counting(TorchDispatchMode):
    """The mode :func:`count` enters.  ``cost``: the :class:`Cost` so far;
    ``by_op``: {op name: [calls, flops, bytes]}, charges under their
    kernel's name; ``charged``: {kernel name: charges}, the launches the
    card's route makes for the same work."""

    def __init__(self):
        super().__init__()
        global _FREE
        if _FREE is None:
            _FREE = _free_ops()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self.cost = Cost()
        self.by_op: Dict[str, list] = {}
        self.charged: Dict[str, int] = {}
        self._paused = 0
        self._lock = threading.Lock()

    def _add(self, name: str, flops: float, nbytes: float, moved: int = 0) -> None:
        with self._lock:
            self.cost.flops += flops
            self.cost.bytes += nbytes
            if moved:
                self.cost.coll["transfer"] = self.cost.coll.get("transfer", 0) + moved
            row = self.by_op.setdefault(name, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += flops
            row[2] += nbytes

    def charge(self, name: str, nbytes: float, flops: float) -> None:
        """One launch of kernel ``name`` doing ``flops`` over ``nbytes``."""
        self._add(name, flops, nbytes)
        with self._lock:
            self.charged[name] = self.charged.get(name, 0) + 1

    @contextmanager
    def paused(self) -> Iterator[None]:
        """Ops inside count nothing (a kernel's work, charged whole)."""
        with self._lock:
            self._paused += 1
        try:
            yield
        finally:
            with self._lock:
                self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if self._paused or packet in _FREE or func.is_view:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        moved = 0
        if func in (torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default):
            src = ins[1] if func is torch.ops.aten.copy_.default else ins[0]
            if outs and src.device != outs[0].device:
                moved = _nbytes(src)
        if packet in self._registry:
            flops = self._registry[packet](*args, **kwargs, out_val=out)
        else:
            flops = sum(t.numel() for t in outs)
        self._add(str(packet), float(flops),
                  float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)), moved)
        return out


_ACTIVE: list = []  # the counters entered, innermost last (any thread reads them)


def active() -> Optional[Counting]:
    """The innermost :func:`count` in progress, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextmanager
def count() -> Iterator[Counting]:
    """Count the work of what runs inside: ``with count() as c: step(...)``
    then ``c.cost``.  The mode reaches autograd's threads, so a backward
    run inside counts too."""
    c = Counting()
    _ACTIVE.append(c)
    try:
        with c:
            yield c
    finally:
        _ACTIVE.remove(c)


def charge(name: str, work: Tuple[float, float]) -> None:
    """Charge ``work`` = (bytes, flops) as one launch of ``name`` to the
    counter in progress, if any."""
    c = active()
    if c is not None:
        c.charge(name, *work)


@contextmanager
def uncounted() -> Iterator[None]:
    """What runs inside counts nothing in the counter in progress."""
    c = active()
    if c is None:
        yield
        return
    with c.paused():
        yield


# ------------------------------------------------------------------- report --


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_by_kind: Dict[str, int]
    peak_memory_per_device: float
    model_flops: float  # 6·N·D (active params for MoE)
    output_bytes: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / collective_bw(self.chips)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (counted flops × chips): how much counted compute
        is 'useful' — catches remat/padding/redundancy waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful flops / (bound time × peak)."""
        bound_s = max(self.t_compute, self.t_memory, self.t_collective)
        if bound_s <= 0:
            return 0.0
        per_chip_useful = self.model_flops / self.chips
        return per_chip_useful / (bound_s * PEAK_FLOPS)

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": round(self.t_compute, 6),
            "t_memory_s": round(self.t_memory, 6),
            "t_collective_s": round(self.t_collective, 6),
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops_per_dev": self.flops_per_device,
            "useful_flops_frac": round(self.useful_flops_fraction, 4),
            "roofline_frac": round(self.roofline_fraction, 4),
            "peak_mem_gb": round(self.peak_memory_per_device / 2**30, 3),
            "collectives": self.collective_by_kind,
        }


def analyze(arch: str, shape: str, mesh_name: str, chips: int, cost: Cost,
            model_flops: float, peak_memory: float = 0.0) -> RooflineReport:
    """The report of a step whose whole cost (over every device) is
    ``cost``, split evenly over ``chips`` cards."""
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        flops_per_device=cost.flops / chips,
        bytes_per_device=cost.bytes / chips,
        collective_bytes_per_device=float(sum(cost.coll.values())) / chips,
        collective_by_kind=dict(cost.coll),
        peak_memory_per_device=float(peak_memory),
        model_flops=model_flops,
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (N active for MoE); decode: D = global_batch new
    tokens (one step), with the attention KV-read excluded by convention."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens  # forward only
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
