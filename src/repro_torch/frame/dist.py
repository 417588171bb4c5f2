"""Sharded partition execution: the ``data`` mesh axis made real.

The partial/combine decomposition in :mod:`repro_torch.frame.blocking` is a
map + all-reduce: partitions live on devices along the ``data`` mesh axis and
the combine gathers their results.  This module holds the device layer, run
single-controller: one process drives every device of the mesh, shard after
shard, and nothing is waited for until the combine gathers.

* :func:`data_mesh` — the process-wide 1-D ``data`` mesh, a tuple of
  ``torch.device``: every local CUDA card when there are at least two and
  their count is a power of two, or the mesh :func:`use_mesh` installs
  (devices may repeat: ``[cuda:0] * 4`` emulates four shards on one card,
  ``[cpu] * 8`` eight on the CPU);
* :class:`ShardedPTable` — a PTable's numeric column blocks stacked into
  ``(Ppad, C, nb)`` value/validity matrices, shard ``s`` holding the
  contiguous partitions ``[s*pl, (s+1)*pl)`` on ``mesh[s]``, cached on the
  (immutable) host table;
* sharded dispatches — describe/mean raws + the exact stats combine, the
  groupby segment fold, value_counts, per-partition topk winners, and the
  partition-parallel join build/probe.  Each covers every partition of a
  node in one call instead of P per-partition dispatches + a host merge loop.

Bit-for-bit contract: every sharded combine replays the host combine's exact
float64 operation sequence, one torch op per numpy / Python op in the host's
association order (no fused multiply-add: each op is its own kernel).  The
host ``_pairwise_merge`` (iterative adjacent pairing) over P partials equals
a balanced pow-2 tree over ``next_pow2(P)`` leaves with empty-ColStats
padding at the end (merge with an ``n == 0`` operand is the identity), so
contiguous per-shard blocks of pow-2 size ``pl`` reproduce the host tree's
lower levels on their own devices, and ``log2(d)`` more levels over the
gathered subtree roots on ``mesh[0]`` complete it.  Per-partition raws come
from the *same* kernel entry points (:mod:`repro_torch.kernels.ops`) the host
path dispatches, at a shared row bucket whose extra padding is an exact no-op
in every kernel — so the numbers entering the combine are bit-identical too.
Each dispatch runs under the session's kernel backend: ``"cuda"`` calls the
kernels' wrappers (the hand-written kernels on a CUDA shard, which each
launch on its own card, and their plain versions on a CPU shard), ``"torch"``
the plain versions, as the session's host path does.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.masked_stats import TILE

DataMesh = Tuple[torch.device, ...]

# --------------------------------------------------------------------------- #
# mesh management                                                              #
# --------------------------------------------------------------------------- #

_MESH: Optional[DataMesh] = None  # the mesh over the local cards, once found
_MESH_FAILED = False
_MESH_LOCK = threading.Lock()
_INSTALLED: Optional[DataMesh] = None  # use_mesh's explicit mesh


def _usable(devs: DataMesh) -> bool:
    """The balanced-tree combine needs a power-of-two shard count ≥ 2."""
    d = len(devs)
    return d >= 2 and (d & (d - 1)) == 0


def data_mesh() -> Optional[DataMesh]:
    """The process-wide 1-D ``data`` mesh, or ``None`` when sharded execution
    cannot run (one device, or a device count that is not a power of two).
    An installed :func:`use_mesh` mesh wins over the local cards."""
    global _MESH, _MESH_FAILED
    if _INSTALLED is not None:
        return _INSTALLED if _usable(_INSTALLED) else None
    if _MESH is not None:
        return _MESH
    if _MESH_FAILED:
        return None
    with _MESH_LOCK:
        if _MESH is not None:
            return _MESH
        devs = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
        if not _usable(devs):
            _MESH_FAILED = True
            return None
        _MESH = devs
        return _MESH


@contextmanager
def use_mesh(devices: Sequence):
    """Scoped explicit mesh over ``devices`` (repeats allowed): the
    counterpart of the JAX package's forced host device count, for tests
    (``[cpu] * 8``) and for one card emulating several (``[cuda:0] * 4``)."""
    global _INSTALLED
    prev = _INSTALLED
    _INSTALLED = tuple(torch.device(d) for d in devices)
    try:
        yield data_mesh()
    finally:
        _INSTALLED = prev


def device_count() -> int:
    mesh = data_mesh()
    return len(mesh) if mesh is not None else 1


# --------------------------------------------------------------------------- #
# mode + dispatch counters                                                     #
# --------------------------------------------------------------------------- #

_MODE = "auto"  # "auto" (planner decides) | "on" (force) | "off" (disable)


def set_mode(mode: str) -> None:
    global _MODE
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"sharded mode {mode!r} (want auto|on|off)")
    _MODE = mode


def mode() -> str:
    return _MODE


@contextmanager
def use_sharded(mode_: str):
    """Scoped sharded-dispatch mode (tests/benches force or disable)."""
    global _MODE
    prev = _MODE
    set_mode(mode_)
    try:
        yield
    finally:
        _MODE = prev


def sharded_available() -> bool:
    """True when sharded dispatch may run: a usable mesh and not forced off."""
    return _MODE != "off" and data_mesh() is not None


_COUNTS: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()


def _count(op: str) -> None:
    with _COUNTS_LOCK:
        _COUNTS[op] = _COUNTS.get(op, 0) + 1


def dispatch_counts() -> Dict[str, int]:
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_dispatch_counts() -> None:
    with _COUNTS_LOCK:
        _COUNTS.clear()


# --------------------------------------------------------------------------- #
# sharded placement helpers                                                    #
# --------------------------------------------------------------------------- #


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def _padded_layout(nparts: int, mesh: DataMesh) -> Tuple[int, int, int]:
    """(Ppad, pl, d): partitions padded to a pow-2 multiple of the device
    count, pl = Ppad // d contiguous partitions per device."""
    d = len(mesh)
    ppad = _next_pow2(max(nparts, d))
    return ppad, ppad // d, d


def _common_bucket(nrows: Sequence[int]) -> int:
    """Shared row bucket for a stack of partitions: the largest partition's
    pad bucket, at least one masked_stats tile.  Every kernel treats the
    extra padding as an exact no-op (masked_stats: all-masked tiles;
    segment_reduce: invalid rows drop before its stable sort; topk: the
    losing sentinel)."""
    mx = max((int(n) for n in nrows), default=0)
    return max(ops.pad_len(mx), TILE)


def _shard_parts(s: int, pl: int, nparts: int) -> range:
    """Global indices of the real partitions shard ``s`` holds."""
    return range(s * pl, min((s + 1) * pl, nparts))


def stack_rows(mesh: DataMesh, nparts: int, nb: int, width: int, dtype: torch.dtype,
               fill, rows) -> Tuple[torch.Tensor, ...]:
    """Per-partition rows stacked onto the mesh: one ``(pl, width, nb)``
    tensor of ``fill`` per shard on ``mesh[s]``, partition ``s*pl + p``'s
    rows written at ``[p, :, :n]`` from ``rows(i, dev)`` (``width`` tensors
    of its ``n`` rows each, on ``dev``).  Partitions at or past ``nparts``
    stay all ``fill``."""
    _, pl, _ = _padded_layout(nparts, mesh)
    out = []
    for s, dev in enumerate(mesh):
        t = torch.full((pl, width, nb), fill, dtype=dtype, device=dev)
        for i in _shard_parts(s, pl, nparts):
            for j, row in enumerate(rows(i, dev)):
                t[i - s * pl, j, : row.shape[0]] = row
        out.append(t)
    return tuple(out)


def mesh_cached(table, slot: str, key, build, keep_none: bool = True):
    """``build()`` for ``key`` on the current mesh, cached on the immutable
    ``table``: one entry per ``slot``, which a new key or mesh replaces (the
    device stacks are as large as the table).  A ``None`` from ``build`` is
    kept only under ``keep_none``."""
    full = (key, data_mesh())
    cache = table.__dict__.setdefault("_mesh_cache", {})
    hit = cache.get(slot)
    if hit is None or hit[0] != full:
        value = build()
        if value is None and not keep_none:
            return None
        hit = cache[slot] = (full, value)
    return hit[1]


# --------------------------------------------------------------------------- #
# ShardedPTable — device-resident stats stack                                  #
# --------------------------------------------------------------------------- #


@dataclass
class ShardedPTable:
    """A PTable's numeric column blocks, device-resident along ``data``:
    ``xs[s]`` / ``ms[s]`` are shard ``s``'s ``(pl, C, nb)`` value/validity
    matrices on ``mesh[s]``, partition ``s*pl + p`` of the host table at row
    ``p`` (rows at or past nparts are all masked — exact-neutral padding)."""

    mesh: DataMesh
    names: Tuple[str, ...]
    xs: Tuple[torch.Tensor, ...]  # d × (pl, C, nb) f32
    ms: Tuple[torch.Tensor, ...]  # d × (pl, C, nb) bool
    nparts: int
    ppad: int
    pl: int
    nb: int

    @classmethod
    def from_table(cls, table, names: Sequence[str]) -> Optional["ShardedPTable"]:
        """Build (or fetch the cached) sharded stats stack for ``table``.
        Returns ``None`` when no mesh is available or the table has no
        partitions/columns to stack.  Cached on the immutable table.  Each
        shard is filled on its device from the columns' device copies
        (the same float32 conversion the host path's stack makes)."""
        from .backend import _dev_f32, _dev_valid  # the column device cache

        mesh = data_mesh()
        if mesh is None:
            return None
        key = tuple(names)
        parts = table.partitions

        def build():
            if not parts or not key:
                return None
            for part in parts:
                for name in key:
                    col = part.columns.get(name)
                    if col is None or col.is_string:
                        return None
            ppad, pl, _ = _padded_layout(len(parts), mesh)
            nb = _common_bucket([p.nrows for p in parts])

            def stack(dtype, row):
                return stack_rows(mesh, len(parts), nb, len(key), dtype, 0, lambda i, dev: [
                    row(parts[i].columns[name], dev) for name in key])

            return cls(mesh=mesh, names=key, xs=stack(torch.float32, _dev_f32),
                       ms=stack(torch.bool, _dev_valid), nparts=len(parts), ppad=ppad,
                       pl=pl, nb=nb)

        return mesh_cached(table, "stats", key, build)


# --------------------------------------------------------------------------- #
# exact ColStats merge, replayed in float64 torch ops                          #
# --------------------------------------------------------------------------- #


def _pymin(a, b):
    """Python's ``min(a, b)``: ``a`` unless ``b < a`` (NaN and ±0 kept as
    the builtin keeps them)."""
    return torch.where(b < a, b, a)


def _pymax(a, b):
    return torch.where(b > a, b, a)


def _merge_colstats(a, b):
    """torch replica of ColStats.merge, vectorised over columns: the same
    expressions in the same association order, and the host's ``n == 0``
    identities taken whole (an empty operand returns the other as it is).
    NaNs from the 0/0 division in an unselected branch are discarded by
    the select."""
    an, am, am2, amn, amx = a
    bn, bm, bm2, bmn, bmx = b
    n = an + bn
    delta = bm - am
    mean = am + delta * bn / n
    m2 = am2 + bm2 + delta * delta * an * bn / n
    b_empty, a_empty = bn == 0, an == 0

    def pick(x_a, x_b, merged):
        return torch.where(b_empty, x_a, torch.where(a_empty, x_b, merged))

    return (pick(an, bn, n), pick(am, bm, mean), pick(am2, bm2, m2),
            pick(amn, bmn, _pymin(amn, bmn)), pick(amx, bmx, _pymax(amx, bmx)))


def _pairwise_tree(stats):
    """Balanced adjacent-pair reduction over axis 0 (length must be pow-2) —
    the host _pairwise_merge tree, one level per halving."""
    size = stats[0].shape[0]
    while size > 1:
        a = tuple(t[0::2] for t in stats)
        b = tuple(t[1::2] for t in stats)
        stats = _merge_colstats(a, b)
        size //= 2
    return tuple(t[0] for t in stats)


def _stats_from_raw(raw64):
    """torch replica of backend._stats_from_raw: (…, 5) f64 raw rows of
    (count, sum, m2, min, max) → (n, mean, m2, mn, mx) component tensors;
    a count-0 row is the host's empty ColStats(0, 0, 0, +inf, −inf)."""
    n = raw64[..., 0]
    empty = n == 0
    mean = torch.where(empty, 0.0, raw64[..., 1] / torch.where(empty, 1.0, n))
    m2 = raw64[..., 2]
    m2 = torch.where(empty | (m2 < 0.0), 0.0, m2)  # the host's max(m2, 0.0)
    mn = torch.where(empty, float("inf"), raw64[..., 3])
    mx = torch.where(empty, float("-inf"), raw64[..., 4])
    return (n, mean, m2, mn, mx)


# --------------------------------------------------------------------------- #
# sharded dispatches                                                           #
# --------------------------------------------------------------------------- #


def _shard_raws(st: ShardedPTable, s: int, backend: str) -> torch.Tensor:
    """Shard ``s``'s per-partition (count, sum, m2, min, max) f32 raws,
    (pl, C, 5) on ``mesh[s]``: one masked_stats call over its pl × C rows
    under the kernel backend ``backend``, each row bit for bit the host
    path's row for that partition under the same backend."""
    C = len(st.names)
    with ops.local_backend(backend):
        raw = ops.masked_stats_batch(
            st.xs[s].reshape(st.pl * C, st.nb), st.ms[s].reshape(st.pl * C, st.nb)
        )
    return raw.reshape(st.pl, C, 5)


def stats_combined(st: ShardedPTable, backend: str = "cuda") -> np.ndarray:
    """Per-partition fused stats on every shard + the exact combine.  Returns
    (C, 5) f64 rows of (n, mean, m2, min, max) — the merged ColStats for each
    column, bit-for-bit the host pairwise merge of per-partition kernel
    partials: each shard folds its pow-2 subtree on its own device, and the
    d subtree roots are gathered onto ``mesh[0]`` for the last levels."""
    roots = [
        _pairwise_tree(_stats_from_raw(_shard_raws(st, s, backend).to(torch.float64)))
        for s in range(len(st.mesh))
    ]
    top = tuple(
        torch.stack([r[f].to(st.mesh[0]) for r in roots]) for f in range(5)
    )  # 5 × (d, C)
    out = torch.stack(_pairwise_tree(top), dim=1).cpu().numpy()
    _count("stats")
    return out


def stats_raws(st: ShardedPTable, backend: str = "cuda") -> np.ndarray:
    """One call covering every partition: per-partition (count, sum, m2,
    min, max) f32 raws, (Ppad, C, 5) — the sharded flavor of the executor's
    UnitBatch (k partitions × d devices in one call).  Rows are bit-identical
    to the host per-partition kernel, so slicing row i and feeding it through
    backend._stats_from_raw reproduces the host partial exactly."""
    raws = [_shard_raws(st, s, backend) for s in range(len(st.mesh))]
    out = torch.cat([r.to(st.mesh[0]) for r in raws]).cpu().numpy()
    _count("stats_raws")
    return out


def _fold_rows(acc: torch.Tensor, r: torch.Tensor, mode_: str) -> torch.Tensor:
    """One step of the host combine's ``np.{add,minimum,maximum}.at``:
    numpy's ``minimum(a, b)`` is ``a`` when ``a <= b`` or ``a`` is NaN, else
    ``b`` (NaN propagates, ±0 as numpy keeps them)."""
    if mode_ == "sum":
        return acc + r
    if mode_ == "min":
        return torch.where((acc <= r) | torch.isnan(acc), acc, r)
    return torch.where((acc >= r) | torch.isnan(acc), acc, r)


def segment_fold(
    mesh: DataMesh,
    keys: Sequence[torch.Tensor],    # d × (pl, nb) i32
    values: Sequence[torch.Tensor],  # d × (pl, S, nb) f32
    valids: Sequence[torch.Tensor],  # d × (pl, V, nb) bool
    nbuckets: int,
    modes: Tuple[str, ...],
    valid_idx: Tuple[int, ...],
    pl: int,
    nparts: int,
    backend: str = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-partition segment reductions on every shard + the exact fold in
    global partition order.  Returns (reds (S, B) f64, cnts (V, B) i64) —
    feed through backend._groupby_from_raw / _vc_from_raw as ONE synthetic
    partial.  Counts are an exact integer sum (each shard sums its own, then
    the shards' sums are added on ``mesh[0]``).  The host combine folds the
    reductions left to right in partition order (``np.add.at`` over the
    partials' present buckets), so every partition's reductions are gathered
    onto ``mesh[0]`` and folded in that order, a bucket taking a partition's
    value only where that partition holds the key."""
    S = len(modes)
    shard_reds, shard_cnts = [], []
    for s in range(len(mesh)):
        reds_l, cnts_l = [], []
        with ops.local_backend(backend):
            for i in _shard_parts(s, pl, nparts):
                p = i - s * pl
                r, c = ops.segment_reduce_batch(
                    keys[s][p], list(values[s][p]), list(valids[s][p]),
                    nbuckets, modes, valid_idx,
                )
                reds_l.append(r)
                cnts_l.append(c)
        shard_reds.append(reds_l)
        shard_cnts.append(cnts_l)
    dev0 = mesh[0]
    cnts = sum(
        torch.stack(c).to(torch.int64).sum(0).to(dev0) for c in shard_cnts if c
    )
    out_cnts = cnts.cpu().numpy()
    if S == 0:
        _count("value_counts")
        return np.zeros((0, nbuckets)), out_cnts
    racc = torch.stack([
        torch.full((nbuckets,), {"sum": 0.0, "min": np.inf, "max": -np.inf}[m],
                   dtype=torch.float64, device=dev0)
        for m in modes
    ])
    for reds_l, cnts_l in zip(shard_reds, shard_cnts):
        for r, c in zip(reds_l, cnts_l):
            r = r.to(dev0).to(torch.float64)
            present = c[0].to(dev0) > 0
            racc = torch.stack([
                torch.where(present, _fold_rows(racc[j], r[j], modes[j]), racc[j])
                for j in range(S)
            ])
    out_reds = racc.cpu().numpy()
    _count("groupby")
    return out_reds, out_cnts


def topk_winners(
    mesh: DataMesh, stack: Sequence[torch.Tensor], k: int, largest: bool,
    backend: str = "cuda",
) -> np.ndarray:
    """Per-partition top-k winner values for every partition, (Ppad, k) f32:
    one topk call per shard over its (pl, nb) rows, padded with the losing
    sentinel.  Only winners[-1] (the per-partition k-th value) is consumed —
    backend._limit_select does the host-side candidate pick, so results stay
    bit-identical to the per-partition topk path."""
    with ops.local_backend(backend):
        wins = [ops.topk_rows(x, k, largest) for x in stack]
    out = torch.cat([w.to(mesh[0]) for w in wins]).cpu().numpy()
    _count("topk")
    return out


# --------------------------------------------------------------------------- #
# partition-parallel join: sharded sorted build + local probe + summed combine #
# --------------------------------------------------------------------------- #

_DUP = "join: right-side keys must be unique (dim-table join)"


@dataclass
class ShardedJoinBuild:
    """The right side's valid (key, row-id) pairs, range-free: cut into d
    contiguous slices, each sorted on its own device.  Intra-shard duplicate
    keys are rejected at build; duplicates straddling shards surface at probe
    time through the summed hit count."""

    mesh: DataMesh
    keys_sorted: Tuple[torch.Tensor, ...]  # d × (m_s,), each ascending, on mesh[s]
    ids_sorted: Tuple[torch.Tensor, ...]   # d × (m_s,) int64 row ids


def join_build(keys: np.ndarray, ids: np.ndarray) -> ShardedJoinBuild:
    """Shard the right side's keys (already in the probe's key type, valid
    rows only) across ``data`` and sort each shard on its own device — the
    build never materialises a single sorted array on one device.  Raises on
    intra-shard duplicate keys (dim-table contract)."""
    mesh = data_mesh()
    if mesh is None:
        raise RuntimeError("join_build: no data mesh")
    d = len(mesh)
    bounds = np.linspace(0, len(keys), d + 1).astype(np.int64)
    ks_l, ids_l = [], []
    for s, dev in enumerate(mesh):
        a, b = bounds[s], bounds[s + 1]
        k = torch.from_numpy(np.ascontiguousarray(keys[a:b])).to(dev)
        ks, order = torch.sort(k, stable=True)
        ks_l.append(ks)
        ids_l.append(torch.from_numpy(np.ascontiguousarray(ids[a:b])).to(dev)[order])
    _count("join_build")
    dups = [(ks[1:] == ks[:-1]).any() for ks in ks_l if len(ks) > 1]
    if any(bool(x) for x in dups):  # one wait, after every shard's sort
        raise ValueError(_DUP)
    return ShardedJoinBuild(mesh=mesh, keys_sorted=tuple(ks_l), ids_sorted=tuple(ids_l))


def join_probe(
    build: ShardedJoinBuild, l_keys: Sequence[torch.Tensor], backend: str = "cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """Probe the replicated left keys (``l_keys[s]`` on ``mesh[s]``) against
    every shard with join_probe; combine with two sums on
    ``mesh[0]`` (hit count + hit row-id — only the owning shard contributes).
    Returns (gather row-ids, hit) for the left partition.  A summed hit count
    > 1 means duplicate right keys straddled shards: same ValueError the host
    build raises, just detected at first probe."""
    shards = []
    with ops.local_backend(backend):
        for ks, ids, lk in zip(build.keys_sorted, build.ids_sorted, l_keys):
            if len(ks):
                pos, hit = ops.join_probe_padded(ks, lk)
                shards.append((hit.to(torch.int32), torch.where(hit, ids[pos.long()], 0)))
    _count("join_probe")
    n = int(l_keys[0].shape[0])
    if not shards:
        return np.zeros(n, np.intp), np.zeros(n, bool)
    dev0 = build.mesh[0]
    hitc = sum(h.to(dev0) for h, _ in shards).cpu().numpy()
    gid = sum(g.to(dev0) for _, g in shards)
    if (hitc > 1).any():
        raise ValueError(_DUP)
    return gid.cpu().numpy().astype(np.intp), hitc == 1


# --------------------------------------------------------------------------- #
# seed API (kept): the original formulations, as plain functions over a mesh  #
# --------------------------------------------------------------------------- #


def masked_stats_local(x: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Single-pass fused stats over a masked column (the `masked_stats`
    kernel's contract): (count, sum, m2, min, max), where m2 is the centered
    second moment Σ m·(x − local mean)² — a raw sum of squares cancels
    catastrophically when |mean| ≫ std."""
    m = mask.to(x.dtype)
    n = m.sum()
    s = (x * m).sum()
    mean = s / n.clamp(min=1)
    d = (x - mean) * m
    m2 = (d * d).sum()
    big = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    mn = torch.where(mask, x, big).min()
    mx = torch.where(mask, x, -big).max()
    return n, s, m2, mn, mx


def shard_column(mesh: DataMesh, x) -> Tuple[torch.Tensor, ...]:
    """Place a host column onto the mesh: ``len(mesh)`` equal contiguous
    slices, slice ``s`` on ``mesh[s]`` (the length must divide evenly)."""
    x = torch.as_tensor(x)
    if x.shape[0] % len(mesh):
        raise ValueError(f"shard_column: {x.shape[0]} rows over {len(mesh)} shards")
    return tuple(c.to(dev) for c, dev in zip(x.chunk(len(mesh)), mesh))


def make_distributed_describe(mesh: DataMesh):
    """describe over a column sharded along the mesh: a local fused pass on
    each shard, then the sums gathered onto ``mesh[0]``.

    Per-shard moments about the local mean are combined with the parallel
    (Chan-style) variance formula: total m2 = Σ_i (m2_i + n_i·(mean_i −
    mean)²), the second sum once the global mean is known.

    Returns fn (x, mask) -> (count, mean, std, min, max) on ``mesh[0]``."""

    def fn(x, mask):
        loc = [masked_stats_local(xs, ms)
               for xs, ms in zip(shard_column(mesh, x), shard_column(mesh, mask))]
        dev0 = mesh[0]
        n_l, s_l, m2_l, mn_l, mx_l = (
            torch.stack([t[f].to(dev0) for t in loc]) for f in range(5)
        )
        n, s = n_l.sum(), s_l.sum()
        mean = s / n.clamp(min=1)
        delta = s_l / n_l.clamp(min=1) - mean
        m2 = (m2_l + delta * delta * n_l).sum()
        var = m2.clamp(min=0.0) / n.clamp(min=1)
        std = torch.sqrt(var * n / (n - 1).clamp(min=1))
        return torch.stack([n, mean, std, mn_l.min(), mx_l.max()])

    return fn


def make_distributed_groupby_sum(mesh: DataMesh, n_buckets: int):
    """groupby-sum with integer keys in [0, n_buckets): a local segment sum
    into a dense bucket vector on each shard (the `segment_reduce` kernel's
    contract), then the shards' vectors summed on ``mesh[0]``.

    Returns fn (keys:int32[n], values:f32[n], valid:bool[n])
    -> (sums[f32,B], counts[f32,B])."""

    def fn(keys, values, valid):
        sums, counts = [], []
        for k, v, m in zip(shard_column(mesh, keys), shard_column(mesh, values),
                           shard_column(mesh, valid)):
            z = torch.zeros(n_buckets, dtype=v.dtype, device=v.device)
            sums.append(z.index_add(0, k.long(), torch.where(m, v, 0.0)).to(mesh[0]))
            counts.append(z.index_add(0, k.long(), m.to(v.dtype)).to(mesh[0]))
        return torch.stack(sums).sum(0), torch.stack(counts).sum(0)

    return fn
