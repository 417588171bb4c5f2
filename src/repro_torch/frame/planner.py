"""Cost-based backend planner: the estimate/perform split for frame dispatch.

Backend selection by precedence (per-call > global > env > engine default)
says which backend a dispatch may use; this module decides per (op, size)
whether the kernel backend or the numpy reference should serve it, from the
per-(op, backend) unit costs the calibration machinery fits from every
dispatch.

For each dispatch the planner:

1. only engages at the tiers it governs — an explicit per-call ``backend=``,
   a ``use_backend`` global, or the ``REPRO_TORCH_FRAME_BACKEND`` env var is
   an override ABOVE the planner and bypasses it entirely;
2. queries :meth:`CostModel.estimate` (affine: ``unit_cost × rows +
   overhead``) for every candidate backend — the engine's configured kernel
   backend and the numpy reference;
3. skips candidates whose circuit breaker is not closed
   (:meth:`BreakerBoard.is_closed` — a read-only gate, no probe grant);
4. picks the cheapest candidate; when a key has no calibration yet it falls
   back to the *cold-start priors* below, and with neither it defers to the
   precedence chain unchanged;
5. records every decision in ``CostModel.planner_decisions``.

The same estimates drive *fusion*: a linear chain (filter → stats,
filter → groupby, filter → topk) is lowered as one composite when the fused
estimate beats the summed unfused estimates (see ``FrameRuntime``'s
``try_fused`` hooks and ``kernels.ops``'s ``filter_then_*`` entry points).
A chain is never fused blind, so without priors or calibration of the fused
key it runs unfused.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..core.costmodel import CostModel
from ..core.dag import Node

# --------------------------------------------------------------------------- #
# Cold-start priors                                                            #
#                                                                              #
# (op-key, backend) -> (seconds/row, fixed overhead seconds).  Empty: the     #
# JAX package's priors were CPU bench verdicts and say nothing about an H100, #
# so every uncalibrated key defers to the precedence chain until fits from    #
# the card exist (CostModel.estimate wins over a prior once samples exist).   #
# --------------------------------------------------------------------------- #

COLD_START_PRIORS: Dict[Tuple[str, str], Tuple[float, float]] = {}

# The keys the planner governs.
PLANNED_KEYS = frozenset(
    {
        "describe",
        "groupby_agg",
        "value_counts",
        "sort_values:full",
        "sort_values:topk",
        "filter",
        "join",
    }
)

# ops whose node.op maps 1:1 onto a calibration key; everything else passes
# through unchanged (the planner just won't have priors for it)
_FILTER_FAMILY = ("filter", "filter_cmp", "isin", "between", "dropna")


def planner_key(node: Node) -> str:
    """The calibration/planning key for a dispatch of ``node``.

    Mostly ``node.op``; sort_values splits into ``:topk`` / ``:full`` —
    the two regimes have opposite backend verdicts and must not share a
    fitted unit cost.  The filter family shares the ``filter`` key (same
    compaction kernel regardless of predicate flavour), and mean /
    mean_scalar share ``describe`` (all three run the identical
    partial_stats unit, so their samples calibrate one curve)."""
    if node.op == "sort_values":
        return (
            "sort_values:topk" if node.kwargs.get("limit") else "sort_values:full"
        )
    if node.op in _FILTER_FAMILY:
        return "filter"
    if node.op in ("mean", "mean_scalar"):
        return "describe"
    return node.op


# breaker state is keyed by kernel op *family* (see backend._guarded call
# sites), not by node op — map planning keys onto the breaker namespace
_BREAKER_OP = {
    "describe": "stats",
    "mean": "stats",
    "mean_scalar": "stats",
    "groupby_agg": "groupby",
    "value_counts": "value_counts",
    "sort_values:full": "sort",
    "sort_values:topk": "topk",
    "filter": "filter",
    "join": "join",
    "fused:filter|describe": "fused_stats",
    "fused:filter|groupby_agg": "fused_groupby",
    "fused:filter|sort_values:topk": "fused_topk",
}


class Planner:
    """Estimate/perform backend planning for one engine's frame runtime.

    ``choose(key, rows, default)`` returns the backend the dispatch should
    request.  Candidates are the precedence-resolved default (the engine's
    kernel backend) and ``"numpy"`` — the planner can *demote* a dispatch
    to the host path when the estimates say the kernel loses, but never
    promotes past what the precedence chain configured (an explicit
    stronger override tier bypasses the planner entirely; see
    ``FrameRuntime``).
    """

    def __init__(
        self,
        cost_model: CostModel,
        board=None,  # BreakerBoard (duck-typed: .is_closed(op, bk))
        enabled: bool = True,
        fusion: bool = True,
        use_priors: bool = True,
    ):
        self.cost_model = cost_model
        self.board = board
        self.enabled = enabled
        self.fusion = fusion
        self.use_priors = use_priors

    # ---------------------------------------------------------------- costs --
    def estimate(self, key: str, backend: str, rows: float) -> Optional[float]:
        """Fitted estimate if the key is calibrated, else the cold-start
        prior, else None (the caller falls back to precedence)."""
        est = self.cost_model.estimate(key, backend, rows)
        if est is not None:
            return est
        if self.use_priors:
            prior = COLD_START_PRIORS.get((key, backend))
            if prior is not None:
                a, b = prior
                return a * max(float(rows), 0.0) + b
        return None

    def _available(self, key: str, backend: str) -> bool:
        if backend == "numpy" or self.board is None:
            return True  # the host reference is always available
        return self.board.is_closed(_BREAKER_OP.get(key, key), backend)

    # --------------------------------------------------------------- choose --
    def choose(self, key: str, rows: float, default: str) -> str:
        """Cheapest available backend among {default, numpy} by estimate.

        Falls back to ``default`` (the precedence chain's answer) when the
        key has no calibration and no prior — the planner must never guess
        on keys it knows nothing about."""
        if not self.enabled or default == "numpy" or key not in PLANNED_KEYS:
            return default
        if not self._available(key, default):
            self.cost_model.note_planner_decision(key, "numpy", "breaker_open")
            return "numpy"
        est_default = self.estimate(key, default, rows)
        est_numpy = self.estimate(key, "numpy", rows)
        if est_default is None or est_numpy is None:
            self.cost_model.note_planner_decision(key, default, "no_estimate")
            return default
        if est_numpy < est_default:
            self.cost_model.note_planner_decision(key, "numpy", "estimated")
            return "numpy"
        self.cost_model.note_planner_decision(key, default, "estimated")
        return default

    # ---------------------------------------------------------------- fusion --
    def choose_fusion(
        self, fused_key: str, backend: str, rows: float, unfused_keys,
    ) -> bool:
        """Lower a linear chain as one fused composite?  True when the fused
        estimate beats the sum of the unfused stages' estimates, each stage
        costed at its own planner-chosen backend (the honest alternative).
        ``rows`` is the *unfiltered* input size — an upper bound for every
        stage, so the comparison is conservative for the unfused side too."""
        if not self.enabled or not self.fusion:
            return False
        if not self._available(fused_key, backend):
            return False
        est_fused = self.estimate(fused_key, backend, rows)
        if est_fused is None:
            return False  # never fuse blind
        est_unfused = 0.0
        for key in unfused_keys:
            cands = [
                e
                for bk in (backend, "numpy")
                if self._available(key, bk)
                and (e := self.estimate(key, bk, rows)) is not None
            ]
            if not cands:
                return False
            est_unfused += min(cands)
        if est_fused < est_unfused:
            self.cost_model.note_planner_decision(fused_key, backend, "fused")
            return True
        self.cost_model.note_planner_decision(fused_key, backend, "unfused")
        return False
