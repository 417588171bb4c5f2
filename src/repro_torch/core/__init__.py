"""repro.core — opportunistic evaluation (the paper's contribution).

Public surface:

* :class:`~repro.core.engine.Engine` — the opportunistic-evaluation kernel
* :class:`~repro.core.dag.DAG` / :class:`~repro.core.dag.Node` — operator DAG IR
* :mod:`~repro.core.slicing` — interaction critical paths
* :class:`~repro.core.scheduler.Scheduler` — think-time scheduling (Eq 1/4)
* :class:`~repro.core.cache.MaterializedCache` — eviction by Eq 2/3
* :class:`~repro.core.speculation.SpeculationManager` — speculative materialisation
* :class:`~repro.core.thinktime.ThinkTimeModel` — lognormal think-time model
"""
from .cache import MaterializedCache, result_nbytes
from .clock import RealClock, VirtualClock
from .costmodel import CostModel
from .cse import intern_program, merge_common_subexpressions
from .dag import DAG, Node, DEFAULT_INTERACTION_OPS, PARAMETRIC_OPS
from .engine import Engine, Metrics
from .executor import OpRuntime, PartialProgress, Preempted, Registry, Unit
from .faults import (
    CorruptResult,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    InjectedResourceExhausted,
)
from .predictor import InteractionPredictor
from .scheduler import Scheduler
from .slicing import (
    count_non_critical_before,
    critical_path,
    non_critical,
    source_operators,
    unexecuted_critical,
)
from .speculation import SpeculationManager
from .thinktime import ThinkTimeModel

__all__ = [
    "DAG", "Node", "Engine", "Metrics", "OpRuntime", "Unit", "Registry",
    "Preempted", "PartialProgress", "MaterializedCache", "CostModel",
    "Scheduler", "SpeculationManager", "ThinkTimeModel", "InteractionPredictor",
    "RealClock", "VirtualClock", "critical_path", "non_critical",
    "source_operators", "unexecuted_critical", "count_non_critical_before",
    "merge_common_subexpressions", "intern_program", "result_nbytes",
    "DEFAULT_INTERACTION_OPS", "PARAMETRIC_OPS",
    "FaultPlan", "FaultSpec", "InjectedFault", "InjectedResourceExhausted",
    "CorruptResult",
]
