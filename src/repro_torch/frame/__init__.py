"""repro_torch.frame — partitioned columnar dataframes on PyTorch.

The substrate the paper's opportunistic evaluation schedules over: deferred
DataFrame API, notebook-cell parser, per-partition preemptible operators,
think-time-aware partitioning, and a kernel backend that runs the blocking
partials on an H100 with hand-written CUDA kernels.
"""
from .api import ColumnRef, DataFrame, GroupBy, Predicate, ScalarHandle, Session
from .backend import BackendPolicy, active_backend, set_frame_backend, use_backend
from .io import Catalog, ColSpec, TableSpec, default_catalog
from .parser import CellRunner
from .partitioner import plan_partitions, uniform_partitions
from .runtime import FrameRuntime, install
from .table import Column, PTable, Partition, from_pydict

__all__ = [
    "Session", "DataFrame", "ColumnRef", "GroupBy", "Predicate", "ScalarHandle",
    "Catalog", "TableSpec", "ColSpec", "default_catalog", "CellRunner",
    "plan_partitions", "uniform_partitions", "FrameRuntime", "install",
    "Column", "Partition", "PTable", "from_pydict",
    "BackendPolicy", "active_backend", "set_frame_backend", "use_backend",
]
