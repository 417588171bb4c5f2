"""repro_torch.data — deterministic synthetic streams + prefetching loader."""
from .loader import PrefetchLoader
from .synth import (
    SynthSpec,
    TraceEvent,
    TraceSpec,
    batch_at,
    make_iterator,
    poisson_trace,
    spec_for,
)
