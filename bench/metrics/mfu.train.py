"""Model FLOPs (6 N per token trained: forward and backward, the remat's
second forward not counted) of the steps in the profiled part over
(its length x the H100's bf16 peak), %."""
from harness import arith


def read(out):
    dt = out.rec.device_trace
    steps = dt.spans_of("step") if dt else []
    if not steps or dt.window_s <= 0:
        return None
    tokens = out.data["seq"] * len(steps)
    return 100.0 * 6 * out.data["params"] * tokens / (dt.window_s * arith.PEAK_BF16_FLOPS)
