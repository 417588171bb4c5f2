"""The bound of the SSD work the profiled steps need (each layer's forward
once and its backward, from the shapes: ``arith.ssd_forward_need`` and
``arith.ssd_bwd_total``, bf16 operands) over the device time of every SSD
kernel (names with ``ssd_``) in the profiled part, %."""
from harness import arith, mamba_ref


def read(out):
    dt = out.rec.device_trace
    steps = dt.spans_of("step") if dt else []
    if not steps:
        return None
    dm = mamba_ref.dims(out.config["model"])
    S = out.data["seq"]
    fwd = arith.bound_s(*arith.ssd_forward_need(S, dm.heads, dm.p, dm.n, dm.chunk))
    bwd = arith.bound_s(*arith.ssd_bwd_total(1, S, dm.heads, dm.p, dm.n, dm.chunk, 2, dh=False))
    need = len(steps) * dm.layers * (fwd + bwd)
    busy = dt.kernel_s(lambda n: "ssd_" in n, *dt.window)
    return 100.0 * need / busy if busy > 0 else None
