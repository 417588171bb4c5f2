"""The summed bound of the SSD forward work the profiled prefills need (in
requests and in think time; ``arith.ssd_forward_need`` at each prompt's
length, whatever route the program takes) over the device time of every
SSD forward kernel (names with ``ssd_`` and not ``ssd_bwd``), %."""
from harness import arith, mamba_ref


def read(out):
    dt = out.rec.device_trace
    if not dt:
        return None
    dm = mamba_ref.dims(out.config["model"])
    traced = {i for _, i, _, _ in dt.spans}
    lengths = []
    for s in out.rec.spans:
        if s.index not in traced:
            continue
        if s.kind == "request" and not s.attrs["hit"]:
            lengths.append(s.attrs["length"])
        elif s.kind == "think":
            lengths += s.attrs.get("prefilled_lengths", [])
    need = dm.layers * sum(arith.bound_s(*arith.ssd_forward_need(S, dm.heads, dm.p, dm.n,
                                                                 dm.chunk)) for S in lengths)
    busy = dt.kernel_s(lambda n: "ssd_" in n and "ssd_bwd" not in n, *dt.window)
    return 100.0 * need / busy if busy > 0 and need > 0 else None
