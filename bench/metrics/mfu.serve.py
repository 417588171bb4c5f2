"""Model FLOPs (2 N a token) of every token prefilled (in requests and in
think time) and decoded in the profiled part, over (its length x the
H100's bf16 peak), %."""
from harness import arith


def read(out):
    dt = out.rec.device_trace
    if not dt or dt.window_s <= 0:
        return None
    traced = {i for _, i, _, _ in dt.spans}
    tokens = 0
    for s in out.rec.spans:
        if s.index not in traced:
            continue
        if s.kind == "request":
            tokens += s.attrs["n_tokens"] + (0 if s.attrs["hit"] else s.attrs["length"])
        elif s.kind == "think":
            tokens += s.attrs["prefilled"]
    if not tokens:
        return None
    return 100.0 * 2 * out.data["params"] * tokens / (dt.window_s * arith.PEAK_BF16_FLOPS)
