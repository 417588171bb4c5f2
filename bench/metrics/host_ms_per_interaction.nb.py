"""Per interaction in the profiled part, its wall less the time the card
was busy inside it (kernels, copies, sets), in ms: the host's share."""


def read(out):
    dt = out.rec.device_trace
    spans = dt.spans_of("interaction") if dt else []
    if not spans:
        return None
    host = sum((e - s) - dt.busy_s(s, e) for _, s, e in spans)
    return 1e3 * host / len(spans)
