"""Share (%) of requests whose prefill was materialised, in think time,
when the request began."""


def read(out):
    spans = out.rec.of("request")
    return 100.0 * sum(bool(s.attrs["hit"]) for s in spans) / len(spans) if spans else None
