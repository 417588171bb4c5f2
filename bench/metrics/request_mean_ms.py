"""All wall time inside ``OpportunisticServer.request`` in the window (the
call to every output token on the host) over the number of requests, ms."""


def read(out):
    spans = out.rec.of("request")
    return 1e3 * sum(s.seconds for s in spans) / len(spans) if spans else None
