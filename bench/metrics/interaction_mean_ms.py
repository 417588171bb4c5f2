"""All wall time inside the window's interactions (``Session.show`` to the
answer on the host, synchronized), divided by their count, in ms."""


def read(out):
    spans = out.rec.of("interaction")
    return 1e3 * sum(s.seconds for s in spans) / len(spans) if spans else None
