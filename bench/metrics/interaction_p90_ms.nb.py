"""The 90th percentile of the interaction walls of the traced run, in ms."""
from harness import arith


def read(out):
    spans = out.rec.of("interaction")
    return 1e3 * arith.percentile([s.seconds for s in spans], 90) if spans else None
