"""Share (%) of interactions whose displayed node, or the frame it reads
(the node the cell's specification ops end in), was in the engine's
materialised cache when the call began: work done ahead, in think time or
by an earlier cell."""


def read(out):
    spans = out.rec.of("interaction")
    return 100.0 * sum(bool(s.attrs["hit"]) for s in spans) / len(spans) if spans else None
