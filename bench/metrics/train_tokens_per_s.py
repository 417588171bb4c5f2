"""All tokens of all steps completed in the window over the window's
length (from its start to the end of its last step), tokens/s."""


def read(out):
    steps = out.rec.of("step")
    if not steps:
        return None
    t0, t1 = out.rec.window
    return sum(s.attrs["tokens"] for s in steps) / (t1 - t0)
