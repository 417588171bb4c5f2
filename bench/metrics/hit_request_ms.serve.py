"""Mean wall of the requests whose prefill was already cached (the decode
path alone), ms; nothing where no request hit."""


def read(out):
    spans = [s for s in out.rec.of("request") if s.attrs["hit"]]
    return 1e3 * sum(s.seconds for s in spans) / len(spans) if spans else None
