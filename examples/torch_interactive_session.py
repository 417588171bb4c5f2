"""The paper's §6 case study on the PyTorch / CUDA port, the program of
``examples/interactive_session.py``: critical-path slicing, head/tail
partial results, the Fig 2b group-head pushdown, speculation on filter
tweaking, and Eq 3 cache eviction.

On the CUDA card the groupby runs the ``segment_reduce`` kernel and the
filtered ``describe`` runs ``filter_compact`` and ``masked_stats``;
``--device cpu`` runs the plain PyTorch versions on the CPU instead.

Run:  python examples/torch_interactive_session.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core import ThinkTimeModel
from repro_torch.frame import Catalog, ColSpec, Session, TableSpec


def session_kwargs(device: str) -> dict:
    """The hand-written kernels on the card; the plain versions elsewhere."""
    if device == "cpu":
        return {"kernel_backend": "torch", "device": "cpu"}
    return {"kernel_backend": "cuda", "device": device}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    catalog = Catalog()
    catalog.register(
        TableSpec(
            "application_train",
            nrows=307_511,
            cols=tuple(
                [ColSpec(f"c{i:02d}", null_frac=(0.6 if i % 4 == 0 else 0.05))
                 for i in range(12)]
                + [ColSpec("target", kind="cat", n_categories=2)]
            ),
            io_seconds=18.5,
        )
    )

    session = Session(catalog=catalog, mode="sim", **session_kwargs(args.device))
    think = ThinkTimeModel()
    rng = np.random.default_rng(0)
    answers, latencies = [], []

    def show(code):
        out = session.cell(code)
        recs = session.engine.metrics.interactions
        if recs:
            print(f"[{recs[-1].latency_s*1e3:8.1f} ms] {code.strip()}")
            latencies.append(recs[-1].latency_s)
        answers.append(out)
        session.think(float(think.sample(rng)))
        return out

    print("== case study (paper §6) ==")
    session.cell('data = pd.read_csv("application_train")')
    show("data.columns")                         # metadata: instant
    show("data.head()")                          # partial read: first rows only
    show("data.drop_sparse_cols(0.8).head()")    # debugging the transform
    session.cell("data = data.drop_sparse_cols(0.8)")
    show("data.columns")

    print("\n== Fig 2b: groupby head pushdown ==")
    show('data.groupby("target").mean().head(5)')

    print("\n== speculation: filter-literal tweaking (§5.2) ==")
    for thresh in (0.2, 0.4, 0.6):
        out = session.cell(f'data[data["c01"] > {thresh}].describe()')
        lat = session.engine.metrics.interactions[-1].latency_s
        print(f"[{lat*1e3:8.1f} ms] filter > {thresh}  "
              f"(speculation hits: {session.engine.speculation.hits})")
        answers.append(out)
        latencies.append(lat)
        session.think(10.0)

    m = session.engine.metrics
    print(f"\ntotal synchronous wait: {m.sync_wait_s:.2f}s over "
          f"{len(m.interactions)} interactions "
          f"(think time used: {m.think_s:.0f}s)")
    cache = session.engine.cache.stats()
    print("cache:", cache)
    return {"answers": answers, "latencies": latencies, "cache": cache,
            "speculation_hits": session.engine.speculation.hits, "session": session}


if __name__ == "__main__":
    main()
