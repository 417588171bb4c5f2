"""Quickstart on the PyTorch / CUDA port: opportunistic evaluation in 40
lines (paper Figure 1), the program of ``examples/quickstart.py``.

Two files; the user inspects the small one while the 18.5 s LARGE_FILE loads
in the background during think time — the paper's headline scenario.  The
``describe`` cells run the ``masked_stats`` kernel on the CUDA card;
``--device cpu`` runs the plain PyTorch versions on the CPU instead.

Run:  python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

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
        TableSpec("small_file", nrows=20_000,
                  cols=(ColSpec("col1"), ColSpec("col2", null_frac=0.1)),
                  io_seconds=1.0)
    )
    catalog.register(
        TableSpec("LARGE_FILE", nrows=500_000,
                  cols=(ColSpec("a"), ColSpec("b", null_frac=0.3)),
                  io_seconds=18.5)
    )

    session = Session(catalog=catalog, mode="sim", **session_kwargs(args.device))
    answers, latencies = [], []

    # ---- cell 1 (the paper's Figure 1a, verbatim program) -------------------
    out = session.cell(
        """
df1 = pd.read_csv("small_file")
df2 = pd.read_csv("LARGE_FILE")
df1.describe()
"""
    )
    print(out)
    lat = session.engine.metrics.interactions[-1].latency_s
    print(f"-> df1.describe() latency: {lat:.3f}s  (eager would pay 19.5 s)\n")
    answers.append(out)
    latencies.append(lat)

    # ---- the user thinks; LARGE_FILE loads opportunistically ----------------
    session.think(23.0)  # 75th-percentile think time from the paper's Fig 3

    # ---- cell 2: the large file is already there ----------------------------
    out = session.cell('df2.describe()')
    print(out)
    lat = session.engine.metrics.interactions[-1].latency_s
    print(f"-> df2.describe() latency: {lat:.3f}s  (18.5 s load hidden in think time)")
    answers.append(out)
    latencies.append(lat)

    metrics = session.engine.metrics.summary()
    print("\nsession metrics:", metrics)
    return {"answers": answers, "latencies": latencies, "metrics": metrics,
            "session": session}


if __name__ == "__main__":
    main()
