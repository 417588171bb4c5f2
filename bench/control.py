"""Readings of a cell's control, and of the faults its comparison has to
catch, on the card at the cell's own size: one JSON line a seed.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...]

The control is the plain reference put in the program's place at the
precision just below the one the configuration states (``control`` in the
cell's kind, ``bench/kinds/<kind>.py``).  Its readings set the upper end
of each limit in the configuration file; the benchmark's own runs never run
it.
"""
import json
import sys

import run  # noqa: F401  (the caches inside the checkout, and the import paths)
from harness import cli, spec


def main(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3,
                    help="read the control and the faults on the first this many seeds "
                         "(the program's readings, where the kind gives them, on all)")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload, spec.load_benchmark())
    cli.require_cards(cell.chips)
    kind = spec.kind_module(cell.traffic["kind"])
    for i, seed in enumerate(args.seeds):
        readings = kind.control(cell, seed, device="cuda", faults=i < args.faults)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "readings": {k: {n: v for n, (v, _) in c.items()}
                                       for k, c in readings.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
