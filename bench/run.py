"""Run one benchmark cell once and print its result as the last line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell is
looked up there by name; see ``bench/harness/spec.py`` for how its
configuration, traffic mix, kind and metrics are found.  Without the
CUDA cards the cell asks for, it exits non-zero and prints no result.
"""
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent

# every compiler cache at a fixed path inside the checkout, set before
# torch or triton is imported (the port's nvcc libraries already build
# into src/repro_torch/kernels/_build/)
os.environ["TRITON_CACHE_DIR"] = str(BENCH / ".cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH / ".cache" / "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")

sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent / "src"))

from harness import clock  # noqa: E402

clock.mark_process_start()

from harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:]))
