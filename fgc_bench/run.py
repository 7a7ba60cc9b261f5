"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 fgc_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. See ``fgc_bench/core/runner.py`` for what
a run does and prints, and ``PERF.md`` for the cells and metrics.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # kernel caches at fixed paths inside the checkout (the program builds
    # its CUDA libraries under its own csrc/build there)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(BENCH, ".cache", sub)
    sys.path.insert(0, ROOT)
    from fgc_bench.core.runner import run

    code, _ = run(args.workload, args.seed, args.seconds, bool(args.trace), started=STARTED)
    return code


if __name__ == "__main__":
    sys.exit(main())
