#!/usr/bin/env python3
"""Benchmark of vcp_tpu_torch: one run of one cell on the card.

    python3 vcpbench/run.py --workload nvenc-pan --seed 7 --seconds 45 \
        --trace 0

Run from the root of a checkout. Prints the comparison's numbers beside
their limits as the last lines of standard error, and the result as one
JSON object on the last line of standard output. Exits non-zero, with no
result, without as many CUDA cards as the cell asks for, or when JAX or
the JAX package was loaded.
"""

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from vcpbench import bench
    result = bench.run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    if result is None:
        return 1
    bench.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
