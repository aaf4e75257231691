#!/usr/bin/env python3
"""CPU rehearsal of a cell: the whole run (content, warm-up, the closed
loop, the wrappers of a traced run, the comparison and the metric
readers) with ``device="cpu"`` at a small frame size. It prints what the
run found to standard error and no metric line: a CPU run measures
nothing of the card.

    python3 vcpbench/rehearse.py --workload nvenc-pan [--size 96x64]
"""

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--size", default="96x64", help="WxH")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--control", action="store_true",
                    help="run the configuration's control_args")
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from vcpbench import bench, spec
    w, h = (int(x) for x in a.size.split("x"))
    args = (spec.load_cell(a.workload).config["control_args"]
            if a.control else None)
    r = bench.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                       device="cpu", size=(w, h), program_args=args)
    if r is None:
        return 1
    keep = ("correct", "attempted", "failed", "checks")
    print("rehearsal: " + json.dumps({k: r[k] for k in keep}),
          file=sys.stderr)
    return 0 if r["correct"] or a.control else 2


if __name__ == "__main__":
    sys.exit(main())
