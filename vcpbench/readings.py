#!/usr/bin/env python3
"""Readings of the comparison's numbers on many seeds in one process: the
program's, and the control's (the configuration's ``control_args``: its
quantiser one bit coarser). Each seed gets its own content and one task
at the cell's size on the card; the comparisons of ``check.py`` run
beside the next encodes, ``JOBS`` at a time. The limits in
``limits/<workload>.json`` are set from these readings.

    python3 vcpbench/readings.py --workload nvenc-pan --seeds 1,2,3 \
        [--control 1,2]

Prints one JSON line a seed and side to standard output.
"""

import argparse
import concurrent.futures as cf
import json
import os
import shutil
import sys
import tempfile
import time

JOBS = 4            # comparisons at a time, two decode workers each


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", default="",
                    help="comma-separated seeds to read the control on too")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="", help="WxH, for a CPU rehearsal")
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from vcpbench import bench, check, loop, spec
    from vcpbench.content import Content, write_y4m
    cell = spec.load_cell(a.workload)
    if not bench.device_ok(a.device, cell.chips):
        return 1
    size = tuple(int(x) for x in a.size.split("x")) if a.size else None
    cfg, traffic = bench.resized(cell.config, cell.traffic, size)
    controls = {int(s) for s in a.control.split(",") if s}
    n = traffic["loop"]["frames_per_task"]
    tmp = tempfile.mkdtemp(prefix="vcpbench-readings-")

    def judge(seed, side, task):
        t = time.perf_counter()
        res = check.compare([] if task.error else [task.out], cfg, traffic,
                            seed, workers=2)
        return {"workload": a.workload, "seed": seed, "side": side,
                "numbers": res["numbers"], "psnr_db": res["psnr_db"],
                "kbps": res["kbps"], "mse_worst": res.get("mse_worst"),
                "task_s": task.t1 - task.t0,
                "check_s": time.perf_counter() - t,
                "faults": res["faults"][:3] + ([task.error]
                                               if task.error else [])}

    try:
        with cf.ThreadPoolExecutor(JOBS) as pool:
            futs = []
            for k, seed in enumerate(int(s) for s in a.seeds.split(",")):
                src = os.path.join(tmp, "input.y4m")
                write_y4m([(src, n)], Content(traffic["content"],
                                              cfg["width"], cfg["height"],
                                              seed),
                          cfg["fps_num"], cfg["fps_den"])
                if k == 0:          # warm-up
                    loop.run_task(-1, src, tmp, cfg["args"], a.device, n)
                sides = [("program", cfg["args"])]
                if seed in controls:
                    sides.append(("control", cfg["control_args"]))
                for j, (side, args) in enumerate(sides):
                    task = loop.run_task(2 * k + j, src, tmp, args,
                                         a.device, n)
                    futs.append(pool.submit(judge, seed, side, task))
                os.remove(src)
            for f in futs:
                print(json.dumps(f.result()), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
