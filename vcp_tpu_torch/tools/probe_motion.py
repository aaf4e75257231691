"""What bounds the motion-search kernel, and how close it comes.

    python -m vcp_tpu_torch.tools.probe_motion [--no-sass] [--sass-out FILE]
                                               [--sweep]

Prints JSON lines:

* ``ptxas``: registers, spills and shared memory of every kernel of
  ``csrc/motion_search.cu`` and ``csrc/motion_probe.cu`` (``nvcc -Xptxas
  -v``), and for each kernel the count of each SASS opcode (``cuobjdump
  -sass``, written whole to FILE with ``--sass-out``), which shows what
  the compiler made of the absolute-difference sequence;
* ``sequences``: the rate of the candidate absolute-difference sequences
  of ``csrc/motion_probe.cu`` in pixel-offsets per second (CUDA events
  around one wave of resident blocks) and per SM clock, at the SM clock
  that ``nvidia-smi`` reads while the kernel runs;
* ``kernel``: per shape (1088x1920 and 2160x3840) and per table row (sr 8
  with the fused prediction, lam 22; sr 12 search only, lam 8) the time of
  the kernel alone (``device_ms``: 20 launches back to back) beside
  the reference design's, each result checked against the reference
  design, the launch plan, pixel-offsets per SM clock and the bound;
* ``phases``: from a second build with ``-DVCP_MOTION_PROBE``, where one
  launch's time goes (block start times, blocks per SM, SM cycles of a
  block's loads, search and end);
* with ``--sweep``, ``plan_sweep``: the kernel's time at 1088x1920 under
  other launch plans (run length, MBs per block), fastest first.

Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

from .. import device as devmod
from ..ops import motion_cuda

SEQUENCES = (("vabsdiff4_add", 4), ("vabsdiffu4_dp4a", 4),
             ("fp32_sub_absadd", 1), ("int32_sub_abs_add", 1),
             ("vabsdiff4_add_after_funnelshift", 4),
             ("vabsdiff4_add_after_byte_perm", 4),
             ("vabsdiff4_add_after_mulhi_madlo", 4))
SAD_SEQUENCES = 4          # the first four compute a SAD; the others mix
                           # in the kernel's shifts made three ways
ROWS = ((True, 8, 22, "motion_search"), (False, 12, 8, "motion_search_only"))
PEAK_BYTES_S = 3.35e12     # H100 SXM HBM3 (data sheet)


def _probe_lib() -> ctypes.CDLL:
    lib = devmod.kernel_lib("motion_probe.cu")
    if lib.vcp_probe_seq.argtypes is None:
        c_int, vp = ctypes.c_int, ctypes.c_void_p
        lib.vcp_probe_seq.restype = c_int
        lib.vcp_probe_seq.argtypes = [c_int, c_int, c_int, c_int, vp, vp]
        lib.vcp_probe_occupancy.restype = c_int
        lib.vcp_probe_occupancy.argtypes = [c_int, c_int]
        lib.vcp_probe_steps_per_iter.restype = c_int
    return lib


def sequence_rates(dev: torch.device, threads: int = 256,
                   iters: int = 2048) -> dict:
    """Pixel-offsets per second of each candidate sequence over one wave
    of resident blocks (CUDA events around the launch, after a warm-up
    launch)."""
    lib = _probe_lib()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    steps = lib.vcp_probe_steps_per_iter() * iters
    rates = {}
    for seq, (name, po) in enumerate(SEQUENCES):
        occ = lib.vcp_probe_occupancy(seq, threads)
        blocks = n_sm * occ
        sink = torch.empty(blocks * threads, dtype=torch.int32, device=dev)

        def launch():
            err = lib.vcp_probe_seq(seq, blocks, threads, iters,
                                    devmod.ptr(sink), devmod.stream_ptr(sink))
            devmod.check_launch(lib, err, f"probe sequence {name}")
        ms = device_ms(launch, reps=3, batches=3)
        rates[name] = blocks * threads * steps * po / (ms * 1e-3)
    return rates


def per_sm_clock(po_per_s: float, n_sm: int, clock_mhz: float) -> float:
    return po_per_s / (n_sm * clock_mhz * 1e6)


def sm_clocks_mhz(busy, seconds: float = 2.0) -> dict:
    """The SM clock nvidia-smi reads every 100 ms while ``busy()`` is
    called for ``seconds`` (the median of the readings), and the card's
    maximum SM clock."""
    query = ["nvidia-smi", "--format=csv,noheader,nounits"]
    proc = subprocess.Popen([*query, "--query-gpu=clocks.sm", "-lms", "100"],
                            stdout=subprocess.PIPE, text=True)
    t_end = time.monotonic() + seconds
    while time.monotonic() < t_end:
        busy()
    torch.cuda.synchronize()
    proc.terminate()
    readings = [float(v) for v in proc.communicate()[0].split()]
    out = subprocess.run([*query, "--query-gpu=clocks.sm,clocks.max.sm"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    idle, mx = (float(v) for v in out.stdout.strip().splitlines()[0]
                .split(","))
    return {"under_load": statistics.median(readings) if readings else idle,
            "readings": len(readings), "max": mx}


def work(h: int, w: int, sr: int) -> int:
    """Pixel-offsets of an exhaustive search: every MB, every offset, 256
    pixels; the same count whatever implements it."""
    return (h // 16) * (w // 16) * (2 * sr + 1) ** 2 * 256


def bound(h: int, w: int, sr: int, with_pred: bool,
          best_po_per_s: float) -> dict:
    """Least time of one call: the pixel-offsets at the best rate measured
    for an exact SAD sequence, or the bytes (cur and ref read once, mv and
    the prediction written once as int32) at the HBM rate, whichever is
    larger; and the earlier figure that counted three int32 operations per
    pixel-offset at 67 T ops/s, one sample to a lane."""
    nbytes = (3 if with_pred else 2) * h * w * 4 + (h // 16) * (w // 16) * 8
    t_ops = work(h, w, sr) / best_po_per_s * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ms_int32_lanes": work(h, w, sr) * 3 / 67e12 * 1e3}


def device_ms(fn, reps: int = 20, batches: int = 5) -> float:
    """Device ms of one ``fn()``: ``reps`` calls back to back between two
    CUDA events, queued behind a spin kernel so that the host's launch
    overhead leaves no gap between them; the median over ``batches``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def test_planes(dev, h, w, seed=11):
    """Smooth texture plus noise, and a shifted noisy copy of it."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    base = 128 + 60 * torch.sin(xx / 23.0) * torch.cos(yy / 31.0)
    cur = (base + torch.randint(-20, 21, (h, w), generator=gen, device=dev)
           ).clamp(0, 255).to(torch.int32)
    ref = (torch.roll(cur, (3, -2), (0, 1))
           + torch.randint(-3, 4, (h, w), generator=gen, device=dev)
           ).clamp(0, 255).to(torch.int32)
    return cur.contiguous(), ref.contiguous()


def ptxas_report(sass: bool = True) -> dict:
    """``-Xptxas -v`` of the motion sources (the kernel and the sequence
    microbenchmark), and the SASS opcode counts of each kernel."""
    os.makedirs(devmod.BUILD_DIR, exist_ok=True)
    flags = [f for f in devmod.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    report: dict = {"ptxas": {}, "sass": {}, "sass_text": ""}
    for src in ("motion_search.cu", "motion_probe.cu"):
        cubin = os.path.join(devmod.BUILD_DIR,
                             f"probe_{os.getpid()}_{src}.cubin")
        cmd = [devmod._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
               cubin, os.path.join(devmod.CSRC_DIR, src)]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
        fn = None
        for ln in (out.stdout + out.stderr).splitlines():
            m = re.search(r"Function properties for (\S+)", ln)
            if m:
                fn = m.group(1)
            elif fn and ("Used" in ln or "spill" in ln):
                report["ptxas"].setdefault(fn, []).append(
                    ln.split(":", 1)[-1].strip())
        dump = shutil.which("cuobjdump") or os.path.join(
            os.path.dirname(devmod._nvcc()), "cuobjdump")
        if sass and os.path.exists(dump):
            txt = subprocess.run([dump, "-sass", cubin], capture_output=True,
                                 text=True).stdout
            report["sass_text"] += txt
            fn = None
            for line in txt.splitlines():
                m = re.match(r"\s*Function : (\S+)", line)
                if m:
                    fn = m.group(1)
                    report["sass"][fn] = collections.Counter()
                    continue
                m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]*)", line)
                if fn and m:
                    report["sass"][fn][m.group(1).split(".")[0]] += 1
        os.remove(cubin)
    report["sass"] = {k: dict(v.most_common(14))
                      for k, v in report["sass"].items()}
    return report


def plan_sweep(dev, h: int, w: int, with_pred: bool, sr: int, lam: int):
    """Kernel ms under every run length and a range of strip lengths (the
    block as many threads as items, up to 512), fastest first."""
    lib = devmod.kernel_lib("motion_search.cu")
    fn = lib.vcp_motion_search_planned
    c_int, vp = ctypes.c_int, ctypes.c_void_p
    fn.restype = c_int
    fn.argtypes = [vp, vp] + [c_int] * 6 + [vp, vp] + [c_int] * 3 + [vp]
    cur, ref = test_planes(dev, h, w)
    mv = torch.empty((h // 16, w // 16, 2), dtype=torch.int32, device=dev)
    pred = torch.empty_like(cur) if with_pred else None
    want = motion_cuda.motion_search_ref(cur, ref, sr, lam, with_pred)
    side = 2 * sr + 1
    out = []
    for k in (12, 16, 20, 28):
        for n in range(1, 17):
            threads = min(512, -(-side * -(-side // k) * n // 32) * 32)

            def launch():
                devmod.check_launch(lib, fn(
                    devmod.ptr(cur), devmod.ptr(ref), h, w, h, 0, sr, lam,
                    devmod.ptr(mv), devmod.ptr(pred), k, n, threads,
                    devmod.stream_ptr(cur)), "motion_search_planned")
            launch()
            got = (mv, pred) if with_pred else mv
            if not all(torch.equal(a, b) for a, b in zip(
                    got if with_pred else (got,),
                    want if with_pred else (want,))):
                raise AssertionError(f"plan k={k} n={n} disagrees")
            out.append({"run": k, "mbs_per_block": n, "threads": threads,
                        "ms": device_ms(launch, reps=10, batches=3)})
    return sorted(out, key=lambda r: r["ms"])


def build_phase_lib() -> ctypes.CDLL:
    """``csrc/motion_search.cu`` built a second time with
    ``-DVCP_MOTION_PROBE``: each block of the strip kernel records its SM
    and its clocks at the start, after the loads, after the search and at
    the end."""
    os.makedirs(devmod.BUILD_DIR, exist_ok=True)
    so = os.path.join(devmod.BUILD_DIR, f"libmotion_probe_{os.getpid()}.so")
    cmd = [devmod._nvcc(), *devmod.NVCC_FLAGS, "-DVCP_MOTION_PROBE", "-o",
           so, os.path.join(devmod.CSRC_DIR, "motion_search.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(so)
    c_int, vp = ctypes.c_int, ctypes.c_void_p
    lib.vcp_motion_search.restype = c_int
    lib.vcp_motion_search.argtypes = \
        [vp, vp] + [c_int] * 6 + [vp, vp, c_int, vp]
    lib.vcp_motion_probe_buffer.argtypes = [vp]
    lib.vcp_motion_search_plan.argtypes = [c_int] * 4 + [vp]
    return lib


def phases(lib, dev, h: int, w: int, with_pred: bool, sr: int,
           lam: int) -> dict:
    """Where one launch's time goes: the launch's span on the global
    timer, how late the blocks start (a second wave starts late), blocks
    per SM, and the SM cycles of a block's loads, search and end (the
    atomics' barrier, the vectors and the prediction)."""
    plan = (ctypes.c_int * 4)()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lib.vcp_motion_search_plan(h, w, sr, n_sm, plan)
    n_blocks = (h // 16) * -(-(w // 16) // plan[1])
    buf = torch.zeros(7 * n_blocks, dtype=torch.int64, device=dev)
    lib.vcp_motion_probe_buffer(devmod.ptr(buf))
    cur, ref = test_planes(dev, h, w)
    mv = torch.empty((h // 16, w // 16, 2), dtype=torch.int32, device=dev)
    pred = torch.empty_like(cur) if with_pred else None
    for _ in range(3):          # the last launch's clocks are kept
        devmod.check_launch(lib, lib.vcp_motion_search(
            devmod.ptr(cur), devmod.ptr(ref), h, w, h, 0, sr, lam,
            devmod.ptr(mv), devmod.ptr(pred), n_sm, devmod.stream_ptr(cur)),
            "probe launch")
    torch.cuda.synchronize()
    lib.vcp_motion_probe_buffer(None)
    rec = buf.reshape(n_blocks, 7).cpu()
    sm, g0, g1 = rec[:, 0], rec[:, 1], rec[:, 6]
    cyc = rec[:, 2:6].double()
    start_us = (g0 - g0.min()).double() / 1e3

    def q(t):
        return {k: round(float(t.quantile(v)), 1)
                for k, v in (("median", 0.5), ("p90", 0.9), ("max", 1.0))}
    per_sm = torch.bincount(sm, minlength=1)
    return {"shape": [h, w], "sr": sr, "with_pred": with_pred,
            "plan": list(plan), "blocks": n_blocks,
            "span_us": float(g1.max() - g0.min()) / 1e3,
            "block_start_us": q(start_us),
            "blocks_starting_after_2us": int((start_us > 2).sum()),
            "blocks_per_sm_max": int(per_sm.max()),
            "blocks_per_sm_mean": n_blocks / int((per_sm > 0).sum()),
            "load_cycles": q(cyc[:, 1] - cyc[:, 0]),
            "search_cycles": q(cyc[:, 2] - cyc[:, 1]),
            "end_cycles": q(cyc[:, 3] - cyc[:, 2])}


def main(argv: list[str]) -> int:
    dev = devmod.resolve_device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rep = ptxas_report(sass="--no-sass" not in argv)
    sass = rep.pop("sass_text", "")
    if "--sass-out" in argv:
        with open(argv[argv.index("--sass-out") + 1], "w") as fh:
            fh.write(sass)
    print(json.dumps(rep), flush=True)
    rates = sequence_rates(dev)
    best = max(list(rates.values())[:SAD_SEQUENCES])
    cur, ref = test_planes(dev, 1088, 1920)
    clocks = sm_clocks_mhz(lambda: motion_cuda.motion_search(cur, ref, 8, 22))
    print(json.dumps({
        "sequences_po_per_s": rates,
        "sequences_po_per_sm_clock": {
            k: per_sm_clock(v, n_sm, clocks["under_load"])
            for k, v in rates.items()},
        "sm_clock_mhz": clocks}), flush=True)
    for h, w in ((1088, 1920), (2160, 3840)):
        cur, ref = test_planes(dev, h, w)
        for with_pred, sr, lam, name in ROWS:
            new = motion_cuda.motion_search(cur, ref, sr, lam,
                                            with_pred=with_pred)
            old = motion_cuda.motion_search_ref(cur, ref, sr, lam,
                                                with_pred=with_pred)
            same = all(torch.equal(a, b) for a, b in zip(
                new if with_pred else (new,), old if with_pred else (old,)))
            if not same:
                raise AssertionError(f"{name} {h}x{w}: the kernel differs "
                                     f"from the reference design")
            ms = device_ms(lambda: motion_cuda.motion_search(
                cur, ref, sr, lam, with_pred=with_pred))
            ref_ms = device_ms(lambda: motion_cuda.motion_search_ref(
                cur, ref, sr, lam, with_pred=with_pred))
            print(json.dumps({
                "kernel": name, "shape": [h, w], "sr": sr, "lam": lam,
                "equal_to_reference": same, "ms": ms, "ref_ms": ref_ms,
                "plan": motion_cuda.launch_plan(h, w, sr, dev),
                "po_per_sm_clock": per_sm_clock(
                    work(h, w, sr) / (ms * 1e-3), n_sm,
                    clocks["under_load"]),
                "ref_po_per_sm_clock": per_sm_clock(
                    work(h, w, sr) / (ref_ms * 1e-3), n_sm,
                    clocks["under_load"]),
                **bound(h, w, sr, with_pred, best)}), flush=True)
    lib = build_phase_lib()
    for h, w in ((1088, 1920), (2160, 3840)):
        for with_pred, sr, lam, name in ROWS:
            print(json.dumps({"phases": name, **phases(
                lib, dev, h, w, with_pred, sr, lam)}), flush=True)
    if "--sweep" in argv:
        for with_pred, sr, lam, name in ROWS:
            res = plan_sweep(dev, 1088, 1920, with_pred, sr, lam)
            print(json.dumps({"plan_sweep": name, "fastest": res[:6],
                              "slowest": res[-2:]}), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
