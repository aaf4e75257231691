"""One run of one cell: set-up, the measured window, the comparison, and
the result line.

``run_cell`` is the whole run. On ``cuda`` it refuses to start without
as many cards as the cell asks for; ``rehearse.py`` drives the same code
on the CPU at a small size and prints no metric.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time

from . import check, loop, roofline, spec, trace
from .content import Content, scaled, write_y4m

FORBIDDEN = {"jax", "jaxlib", "flax", "vcp_tpu"}


def process_age_s() -> float | None:
    """Seconds since this process started, from ``/proc`` (None where
    there is none)."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (compared whole) is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _log(msg: str) -> None:
    print(f"[vcpbench] {msg}", file=sys.stderr, flush=True)


def scale_rate(args: str, ratio: float) -> str:
    """Preset arguments with each bit rate scaled by ``ratio``: the same
    bits per pixel at a rehearsal's frame size."""
    words = args.split()
    for i, w in enumerate(words[:-1]):
        if w in ("-b:v", "-maxrate", "-bufsize"):
            v = words[i + 1]
            mult = {"k": 1e3, "K": 1e3, "M": 1e6}.get(v[-1], 1.0)
            num = float(v[:-1]) if v[-1] in "kKM" else float(v)
            words[i + 1] = str(max(1, int(num * mult * ratio)))
    return " ".join(words)


def resized(cfg: dict, traffic: dict, size: tuple | None):
    """The configuration and mix at a rehearsal's frame size (W, H): the
    same bits per pixel (``scale_rate`` on ``args`` and
    ``control_args``) and the boxes scaled with the frame."""
    if size is None:
        return cfg, traffic
    ratio = size[0] * size[1] / (cfg["width"] * cfg["height"])
    factor = min(size[0] / cfg["width"], size[1] / cfg["height"])
    cfg = dict(cfg, width=size[0], height=size[1])
    for k in ("args", "control_args"):
        cfg[k] = scale_rate(cfg[k], ratio)
    return cfg, dict(traffic, content=scaled(traffic["content"], factor))


def device_ok(device: str, chips: int) -> bool:
    if device != "cuda":
        return True
    import torch
    if not torch.cuda.is_available():
        _log("no CUDA device: the benchmark runs only on the card")
        return False
    if torch.cuda.device_count() < chips:
        _log(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
             "visible")
        return False
    return True


def _profiled_task(cfg, traffic, src, out_dir, device, dev, tmp):
    """One more task after the window, on the clip's first
    ``profile_frames`` frames (a GOP: a whole task of the quality shape
    traces 1.35 M device events), under the profiler, with its spans
    and kernel inputs recorded: the device half of the per-layer
    metrics. A trace that lost a sentinel is taken once more."""
    for attempt in (1, 2):
        calls: dict = {}
        task_spans = loop.Spans()
        path = os.path.join(tmp, "trace.json")
        with loop.gop_spans(task_spans), loop.kernel_calls(calls):
            task, h_open = trace.profile(
                lambda: loop.run_task(
                    10000 + attempt, src, out_dir, cfg["args"], device,
                    traffic["loop"]["profile_frames"], task_spans),
                dev, path)
        t = time.perf_counter()
        _log(f"profiled task {task.t1 - task.t0:.2f} s, trace file "
             f"{os.path.getsize(path) / 1e6:.1f} MB")
        try:
            red = trace.reduce(path, h_open, task_spans.spans)
            _log(f"trace read in {time.perf_counter() - t:.2f} s, "
                 f"{red['events']} device events")
        except trace.TraceLost as e:
            _log(f"profiled task {attempt}: {e}")
            if attempt == 2:
                raise
            continue
        red["task"] = task
        red["calls"] = calls
        return red


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", size: tuple | None = None,
             program_args: str | None = None) -> dict | None:
    """Run one cell; returns the result (None when the run must print
    none). ``size`` (W, H) replaces the configuration's frame size for a
    rehearsal; ``program_args`` replaces its preset arguments (the
    control of the comparison)."""
    t_setup0 = time.perf_counter()
    age = process_age_s()
    cell = spec.load_cell(workload)
    if not device_ok(device, cell.chips):
        return None
    import torch
    cfg = dict(cell.config)
    if program_args is not None:
        cfg["args"] = program_args
    cfg, traffic = resized(cfg, cell.traffic, size)
    n = traffic["loop"]["frames_per_task"]
    dev = torch.device("cuda", 0) if device == "cuda" else device
    tmp = tempfile.mkdtemp(prefix="vcpbench-")
    try:
        return _run(cell, cfg, traffic, n, seed, seconds, traced, device,
                    dev, tmp, t_setup0, age)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, cfg, traffic, n, seed, seconds, traced, device, dev, tmp,
         t_setup0, age):
    import torch
    src = os.path.join(tmp, "input.y4m")
    warm = os.path.join(tmp, "warmup.y4m")
    out_dir = os.path.join(tmp, "out")
    os.makedirs(out_dir)
    content = Content(traffic["content"], cfg["width"], cfg["height"], seed)
    n_warm = traffic["loop"]["warmup_frames"]
    clips = [(src, n), (warm, n_warm)]
    if traced:
        clips.append((os.path.join(tmp, "profile.y4m"),
                      traffic["loop"]["profile_frames"]))
    t = time.perf_counter()
    write_y4m(clips, content, cfg["fps_num"], cfg["fps_den"])
    _log(f"content and Y4M write {time.perf_counter() - t:.2f} s "
         f"(set-up so far {time.perf_counter() - t_setup0:.2f} s)")
    t = time.perf_counter()
    # warm-up: the cell's own shapes, every kernel built and loaded
    w = loop.run_task(-1, warm, out_dir, cfg["args"], device, n_warm)
    if w.error:
        _log(f"warm-up task failed: {w.error}")
    if device == "cuda":
        torch.cuda.synchronize(dev)
    _log(f"warm-up task of {n_warm} frames {time.perf_counter() - t:.2f} s")

    spans = loop.Spans() if traced else None
    with loop.gop_spans(spans) if traced else contextlib.nullcontext():
        tasks, t_w0, t_w1 = loop.closed_loop(
            src, out_dir, cfg["args"], device, n, seconds, spans)
    setup_s = t_w0 - t_setup0 + (age or 0.0)
    _log(f"window {t_w1 - t_w0:.2f} s, {len(tasks)} tasks: "
         + " ".join(f"{t.t1 - t.t0:.2f}" for t in tasks))
    window_gops = list(spans.gops) if traced else []
    prof = None
    if traced and device == "cuda":
        prof = _profiled_task(cfg, traffic, clips[2][0], out_dir, device,
                              dev, tmp)
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if device == "cuda" else 0)
    bad = forbidden_modules()
    if bad:
        _log(f"modules of JAX or the JAX package are loaded: {bad}")
        return None
    if prof is not None:
        prof["roofline_s"] = {
            k: roofline.least_total_s(v, k) for k, v in prof["calls"].items()}
        del prof["calls"]
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    every = tasks + ([prof["task"]] if prof else [])
    t = time.perf_counter()
    res = check.compare([t.out for t in tasks if not t.error], cfg, traffic,
                        seed)
    _log(f"comparison {time.perf_counter() - t:.2f} s")
    numbers = dict(res["numbers"],
                   tasks_failed=sum(bool(t.error) for t in every))
    correct, lines = check.verdict(numbers, cell.limits)
    res["faults"] += [f"task {t.index}: {t.error}" for t in every if t.error]

    obs = {"tasks": tasks, "window": (t_w0, t_w1), "setup_s": setup_s,
           "check": res, "gops": window_gops, "spans": spans,
           "profile": prof, "config": cfg, "traffic": traffic}
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = spec.reader(m["name"])(obs)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": len(tasks),
        "failed": numbers["tasks_failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device == "cuda" else device,
            "kind": (torch.cuda.get_device_name(dev) if device == "cuda"
                     else "cpu"),
            "count": cell.chips,
            "memory_peak_bytes": int(memory_peak)},
    }
    if prof is not None:
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
        result["profiled_task_s"] = prof["task"].t1 - prof["task"].t0
        result["trace_events"] = prof["events"]
    result["sampled_task"] = res.get("sampled")
    result["frames_decoded"] = res.get("frames_decoded", 0)
    result["mse_worst"] = res.get("mse_worst")
    for f in res["faults"][:10]:
        _log(f"fault: {f}")
    for line in lines:
        print(line, file=sys.stderr)
    result["pictures"] = {k: numbers[k] for k in check.PICTURES}
    result["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]}
                        for k in cell.limits}
    sys.stderr.flush()
    return result


def emit(result: dict) -> None:
    print(json.dumps(result), flush=True)
