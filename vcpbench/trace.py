"""The device trace of one profiled task, and what is read from it.

``profile`` runs a task under ``torch.profiler`` (the card's activity
only). The recorded window opens with ``PREROLL`` tiny kernels and a
pause, since Kineto drops events at a window's edge; then a sentinel
copy of ``SENTINEL_BYTES[0]`` bytes marks the task's start and one of
``SENTINEL_BYTES[1]`` its end. ``reduce`` keeps the device events that
lie between the two, from Kineto's JSON export (one ``json.load``:
torch's per-event Python objects take minutes for a million launches),
and maps host spans onto the device clock through the first sentinel.
"""

from __future__ import annotations

import json
import os
import time

SENTINEL_BYTES = (4093, 4091)
GAP_S = 0.25
PREROLL = 1000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 100


class TraceLost(RuntimeError):
    """A trace that lacks a sentinel copy of its window."""


def profile(run, device, path: str):
    """``run()`` under the profiler: its result and the host clock
    (``time.perf_counter``) when the first sentinel copy was issued. The
    trace is written to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    def sentinel(n: int) -> float:
        t = time.perf_counter()
        torch.zeros(n, dtype=torch.uint8).to(device)
        torch.cuda.synchronize(device)
        return t

    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        x = torch.zeros(1, device=device)
        for _ in range(PREROLL):
            x.add_(1)
        torch.cuda.synchronize(device)
        time.sleep(GAP_S)
        h_open = sentinel(SENTINEL_BYTES[0])
        out = run()
        torch.cuda.synchronize(device)
        sentinel(SENTINEL_BYTES[1])
        time.sleep(GAP_S)
    prof.export_chrome_trace(path)
    return out, h_open


def _union(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _label(spans: list, t: float) -> str:
    """The innermost host span (name, t0, t1) that holds ``t``."""
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else "harness"


def reduce(path: str, h_open: float, spans: list) -> dict:
    """What a metric reads from the trace at ``path`` (deleted once read):
    the window between the sentinels in seconds, the busy seconds (the
    union of kernel and copy intervals), bytes copied host to device,
    kernel seconds by name, the device operations that took most time,
    and the longest idle gaps labelled with the host span they fall in."""
    with open(path) as fh:
        trace = json.load(fh)["traceEvents"]
    os.remove(path)
    dev = [e for e in trace if e.get("cat") in DEVICE_CATS]
    del trace
    edges = []
    for n in SENTINEL_BYTES:
        at = [e for e in dev if e["cat"] == "gpu_memcpy"
              and "HtoD" in e.get("name", "")
              and e.get("args", {}).get("bytes") == n]
        if len(at) != 1:
            raise TraceLost(f"the trace holds {len(at)} sentinel copies of "
                            f"{n} bytes, not one ({len(dev)} device events)")
        edges.append(at[0])
    lo = edges[0]["ts"] + edges[0]["dur"]
    hi = edges[1]["ts"]
    inside = [e for e in dev if e["ts"] >= lo and e["ts"] + e["dur"] <= hi]
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in inside])
    by_name: dict = {}
    h2d = 0
    for e in inside:
        name = e["name"]
        by_name[name] = by_name.get(name, 0.0) + e["dur"] * 1e-6
        if e["cat"] == "gpu_memcpy" and "HtoD" in name:
            h2d += int(e.get("args", {}).get("bytes", 0))
    # host perf_counter seconds -> device microseconds
    offset = edges[0]["ts"] - h_open * 1e6
    gaps, prev = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "h2d_bytes": h2d,
        "kernel_s": by_name,
        "device_ops": [[name[:NAME_CHARS], s] for name, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[_label(spans, ((a + b) / 2 - offset) * 1e-6),
                       (b - a) * 1e-6] for a, b in gaps],
        "events": len(inside),
    }


def kernel_seconds(kernel_s: dict, part: str) -> float:
    """Seconds of the kernels whose name contains ``part``."""
    return sum(s for name, s in kernel_s.items() if part in name)
