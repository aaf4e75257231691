"""The closed loop: one worker runs tasks back to back, as ``vcp
consumer -j1`` does, through the consumer's encode and verify steps.

A task is ``executor.execute(input, output, args, device=...)`` and then
``verify_video_file(output)`` (``pipeline/consumer.py``). The window
holds whole tasks only: it closes at the end of the first task that ends
at or after ``seconds``.

``Spans`` records, from the benchmark's side of each call, where the
host time goes: the tasks with their ``execute`` and verify steps, and
each ``H264Encoder.encode_gop`` with its ``stage_s`` deltas; they label
the device's idle gaps of a profiled task. Nothing here changes what the
program computes; the wrappers are taken off again on exit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time


PROBE_ITERATIONS = 300_000


@dataclasses.dataclass
class Task:
    index: int
    out: str
    t0: float
    t1: float = 0.0
    frames: int = 0
    error: str = ""
    probe_s: float | None = None     # the host probe timed before it


def host_probe() -> float:
    """Seconds that a fixed loop of Python arithmetic takes: the host's
    speed for the interpreter at this moment, read beside each task of a
    traced window so that a task's time can be read against its host."""
    t = time.perf_counter()
    acc = 0
    for i in range(PROBE_ITERATIONS):
        acc += i * i
    return time.perf_counter() - t


class Spans:
    """Host spans [(name, t0, t1)] and GOP records of the wrapped calls,
    on ``time.perf_counter``."""

    def __init__(self):
        self.spans: list = []
        self.gops: list = []

    def add(self, name: str, t0: float, t1: float) -> None:
        self.spans.append((name, t0, t1))


def run_task(i: int, src: str, out_dir: str, args: str, device: str,
             frames: int, spans: Spans | None = None) -> Task:
    from vcp_tpu_torch.codec.mp4 import verify_video_file
    from vcp_tpu_torch.pipeline import executor
    out = os.path.join(out_dir, f"task{i:04d}.mp4")
    task = Task(i, out, time.perf_counter())
    try:
        executor.execute(src, out, args, device=device)
        t_enc = time.perf_counter()
        ok, reason = verify_video_file(out)
        if not ok:
            task.error = f"verify failed: {reason}"
    except Exception as e:       # noqa: BLE001 - a failed task is counted
        t_enc = time.perf_counter()
        task.error = f"{type(e).__name__}: {e}"
    task.t1 = time.perf_counter()
    task.frames = 0 if task.error else frames
    if spans is not None:
        spans.add("executor.execute", task.t0, t_enc)
        spans.add("verify_video_file", t_enc, task.t1)
        spans.add("task", task.t0, task.t1)
    return task


def closed_loop(src: str, out_dir: str, args: str, device: str,
                frames: int, seconds: float, spans: Spans | None = None,
                probe: bool = False):
    """Tasks back to back until one ends at or after ``seconds``:
    (tasks, window start, window end) on ``time.perf_counter``. With
    ``probe`` the host probe is timed before each task: outside the
    task's own clock, but inside the window (a traced window only, from
    which no ``fps`` is read)."""
    tasks = []
    t0 = time.perf_counter()
    while True:
        p = host_probe() if probe else None
        tasks.append(run_task(len(tasks), src, out_dir, args, device,
                              frames, spans))
        tasks[-1].probe_s = p
        if tasks[-1].t1 - t0 >= seconds:
            return tasks, t0, tasks[-1].t1


@contextlib.contextmanager
def patched(obj, name: str, wrap):
    """``obj.name`` replaced by ``wrap(original)`` while active. The
    wrapper carries the original's attributes (the kernel wrappers count
    their launches in attributes of their own name), and what they hold
    when it is taken off goes back to the original."""
    real = getattr(obj, name)
    wrapper = functools.update_wrapper(wrap(real), real)
    setattr(obj, name, wrapper)
    try:
        yield real
    finally:
        setattr(obj, name, real)
        for k, v in vars(wrapper).items():
            if k != "__wrapped__":
                setattr(real, k, v)


def gop_spans(spans: Spans):
    """Wrap ``H264Encoder.encode_gop``: a span a GOP, and its frames and
    ``stage_s`` deltas in ``spans.gops``."""
    from vcp_tpu_torch.codec.h264.encoder import H264Encoder

    def wrap(real):
        def encode_gop(self, frames):
            before = dict(self.stage_s)
            t0 = time.perf_counter()
            out = real(self, frames)
            t1 = time.perf_counter()
            spans.add("encode_gop", t0, t1)
            spans.gops.append({
                "t0": t0, "t1": t1, "frames": len(frames),
                "stage_s": {k: v - before[k]
                            for k, v in self.stage_s.items()}})
            return out
        return encode_gop
    return patched(H264Encoder, "encode_gop", wrap)


@contextlib.contextmanager
def kernel_calls(calls: dict):
    """Record the inputs of each motion-search and deblock kernel call:
    the data their operation and byte counts are computed from
    (``roofline.py``) once the profiled task has ended."""
    from vcp_tpu_torch.codec.h264 import gop_ops
    from vcp_tpu_torch.ops import deblock_cuda

    def motion(real):
        def call(cur, ref, search_range, lam, with_pred=False, row0=0):
            calls.setdefault("motion_search", []).append(
                (tuple(cur.shape), int(search_range), bool(with_pred)))
            return real(cur, ref, search_range, lam, with_pred=with_pred,
                        row0=row0)
        return call

    def fast(real):
        def call(y, u, v, bs_v, bs_h, scal):
            calls.setdefault("deblock_fast", []).append(
                (tuple(y.shape), bs_v, bs_h))
            return real(y, u, v, bs_v, bs_h, scal)
        return call

    def general(real):
        def call(y, u, v, vthr, hthr, cvthr, chthr, strong=True):
            calls.setdefault("deblock_general", []).append(
                (tuple(y.shape), vthr, hthr, cvthr, chthr, bool(strong)))
            return real(y, u, v, vthr, hthr, cvthr, chthr, strong=strong)
        return call

    with patched(gop_ops, "motion_search", motion), \
            patched(deblock_cuda, "deblock_fast", fast), \
            patched(deblock_cuda, "deblock_general", general):
        yield calls
