"""Where a step of the one-launch deblocking kernel spends its time.

    python -m vcp_tpu_torch.tools.probe_deblock_wave [H W]

Builds ``csrc/deblock.cu`` a second time with ``-DVCP_WAVE_PROBE``, runs
``deblock_wave`` in its three instantiations on a dense synthetic frame
(default 1088 x 1920) and prints, per instantiation, one JSON object: the
kernel's time (CUDA events, median of 20, the launch alone without the
wrapper's allocations) and the SM cycles per MB step that the warps of a
row's block spend in each part of the step,
as the median over the MB rows and for the first and the last row. With
the card's SM clock (``nvidia-smi``, read while a queue of further
launches runs) cycles become microseconds. Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from .. import device as devmod
from ..ops import deblock

# The 12 counters a row writes, in the kernel's order (csrc/deblock.cu).
COUNTERS = ("luma_wait_loaded", "luma_vertical", "luma_horizontal",
            "luma_step_after_wait", "samples_wait_free",
            "thresholds_wait_above", "thresholds_waited_steps",
            "thresholds_load_above", "storer_wait_filtered", "storer_stores",
            "publisher_fence_publish", "row_total", "thresholds_wait_free",
            "thresholds_store_fetch")


def build_probe_lib() -> ctypes.CDLL:
    os.makedirs(devmod.BUILD_DIR, exist_ok=True)
    so = os.path.join(devmod.BUILD_DIR, f"libdeblock_probe_{os.getpid()}.so")
    cmd = [devmod._nvcc(), *devmod.NVCC_FLAGS, "-DVCP_WAVE_PROBE", "-o", so,
           os.path.join(devmod.CSRC_DIR, "deblock.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc build failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(so)
    c_int, vp = ctypes.c_int, ctypes.c_void_p
    lib.vcp_deblock_fast.restype = c_int
    lib.vcp_deblock_fast.argtypes = [vp] * 6 + [c_int, c_int] + [vp] * 5
    lib.vcp_deblock_general.restype = c_int
    lib.vcp_deblock_general.argtypes = ([vp] * 6 + [c_int, c_int] + [vp] * 5
                                        + [c_int, vp])
    return lib


def dense_frame(dev, h, w, intra_all, seed=7):
    """Smooth content with 4x4 blocking steps; residual in half of the
    4x4 blocks, a vector on a third of the MBs, per-MB QP 24..45."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_mby, n_mbx = h // 16, w // 16

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def plane(hh, ww):
        yy, xx = torch.meshgrid(torch.arange(hh, device=dev),
                                torch.arange(ww, device=dev), indexing="ij")
        steps = randint(-6, 7, (hh // 4, ww // 4)) \
            .repeat_interleave(4, 0).repeat_interleave(4, 1)
        return (100 + (xx * 60) // ww + (yy * 40) // hh + steps
                + randint(-2, 3, (hh, ww))).clamp_(0, 255).to(torch.int32)

    y, u, v = plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2)
    nz = torch.rand((h // 4, w // 4), generator=gen, device=dev) < 0.5
    mv = randint(-8, 9, (n_mby, n_mbx, 2)) * (
        torch.rand((n_mby, n_mbx, 1), generator=gen, device=dev) < 0.3)
    intra = torch.full((n_mby, n_mbx), intra_all, device=dev)
    bs_v = deblock.compute_bs_luma(intra, nz, mv, True)
    bs_h = deblock.compute_bs_luma(intra, nz, mv, False)
    return y, u, v, bs_v, bs_h, randint(24, 46, (n_mby, n_mbx))


def probe(lib, dev, h, w, mode: int, reps: int = 20) -> dict:
    n_mby, n_mbx = h // 16, w // 16
    y, u, v, bs_v, bs_h, qp_mb = dense_frame(dev, h, w, mode == 2)
    outs = [torch.empty_like(t) for t in (y, u, v)]
    progress = torch.zeros(17 * n_mby + 1, dtype=torch.int32, device=dev)
    stream = devmod.stream_ptr(y)
    if mode == 0:
        scal = deblock.deblock_scalars(34)
        scal_host = (ctypes.c_int32 * 10)(*scal)
        ref = deblock.deblock_fast_plain(y, u, v, bs_v, bs_h, scal)

        def launch():
            return lib.vcp_deblock_fast(
                *(devmod.ptr(t) for t in (y, u, v, *outs)), h, w,
                devmod.ptr(bs_v), devmod.ptr(bs_h), scal_host,
                devmod.ptr(progress), stream)
    else:
        grids = deblock.threshold_grids(bs_v, bs_h, qp_mb)
        ref = deblock.deblock_general_plain(y, u, v, *grids,
                                            strong=mode == 2)

        def launch():
            return lib.vcp_deblock_general(
                *(devmod.ptr(t) for t in (y, u, v, *outs)), h, w,
                *(devmod.ptr(g) for g in grids), devmod.ptr(progress),
                1 if mode == 2 else 0, stream)

    times = []
    for _ in range(reps + 1):
        progress.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        devmod.check_launch(lib, launch(), "deblock_wave probe")
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    if not all(torch.equal(o, r) for o, r in zip(outs, ref)):
        raise AssertionError("the probe build disagrees with the plain "
                             "version")
    rows = progress[n_mby + 1:].reshape(n_mby, 16).cpu().tolist()
    names = COUNTERS

    def per_step(row):
        return {k: row[i] / n_mbx for i, k in enumerate(names)}

    per_row = [per_step(r) for r in rows]
    med = {k: statistics.median(r[k] for r in per_row) for k in names}
    d_steps = n_mbx + 2 * (n_mby - 1)
    kernel_ms = statistics.median(times[1:])
    for _ in range(1000):       # keep the card busy while main() reads its clock
        launch()
    return {"mode": mode, "shape": [h, w], "d_steps": d_steps,
            "kernel_ms": kernel_ms, "step_us": kernel_ms * 1e3 / d_steps,
            "cycles_per_step_median_row": med,
            "cycles_per_step_first_row": per_row[0],
            "cycles_per_step_last_row": per_row[-1]}


def main(argv: list[str]) -> int:
    dev = devmod.resolve_device("cuda")
    h, w = (int(argv[0]), int(argv[1])) if len(argv) == 2 else (1088, 1920)
    lib = build_probe_lib()
    for mode in (0, 1, 2):
        res = probe(lib, dev, h, w, mode)
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True)
        torch.cuda.synchronize()
        res["card_and_sm_clock_under_load"] = out.stdout.strip()
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
