"""Objective quality metrics: PSNR + SSIM, and a stream comparator.

Copy of ``vcp_tpu/quality.py``: per-frame and per-stream luma PSNR and
SSIM in numpy on the host, as a library and as ``quality REF TEST``
(both arguments go through ``codec.ingest``, so Y4M / MP4 / MKV / AVI
all work).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return 99.0
    return float(10.0 * np.log10(peak * peak / mse))


def _box_filter(x: np.ndarray, k: int) -> np.ndarray:
    """k x k mean filter with 'valid' support via cumulative sums."""
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    s = (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k])
    return s / (k * k)


def ssim(a: np.ndarray, b: np.ndarray, k: int = 8,
         peak: float = 255.0) -> float:
    """Mean SSIM over k x k windows (the standard C1/C2 constants)."""
    x = a.astype(np.float64)
    y = b.astype(np.float64)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mx = _box_filter(x, k)
    my = _box_filter(y, k)
    mxx = _box_filter(x * x, k)
    myy = _box_filter(y * y, k)
    mxy = _box_filter(x * y, k)
    vx = mxx - mx * mx
    vy = myy - my * my
    cov = mxy - mx * my
    num = (2 * mx * my + c1) * (2 * cov + c2)
    den = (mx * mx + my * my + c1) * (vx + vy + c2)
    return float(np.mean(num / den))


@dataclasses.dataclass
class StreamQuality:
    frames: int
    psnr_y: float          # mean luma PSNR (dB)
    psnr_min: float
    ssim_y: float          # mean luma SSIM
    ref_frames: int = 0
    test_frames: int = 0


def compare_streams(ref_path: str, test_path: str,
                    max_frames: int | None = None) -> StreamQuality:
    """Frame-by-frame luma PSNR/SSIM between two videos (any supported
    container; frames paired in display order)."""
    from itertools import islice

    from .codec.ingest import open_video
    ref = open_video(ref_path)
    test = open_video(test_path)
    psnrs, ssims = [], []
    nr = nt = 0
    it_r = islice(ref.frames, max_frames)
    it_t = islice(test.frames, max_frames)
    while True:
        fr = next(it_r, None)
        ft = next(it_t, None)
        if fr is None or ft is None:
            nr += fr is not None
            nt += ft is not None
            break
        nr += 1
        nt += 1
        y_r, y_t = fr[0], ft[0]
        if y_r.shape != y_t.shape:
            raise ValueError(f"frame size mismatch: {y_r.shape} vs "
                             f"{y_t.shape}")
        psnrs.append(psnr(y_r, y_t))
        ssims.append(ssim(y_r, y_t))
    if not psnrs:
        raise ValueError("no comparable frames")
    return StreamQuality(frames=len(psnrs),
                         psnr_y=float(np.mean(psnrs)),
                         psnr_min=float(np.min(psnrs)),
                         ssim_y=float(np.mean(ssims)),
                         ref_frames=nr, test_frames=nt)
