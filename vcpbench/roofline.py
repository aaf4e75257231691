"""The least time a kernel call could take on one H100, from its inputs.

Peaks are NVIDIA's published figures for the H100 SXM at its 700 W
limit: 3.35 TB/s of HBM3 bandwidth and 67 T non-tensor operations a
second (the FP32 / INT32 rate outside the tensor cores). No measured
rate serves as a peak. A call's least time is the larger of its bytes
over the bandwidth and its operations over the rate; bytes count each
input read once and each output written once.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
LUMA_LINE_OPS = 35          # a normal-filter luma line (bS 1-3)
LUMA_STRONG_LINE_OPS = 50   # a strong-filter luma line (bS 4)
CHROMA_LINE_OPS = 20        # a chroma line of one plane


def least_s(nbytes: float, nops: float) -> float:
    return max(nbytes / PEAK_BYTES_S, nops / PEAK_OPS_S)


def motion_search(shape: tuple, search_range: int,
                  with_pred: bool) -> tuple[float, float]:
    """(bytes, operations) of one full-pel search over an (H, W) int32
    frame: one absolute difference per pixel-offset, n_MB x (2 sr + 1)^2
    x 256; the current frame and the reference read once, the vectors and
    (``with_pred``) the prediction written once."""
    h, w = shape
    n_mb = (h // 16) * (w // 16)
    ops = n_mb * (2 * search_range + 1) ** 2 * 256
    nbytes = 4 * h * w * (3 if with_pred else 2) + 8 * n_mb
    return nbytes, ops


def _planes_bytes(shape: tuple) -> int:
    """The three int32 planes of an (H, W) 4:2:0 frame, read and written."""
    h, w = shape
    return 2 * 4 * (h * w + 2 * (h // 2) * (w // 2))


def deblock_fast(shape: tuple, bs_v, bs_h) -> tuple[float, float]:
    """(bytes, operations) of one uniform-QP deblock (bS <= 3): the planes
    and the two bS grids; the luma lines the data filters (4 a block edge
    with bS > 0) and the chroma lines (2 a plane for each such edge on the
    8-sample grid)."""
    luma = 4 * (int((bs_v > 0).sum()) + int((bs_h > 0).sum()))
    chroma = 2 * 2 * (int((bs_v[1::2] > 0).sum())
                      + int((bs_h[1::2] > 0).sum()))
    nbytes = _planes_bytes(shape) + 4 * (bs_v.numel() + bs_h.numel())
    return nbytes, luma * LUMA_LINE_OPS + chroma * CHROMA_LINE_OPS


def deblock_general(shape: tuple, vthr, hthr, cvthr, chthr,
                    strong: bool) -> tuple[float, float]:
    """(bytes, operations) of one threshold-grid deblock: the planes and
    the four (bS, alpha, beta, tc0) grids; each grid entry with bS > 0 is
    one filtered line (the strong filter's where bS is 4 and ``strong``),
    the chroma grids once for each of the two planes."""
    luma = strong_lines = 0
    for g in (vthr, hthr):
        luma += int((g[0] > 0).sum())
        if strong:
            strong_lines += int((g[0] == 4).sum())
    chroma = 2 * (int((cvthr[0] > 0).sum()) + int((chthr[0] > 0).sum()))
    nbytes = _planes_bytes(shape) + 4 * sum(
        g.numel() for g in (vthr, hthr, cvthr, chthr))
    ops = ((luma - strong_lines) * LUMA_LINE_OPS
           + strong_lines * LUMA_STRONG_LINE_OPS + chroma * CHROMA_LINE_OPS)
    return nbytes, ops


COUNTS = {"motion_search": motion_search, "deblock_fast": deblock_fast,
          "deblock_general": deblock_general}


def least_total_s(calls: list, kind: str) -> float:
    """Summed least time of the recorded calls of one kernel wrapper."""
    fn = COUNTS[kind]
    return sum(least_s(*fn(*c)) for c in calls)
