"""H.264 High-profile 8x8 integer transform + quantization (exact int32).

Port of the device functions of ``vcp_tpu/ops/transform8.py``: the
forward butterflies (the JM/x264 companion of the spec's inverse), the
inverse transform (spec 8.5.13.2, (x + 32) >> 6 after the second pass),
the quantizer (MF8 multipliers, qbits = 16 + qp/6) and dequantizer (spec
8.5.13.1 levelScale8x8 with the flat weight scale folded out), the 8x8
(de)tiling and the 8x8 zig-zag scan. Blocks are shaped (..., 8, 8) with
arbitrary leading dims; every op stays int32 on the tensor's own device.
QP is a plain Python int argument of each call. Numpy versions of the
inverse path (``*_np``) serve the host decoder.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import constant

# Forward quant multipliers (JM quant_coef8), 6 position classes.
_MF8_CLASS = np.array([
    [13107, 11428, 20972, 12222, 16777, 15481],
    [11916, 10826, 19174, 11058, 14980, 14290],
    [10082, 8943, 15978, 9675, 12710, 11985],
    [9362, 8228, 14913, 8931, 11984, 11259],
    [8192, 7346, 13159, 7740, 10486, 9777],
    [7282, 6428, 11570, 6830, 9118, 8640],
], dtype=np.int32)

# Dequant scales (spec levelScale8x8 m' values), same classes.
_V8_CLASS = np.array([
    [20, 18, 32, 19, 25, 24],
    [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31],
    [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38],
    [36, 32, 58, 34, 46, 43],
], dtype=np.int32)


def _pos_class8() -> np.ndarray:
    """Position-class map (spec 8.5.13.1): class by (i%4, j%4) pattern."""
    cls = np.empty((8, 8), np.int32)
    for i in range(8):
        for j in range(8):
            if i % 4 == 0 and j % 4 == 0:
                c = 0
            elif i % 2 == 1 and j % 2 == 1:
                c = 1
            elif i % 4 == 2 and j % 4 == 2:
                c = 2
            elif (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
                c = 3
            elif (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
                c = 4
            else:
                c = 5
            cls[i, j] = c
    return cls


_POS8 = _pos_class8()
MF8_TABLE = _MF8_CLASS[:, _POS8]          # (6, 8, 8)
V8_TABLE = _V8_CLASS[:, _POS8]            # (6, 8, 8)

# 8x8 zig-zag scan (spec Table 8-8, frame): coefficient index at each
# scan position.
ZIGZAG_8x8 = np.array([
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int64)

_UNZIGZAG_8x8 = np.zeros(64, np.int64)
_UNZIGZAG_8x8[ZIGZAG_8x8] = np.arange(64)

# Same level clamp as transform.MAX_LEVEL.
MAX_LEVEL = 2000


def _lines(x: torch.Tensor, axis_rows: bool):
    return [x[..., i, :] if axis_rows else x[..., :, i] for i in range(8)]


def _fwd8_1d(x: torch.Tensor, axis_rows: bool) -> torch.Tensor:
    """One forward 8-point pass (x264 DCT8_1D butterflies, exact int)."""
    g = _lines(x, axis_rows)
    s07, s16, s25, s34 = g[0] + g[7], g[1] + g[6], g[2] + g[5], g[3] + g[4]
    a0 = s07 + s34
    a1 = s16 + s25
    a2 = s07 - s34
    a3 = s16 - s25
    d07, d16, d25, d34 = g[0] - g[7], g[1] - g[6], g[2] - g[5], g[3] - g[4]
    a4 = d16 + d25 + (d07 + (d07 >> 1))
    a5 = d07 - d34 - (d25 + (d25 >> 1))
    a6 = d07 + d34 - (d16 + (d16 >> 1))
    a7 = d16 - d25 + (d34 + (d34 >> 1))
    outs = [a0 + a1, a4 + (a7 >> 2), a2 + (a3 >> 1), a5 + (a6 >> 2),
            a0 - a1, a6 - (a5 >> 2), (a2 >> 1) - a3, (a4 >> 2) - a7]
    return torch.stack(outs, dim=-2 if axis_rows else -1)


def fdct8(blocks: torch.Tensor) -> torch.Tensor:
    """Forward 8x8 transform over (..., 8, 8) int32 blocks: vertical
    pass (down the columns), then horizontal."""
    y = _fwd8_1d(blocks.to(torch.int32), axis_rows=True)
    return _fwd8_1d(y, axis_rows=False)


def _inv8_1d(w: torch.Tensor, axis_rows: bool) -> torch.Tensor:
    """One inverse 8-point pass (spec 8.5.13.2 butterflies)."""
    g = _lines(w, axis_rows)
    a0 = g[0] + g[4]
    a2 = g[0] - g[4]
    a4 = (g[2] >> 1) - g[6]
    a6 = g[2] + (g[6] >> 1)
    b0 = a0 + a6
    b2 = a2 + a4
    b4 = a2 - a4
    b6 = a0 - a6
    a1 = -g[3] + g[5] - g[7] - (g[7] >> 1)
    a3 = g[1] + g[7] - g[3] - (g[3] >> 1)
    a5 = -g[1] + g[7] + g[5] + (g[5] >> 1)
    a7 = g[3] + g[5] + g[1] + (g[1] >> 1)
    b1 = a1 + (a7 >> 2)
    b7 = a7 - (a1 >> 2)
    b3 = a3 + (a5 >> 2)
    b5 = (a3 >> 2) - a5
    outs = [b0 + b7, b2 + b5, b4 + b3, b6 + b1,
            b6 - b1, b4 - b3, b2 - b5, b0 - b7]
    return torch.stack(outs, dim=-2 if axis_rows else -1)


def idct8(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse 8x8 transform (spec 8.5.13.2): horizontal pass (within
    each row) first, then vertical, then (x + 32) >> 6."""
    y = _inv8_1d(coeffs.to(torch.int32), axis_rows=False)
    return (_inv8_1d(y, axis_rows=True) + 32) >> 6


def _table8(name: str, qp_mod: int, device: torch.device) -> torch.Tensor:
    """One (8, 8) MF8 or V8 matrix on ``device``."""
    tab = MF8_TABLE if name == "mf8" else V8_TABLE
    return constant(f"{name}_{qp_mod}", tab[qp_mod], device, torch.int32)


def quant8(coeffs: torch.Tensor, qp: int, intra: bool) -> torch.Tensor:
    """Quantize 8x8 coefficients: qbits = 16 + qp/6, deadzone /3 or /6."""
    qbits = 16 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    w = coeffs.to(torch.int32)
    mag = torch.clamp_max(
        (w.abs() * _table8("mf8", qp % 6, w.device) + f) >> qbits, MAX_LEVEL)
    return torch.where(w < 0, -mag, mag)


def dequant8(levels: torch.Tensor, qp: int) -> torch.Tensor:
    """Dequantize 8x8 levels: d = (c * V8 + 2^(1-per)) >> (2-per) below
    qp 12, c * V8 << (per-2) from there."""
    per = qp // 6
    prod = levels.to(torch.int32) * _table8("v8", qp % 6, levels.device)
    if per >= 2:
        return prod << (per - 2)
    return (prod + (1 << (1 - per))) >> (2 - per)


def to_blocks8(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) → (..., H/8, W/8, 8, 8)."""
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // 8, 8, w // 8, 8).movedim(-3, -2)


def from_blocks8(blocks: torch.Tensor) -> torch.Tensor:
    """(..., H/8, W/8, 8, 8) → (..., H, W)."""
    *lead, hb, wb, _, _ = blocks.shape
    return blocks.movedim(-2, -3).reshape(*lead, hb * 8, wb * 8)


def zigzag8(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) → (..., 64) in 8x8 zig-zag scan order."""
    flat = blocks.reshape(*blocks.shape[:-2], 64)
    return flat[..., constant("zigzag8x8", ZIGZAG_8x8, blocks.device)]


def unzigzag8(scan: torch.Tensor) -> torch.Tensor:
    """(..., 64) scan-order levels → (..., 8, 8) blocks."""
    out = scan[..., constant("unzigzag8x8", _UNZIGZAG_8x8, scan.device)]
    return out.reshape(*scan.shape[:-1], 8, 8)


# ---------------------------------------------------------------------------
# Numpy versions of the inverse path (host decoder)
# ---------------------------------------------------------------------------

def unzigzag8_np(scan):
    """(..., 64) scan-order levels → (..., 8, 8) coefficient blocks."""
    scan = np.asarray(scan)
    out = np.zeros(scan.shape, scan.dtype)
    out[..., ZIGZAG_8x8] = scan
    return out.reshape(*scan.shape[:-1], 8, 8)


def _inv8_1d_np(w, axis_rows: bool):
    def g(i):
        return w[..., i, :] if axis_rows else w[..., :, i]

    a0 = g(0) + g(4)
    a2 = g(0) - g(4)
    a4 = (g(2) >> 1) - g(6)
    a6 = g(2) + (g(6) >> 1)
    b0 = a0 + a6
    b2 = a2 + a4
    b4 = a2 - a4
    b6 = a0 - a6
    a1 = -g(3) + g(5) - g(7) - (g(7) >> 1)
    a3 = g(1) + g(7) - g(3) - (g(3) >> 1)
    a5 = -g(1) + g(7) + g(5) + (g(5) >> 1)
    a7 = g(3) + g(5) + g(1) + (g(1) >> 1)
    b1 = a1 + (a7 >> 2)
    b7 = a7 - (a1 >> 2)
    b3 = a3 + (a5 >> 2)
    b5 = (a3 >> 2) - a5
    outs = [b0 + b7, b2 + b5, b4 + b3, b6 + b1,
            b6 - b1, b4 - b3, b2 - b5, b0 - b7]
    return np.stack(outs, axis=-2 if axis_rows else -1)


def idct8_np(coeffs):
    w = np.asarray(coeffs, np.int32)
    y = _inv8_1d_np(w, axis_rows=False)
    out = _inv8_1d_np(y, axis_rows=True)
    return (out + 32) >> 6


def dequant8_np(levels, qp: int):
    v = np.asarray(V8_TABLE)[qp % 6]
    per = qp // 6
    prod = np.asarray(levels, np.int32) * v
    if per >= 2:
        return prod << (per - 2)
    return (prod + (1 << (1 - per))) >> (2 - per)
