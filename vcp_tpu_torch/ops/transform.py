"""H.264 integer transforms + quantization on torch tensors (exact int32).

Port of ``vcp_tpu/ops/transform.py``: forward/inverse 4x4 core transform
(spec 8.5.12), the 4x4 and 2x2 Hadamards for the Intra_16x16 luma DC and
the chroma DC, and the quantizer / dequantizer (level = (|W| * MF + f) >>
qbits, qbits = 15 + qP/6; DC variants use 2f and qbits + 1). Blocks are
shaped (..., 4, 4) with arbitrary leading dims; every op stays int32 on
the tensor's own device. QP is a plain Python int argument of each call.
Numpy versions of the inverse path (``*_np``) serve the host decoder.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import constant

# MF (forward quant multipliers) per qp%6 at coefficient-position classes
# a=(0,0)-like, b=(1,1)-like, c=other.
_MF_ABC = np.array([
    [13107, 5243, 8066],
    [11916, 4660, 7490],
    [10082, 4194, 6554],
    [9362, 3647, 5825],
    [8192, 3355, 5243],
    [7282, 2893, 4559],
], dtype=np.int32)

# V (dequant scale) per qp%6, same position classes.
_V_ABC = np.array([
    [10, 16, 13],
    [11, 18, 14],
    [13, 20, 16],
    [14, 23, 18],
    [16, 25, 20],
    [18, 29, 23],
], dtype=np.int32)

# Position-class map for a 4x4 block: 0 at (0,0),(0,2),(2,0),(2,2);
# 1 at (1,1),(1,3),(3,1),(3,3); 2 elsewhere.
_POS_CLASS = np.array([
    [0, 2, 0, 2],
    [2, 1, 2, 1],
    [0, 2, 0, 2],
    [2, 1, 2, 1],
], dtype=np.int32)

MF_TABLE = _MF_ABC[:, _POS_CLASS]          # (6, 4, 4)
V_TABLE = _V_ABC[:, _POS_CLASS]            # (6, 4, 4)

# Chroma QP mapping (Table 8-15) for qPi 30..51; below 30 QPc = qPi.
_CHROMA_QP_TAIL = np.array(
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38,
     38, 39, 39, 39, 39], dtype=np.int32)

CHROMA_QP_FULL = np.concatenate(
    [np.arange(30, dtype=np.int32), _CHROMA_QP_TAIL])  # (52,)

# Levels are clamped so the CAVLC level escape can always represent them;
# the clamp is applied before recon too, so encoder and decoder agree.
MAX_LEVEL = 2000


def chroma_qp(qp_y: int, offset: int = 0) -> int:
    q = int(np.clip(qp_y + offset, 0, 51))
    return int(CHROMA_QP_FULL[q])


def _table(name: str, qp_mod: int, device: torch.device) -> torch.Tensor:
    """One (4, 4) MF or V matrix on ``device``."""
    tab = MF_TABLE if name == "mf" else V_TABLE
    return constant(f"{name}{qp_mod}", tab[qp_mod], device, torch.int32)


# ---------------------------------------------------------------------------
# Core 4x4 transform. Blocks shaped (..., 4, 4), int32.
# ---------------------------------------------------------------------------

def fdct4(blocks: torch.Tensor) -> torch.Tensor:
    """Forward core transform W = Cf X Cf^T (butterfly form, exact)."""
    x = blocks.to(torch.int32)
    a = x[..., 0, :] + x[..., 3, :]
    b = x[..., 1, :] + x[..., 2, :]
    c = x[..., 1, :] - x[..., 2, :]
    d = x[..., 0, :] - x[..., 3, :]
    y = torch.stack([a + b, 2 * d + c, a - b, d - 2 * c], dim=-2)
    a = y[..., :, 0] + y[..., :, 3]
    b = y[..., :, 1] + y[..., :, 2]
    c = y[..., :, 1] - y[..., :, 2]
    d = y[..., :, 0] - y[..., :, 3]
    return torch.stack([a + b, 2 * d + c, a - b, d - 2 * c], dim=-1)


def idct4(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse core transform with the spec's (x + 32) >> 6 rounding;
    horizontal pass first, then vertical (spec 8.5.12.2)."""
    w = coeffs.to(torch.int32)
    e0 = w[..., :, 0] + w[..., :, 2]
    e1 = w[..., :, 0] - w[..., :, 2]
    e2 = (w[..., :, 1] >> 1) - w[..., :, 3]
    e3 = w[..., :, 1] + (w[..., :, 3] >> 1)
    y = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)
    e0 = y[..., 0, :] + y[..., 2, :]
    e1 = y[..., 0, :] - y[..., 2, :]
    e2 = (y[..., 1, :] >> 1) - y[..., 3, :]
    e3 = y[..., 1, :] + (y[..., 3, :] >> 1)
    out = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-2)
    return (out + 32) >> 6


def hadamard4(blocks: torch.Tensor) -> torch.Tensor:
    """4x4 Hadamard (unnormalized butterflies), used both directions."""
    x = blocks.to(torch.int32)
    a = x[..., 0, :] + x[..., 3, :]
    b = x[..., 1, :] + x[..., 2, :]
    c = x[..., 1, :] - x[..., 2, :]
    d = x[..., 0, :] - x[..., 3, :]
    y = torch.stack([a + b, d + c, a - b, d - c], dim=-2)
    a = y[..., :, 0] + y[..., :, 3]
    b = y[..., :, 1] + y[..., :, 2]
    c = y[..., :, 1] - y[..., :, 2]
    d = y[..., :, 0] - y[..., :, 3]
    return torch.stack([a + b, d + c, a - b, d - c], dim=-1)


def hadamard2(blocks: torch.Tensor) -> torch.Tensor:
    """2x2 Hadamard for chroma DC, shape (..., 2, 2)."""
    x = blocks.to(torch.int32)
    y = torch.stack([x[..., 0, :] + x[..., 1, :],
                     x[..., 0, :] - x[..., 1, :]], dim=-2)
    return torch.stack([y[..., :, 0] + y[..., :, 1],
                        y[..., :, 0] - y[..., :, 1]], dim=-1)


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

def _fq(qp: int, intra: bool) -> tuple[int, int]:
    qbits = 15 + qp // 6
    return qbits, (1 << qbits) // (3 if intra else 6)


def _signed(w: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    return torch.where(w < 0, -mag, mag)


def quant4(coeffs: torch.Tensor, qp: int, intra: bool) -> torch.Tensor:
    """Quantize 4x4 core coefficients: (..., 4, 4) int32 → levels."""
    qbits, f = _fq(qp, intra)
    w = coeffs.to(torch.int32)
    mf = _table("mf", qp % 6, w.device)
    mag = torch.clamp_max((w.abs() * mf + f) >> qbits, MAX_LEVEL)
    return _signed(w, mag)


def dequant4(levels: torch.Tensor, qp: int) -> torch.Tensor:
    """Dequantize 4x4 AC/core levels: W' = Z * V * 2^(qp/6)."""
    v = _table("v", qp % 6, levels.device)
    return (levels.to(torch.int32) * v) << (qp // 6)


def quant_dc4(dc_had: torch.Tensor, qp: int,
              intra: bool = True) -> torch.Tensor:
    """Quantize Intra_16x16 luma DC: input = hadamard4(dc) >> 1."""
    qbits, f = _fq(qp, intra)
    mf00 = int(MF_TABLE[qp % 6, 0, 0])
    w = dc_had.to(torch.int32)
    mag = torch.clamp_max((w.abs() * mf00 + 2 * f) >> (qbits + 1),
                          MAX_LEVEL)
    return _signed(w, mag)


def dequant_dc4(levels: torch.Tensor, qp: int) -> torch.Tensor:
    """Dequantize luma DC after inverse Hadamard (spec 8.5.10)."""
    v00 = int(V_TABLE[qp % 6, 0, 0])
    per = qp // 6
    f = hadamard4(levels)
    if per >= 2:
        return (f * v00) << (per - 2)
    return (f * v00 + (1 << (1 - per))) >> (2 - per)


def quant_dc2(dc_had: torch.Tensor, qp: int, intra: bool) -> torch.Tensor:
    """Quantize chroma DC: input = hadamard2(dc) (no halving)."""
    qbits, f = _fq(qp, intra)
    mf00 = int(MF_TABLE[qp % 6, 0, 0])
    w = dc_had.to(torch.int32)
    mag = torch.clamp_max((w.abs() * mf00 + 2 * f) >> (qbits + 1),
                          MAX_LEVEL)
    return _signed(w, mag)


def dequant_dc2(levels: torch.Tensor, qp: int) -> torch.Tensor:
    """Dequantize chroma DC after inverse 2x2 Hadamard (spec 8.5.11):
    dc = (f * V00 << per) >> 1."""
    v00 = int(V_TABLE[qp % 6, 0, 0])
    return ((hadamard2(levels) * v00) << (qp // 6)) >> 1


# ---------------------------------------------------------------------------
# Block (de)tiling helpers
# ---------------------------------------------------------------------------

def to_blocks4(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, W) → (..., H/4, W/4, 4, 4)."""
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // 4, 4, w // 4, 4).movedim(-3, -2)


def from_blocks4(blocks: torch.Tensor) -> torch.Tensor:
    """(..., H/4, W/4, 4, 4) → (..., H, W)."""
    *lead, hb, wb, _, _ = blocks.shape
    return blocks.movedim(-2, -3).reshape(*lead, hb * 4, wb * 4)


# ---------------------------------------------------------------------------
# Numpy versions of the inverse path (host decoder)
# ---------------------------------------------------------------------------
# The host H.264 decoder inverts one macroblock (or one MB row) at a time;
# these carry the same integer math as the tensor versions above.

def idct4_np(coeffs):
    w = np.asarray(coeffs, np.int32)
    e0 = w[..., :, 0] + w[..., :, 2]
    e1 = w[..., :, 0] - w[..., :, 2]
    e2 = (w[..., :, 1] >> 1) - w[..., :, 3]
    e3 = w[..., :, 1] + (w[..., :, 3] >> 1)
    y = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    e0 = y[..., 0, :] + y[..., 2, :]
    e1 = y[..., 0, :] - y[..., 2, :]
    e2 = (y[..., 1, :] >> 1) - y[..., 3, :]
    e3 = y[..., 1, :] + (y[..., 3, :] >> 1)
    out = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-2)
    return (out + 32) >> 6


def hadamard4_np(blocks):
    x = np.asarray(blocks, np.int32)
    a = x[..., 0, :] + x[..., 3, :]
    b = x[..., 1, :] + x[..., 2, :]
    c = x[..., 1, :] - x[..., 2, :]
    d = x[..., 0, :] - x[..., 3, :]
    y = np.stack([a + b, d + c, a - b, d - c], axis=-2)
    a = y[..., :, 0] + y[..., :, 3]
    b = y[..., :, 1] + y[..., :, 2]
    c = y[..., :, 1] - y[..., :, 2]
    d = y[..., :, 0] - y[..., :, 3]
    return np.stack([a + b, d + c, a - b, d - c], axis=-1)


def hadamard2_np(blocks):
    x = np.asarray(blocks, np.int32)
    s0 = x[..., 0, :] + x[..., 1, :]
    s1 = x[..., 0, :] - x[..., 1, :]
    y = np.stack([s0, s1], axis=-2)
    return np.stack([y[..., :, 0] + y[..., :, 1],
                     y[..., :, 0] - y[..., :, 1]], axis=-1)


def dequant4_np(levels, qp: int):
    v = np.asarray(V_TABLE)[qp % 6]
    return np.asarray(levels, np.int32) * v << (qp // 6)


def dequant_dc4_np(levels, qp: int):
    v00 = int(V_TABLE[qp % 6, 0, 0])
    per = qp // 6
    f = hadamard4_np(levels)
    if per >= 2:
        return (f * v00) << (per - 2)
    return (f * v00 + (1 << (1 - per))) >> (2 - per)


def dequant_dc2_np(levels, qp: int):
    v00 = int(V_TABLE[qp % 6, 0, 0])
    per = qp // 6
    f = hadamard2_np(levels)
    return (f * v00 << per) >> 1


def dequant4_np_qpmap(levels, qp_map):
    """4x4 dequant with a QP per macroblock: ``levels`` (nMBy, nMBx, B,
    4, 4), ``qp_map`` (nMBy, nMBx) (the NumPy inter reconstruction of a
    whole picture, whose MBs may each carry an mb_qp_delta)."""
    qp = np.asarray(qp_map, np.int32)
    v = np.asarray(V_TABLE)[qp % 6]                # (nMBy, nMBx, 4, 4)
    sh = (qp // 6)[..., None, None, None]
    return (np.asarray(levels, np.int32) * v[:, :, None, :, :]) << sh


def dequant_dc2_np_qpmap(levels, qpc_map):
    """Chroma DC dequant with a chroma QP per macroblock: ``levels``
    (nMBy, nMBx, 2, 2), ``qpc_map`` (nMBy, nMBx)."""
    qp = np.asarray(qpc_map, np.int32)
    v00 = np.asarray(V_TABLE)[qp % 6, 0, 0]        # (nMBy, nMBx)
    f = hadamard2_np(levels)
    return (f * v00[..., None, None] << (qp // 6)[..., None, None]) >> 1
