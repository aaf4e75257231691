"""Inverse transforms and dequantisation in NumPy, copied from the port's
``ops/transform.py`` and ``ops/transform8.py``."""

from __future__ import annotations

import numpy as np


# from vcp_tpu_torch/ops/transform.py
_V_ABC = np.array([
    [10, 16, 13],
    [11, 18, 14],
    [13, 20, 16],
    [14, 23, 18],
    [16, 25, 20],
    [18, 29, 23],
], dtype=np.int32)


_POS_CLASS = np.array([
    [0, 2, 0, 2],
    [2, 1, 2, 1],
    [0, 2, 0, 2],
    [2, 1, 2, 1],
], dtype=np.int32)


V_TABLE = _V_ABC[:, _POS_CLASS]            # (6, 4, 4)


_CHROMA_QP_TAIL = np.array(
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38,
     38, 39, 39, 39, 39], dtype=np.int32)


CHROMA_QP_FULL = np.concatenate(
    [np.arange(30, dtype=np.int32), _CHROMA_QP_TAIL])  # (52,)


def chroma_qp(qp_y: int, offset: int = 0) -> int:
    q = int(np.clip(qp_y + offset, 0, 51))
    return int(CHROMA_QP_FULL[q])


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


# from vcp_tpu_torch/ops/transform8.py
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


V8_TABLE = _V8_CLASS[:, _POS8]            # (6, 8, 8)


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
