"""HEVC core transforms + quantization (spec 8.6), sizes 4/8/16/32.

Port of ``vcp_tpu/ops/transform_hevc.py``: the N-point integer DCT
approximations are matrix products over batched ``(..., N, N)`` int32
blocks, quant / dequant are elementwise int32 passes, and the numpy twins
(``*_np``) serve the host decoders.

The matrix products run as float64 ``torch.matmul`` on either device
(PyTorch has no int32 GEMM on CUDA). They are exact: every product sum
is an integer of magnitude below 2^31 (a residual of at most 255, or a
dequantized coefficient clipped to 16 bits, times at most 32 matrix
entries of magnitude <= 90: 32 * 90 * 32768 < 2^27 per stage), so it is
exact in float64's 53-bit mantissa, and it equals the int32 sum
``vcp_tpu`` takes from ``jnp.einsum(..., preferred_element_type=int32)``.
float32 would not do (exact only below 2^24, and TF32 rounds earlier).

The transform matrices are generated from the 32-entry integer cosine
lookup: ``M_N[k][n] = sign * G[fold((2n+1)k mod 128)]``, with the smaller
matrices embedded as every (32/N)-th row. Encoder forward scaling
follows the HM convention, dequant + inverse the normative path, so the
encoder's reconstruction is bit-exact with the decoders.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import constant

BIT_DEPTH = 8

# Integer cosine lookup G[i] ~ 64*sqrt(2)*cos(i*pi/64), i in [0, 32),
# with G[0] = 64 (DC) and the spec's hand-tuned entries (e.g. G[24] = 36).
G = np.array([
    64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
    64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4,
], np.int64)


def _cos_entry(t: int) -> int:
    """Lookup of the folded cosine value for angle t*pi/64 (t mod 128)."""
    t %= 128
    if t <= 32:
        return int(G[t]) if t < 32 else 0
    if t <= 64:
        return -int(G[64 - t])
    if t <= 96:
        return -int(G[t - 64])
    return int(G[128 - t])


@functools.lru_cache(maxsize=None)
def trans_matrix(n: int) -> np.ndarray:
    """The N-point HEVC transform matrix (rows = basis vectors)."""
    assert n in (4, 8, 16, 32)
    step = 32 // n
    m = np.empty((n, n), np.int64)
    for k in range(n):
        for x in range(n):
            m[k, x] = _cos_entry((2 * x + 1) * k * step)
    return m


# Forward quant scales indexed by qp % 6 (HM g_quantScales) and the
# normative dequant levelScale (spec 8.6.3).
QUANT_SCALE = np.array([26214, 23302, 20560, 18396, 16384, 14564], np.int64)
LEVEL_SCALE = np.array([40, 45, 51, 57, 64, 72], np.int64)

# Chroma QP mapping for 4:2:0 (spec Table 8-10): identity below 30, a
# compressed middle band, then qPi - 6.
_CHROMA_QP_MAP = np.concatenate([
    np.arange(30),
    np.array([29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37]),
    np.arange(44, 58) - 6,
]).astype(np.int32)


def chroma_qp(qp_y: int, offset: int = 0) -> int:
    q = min(max(qp_y + offset, 0), 57)
    return int(_CHROMA_QP_MAP[q])


# ---------------------------------------------------------------------------
# torch (device) path: batched (..., N, N) int32 blocks, Python-int QPs.
# ---------------------------------------------------------------------------

def _mat(n: int, device: torch.device) -> torch.Tensor:
    return constant(f"hevc_dct{n}", trans_matrix(n), device, torch.float64)


def _int32(x: torch.Tensor) -> torch.Tensor:
    """An exact float64 product sum back to int32 (no rounding needed)."""
    return x.to(torch.int32)


def fwd(blocks: torch.Tensor, log2: int) -> torch.Tensor:
    """Forward 2D transform of residual blocks ``(..., N, N)`` int32."""
    m = _mat(1 << log2, blocks.device)
    s1 = log2 + BIT_DEPTH - 9
    s2 = log2 + 6
    # stage 1 contracts the y (row) axis, stage 2 the x axis
    e = _int32(torch.matmul(m, blocks.to(torch.float64)))
    e = (e + (1 << (s1 - 1))) >> s1
    c = _int32(torch.matmul(e.to(torch.float64), m.T))
    return (c + (1 << (s2 - 1))) >> s2


def quant(coeffs: torch.Tensor, qp: int, log2: int,
          intra: bool) -> torch.Tensor:
    """Scalar quantization (HM convention, non-normative side)."""
    tshift = 15 - BIT_DEPTH - log2
    qbits = 14 + qp // 6 + tshift
    f = int(QUANT_SCALE[qp % 6])
    # rounding offset: ~1/3 intra, ~1/6 inter (HM defaults)
    off = ((1 << qbits) * (171 if intra else 85)) >> 9
    mag = (coeffs.abs() * f + off) >> qbits
    mag = mag.clamp(0, 32767)
    return coeffs.sign() * mag


def dequant(levels: torch.Tensor, qp: int, log2: int) -> torch.Tensor:
    """Normative scaling (spec 8.6.3, default flat scaling list m=16)."""
    bd_shift = log2 + BIT_DEPTH - 5
    ls = int(LEVEL_SCALE[qp % 6]) << (qp // 6)
    d = (levels * 16 * ls + (1 << (bd_shift - 1))) >> bd_shift
    return d.clamp(-32768, 32767)


def inv(coeffs: torch.Tensor, log2: int) -> torch.Tensor:
    """Normative inverse 2D transform (spec 8.6.4)."""
    m = _mat(1 << log2, coeffs.device)
    e = _int32(torch.matmul(m.T, coeffs.to(torch.float64)))
    e = ((e + 64) >> 7).clamp(-32768, 32767)
    s2 = 20 - BIT_DEPTH
    r = _int32(torch.matmul(e.to(torch.float64), m))
    return (r + (1 << (s2 - 1))) >> s2


def to_blocks(plane: torch.Tensor, n: int) -> torch.Tensor:
    """(H, W) -> (H//n, W//n, n, n) tiling."""
    h, w = plane.shape
    return plane.reshape(h // n, n, w // n, n).permute(0, 2, 1, 3)


def from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """(by, bx, n, n) -> (by*n, bx*n)."""
    by, bx, n, _ = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(by * n, bx * n)


# ---------------------------------------------------------------------------
# NumPy twins for the host decoders (the same integer math).
# ---------------------------------------------------------------------------

def dequant_np(levels: np.ndarray, qp: int, log2: int) -> np.ndarray:
    bd_shift = log2 + BIT_DEPTH - 5
    ls = int(LEVEL_SCALE[qp % 6]) << (qp // 6)
    d = (levels.astype(np.int64) * 16 * ls + (1 << (bd_shift - 1))) \
        >> bd_shift
    return np.clip(d, -32768, 32767).astype(np.int32)


def inv_np(coeffs: np.ndarray, log2: int) -> np.ndarray:
    m = trans_matrix(1 << log2)
    e = np.einsum("ky,...kx->...yx", m, coeffs.astype(np.int64))
    e = np.clip((e + 64) >> 7, -32768, 32767)
    s2 = 20 - BIT_DEPTH
    r = np.einsum("lx,...yl->...yx", m, e)
    return ((r + (1 << (s2 - 1))) >> s2).astype(np.int32)


def fwd_np(blocks: np.ndarray, log2: int) -> np.ndarray:
    m = trans_matrix(1 << log2)
    s1 = log2 + BIT_DEPTH - 9
    s2 = log2 + 6
    e = np.einsum("ky,...yx->...kx", m, blocks.astype(np.int64))
    e = (e + (1 << (s1 - 1))) >> s1
    c = np.einsum("lx,...kx->...kl", m, e)
    return ((c + (1 << (s2 - 1))) >> s2).astype(np.int32)


def quant_np(coeffs: np.ndarray, qp: int, log2: int, intra: bool) -> np.ndarray:
    tshift = 15 - BIT_DEPTH - log2
    qbits = 14 + qp // 6 + tshift
    f = int(QUANT_SCALE[qp % 6])
    off = ((1 << qbits) * (171 if intra else 85)) >> 9
    mag = (np.abs(coeffs.astype(np.int64)) * f + off) >> qbits
    mag = np.clip(mag, 0, 32767)
    return (np.sign(coeffs) * mag).astype(np.int32)
