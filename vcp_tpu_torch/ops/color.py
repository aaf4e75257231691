"""Colour-space conversion: NV12 / I420 / RGB, BT.601 limited range.

Port of ``vcp_tpu/ops/color.py`` as plain PyTorch on the caller's device
(XLA there, no TPU kernel). Exact integer arithmetic, so a conversion
gives the same samples on every device.

Layouts:
* I420 planar: Y (H, W), U / V (ceil(H/2), ceil(W/2))
* NV12: Y (H, W), interleaved UV (H/2, W)
* RGB: (H, W, 3) uint8
"""

from __future__ import annotations

import torch


def nv12_to_i420(y: torch.Tensor, uv: torch.Tensor):
    """NV12 interleaved chroma -> planar U, V."""
    return y, uv[:, 0::2], uv[:, 1::2]


def i420_to_nv12(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    hc, wc = u.shape
    return y, torch.stack([u, v], dim=-1).reshape(hc, 2 * wc)


def _upsample2(plane: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbour 2x chroma upsample, cut to (h, w)."""
    up = plane.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    return up[:h, :w]


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """BT.601 limited-range YUV 4:2:0 -> RGB888 (H, W, 3) uint8."""
    h, w = y.shape
    yf = (y.to(torch.int32) - 16) * 298
    uf = _upsample2(u.to(torch.int32), h, w) - 128
    vf = _upsample2(v.to(torch.int32), h, w) - 128
    r = (yf + 409 * vf + 128) >> 8
    g = (yf - 100 * uf - 208 * vf + 128) >> 8
    b = (yf + 516 * uf + 128) >> 8
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def rgb_to_yuv420(rgb: torch.Tensor):
    """RGB888 (H, W, 3), H and W even -> BT.601 limited-range YUV 4:2:0
    (2x2 box-filtered chroma) as three uint8 planes."""
    x = rgb.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    u = ((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128
    v = ((112 * r - 94 * g - 18 * b + 128) >> 8) + 128
    h, w = y.shape

    def box(c):
        return (c.reshape(h // 2, 2, w // 2, 2).sum(dim=(1, 3)) + 2) >> 2
    return (y.clamp(16, 235).to(torch.uint8),
            box(u).clamp(16, 240).to(torch.uint8),
            box(v).clamp(16, 240).to(torch.uint8))
