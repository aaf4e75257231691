"""Frame scaling for ``-s WxH`` / ``-vf scale=W:H`` (device op).

Port of ``vcp_tpu/ops/scale.py``, which is XLA there (no
``pallas_call``), so plain PyTorch here, on the device of its input.
:func:`bilinear_resize` keeps ``vcp_tpu``'s float32 op order step by step
(the sample grid ``(i + 0.5) * s - 0.5``, ``a * (1 - wx) + b * wx``
across, then the same down, round half to even, clamp, cast). XLA fuses
the whole function into one loop and LLVM contracts each of those three
multiply-adds into an FMA (one rounding); :func:`_fma` computes exactly
that rounding from float64 parts, so ``cuda`` equals ``cpu`` equals
``vcp_tpu`` bit for bit. Plain float32 ops differ in a few pixels of an
upscale, and ``torch.lerp``, ``addcmul`` and ``F.interpolate`` round
differently or sample another grid.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with a single rounding, as a fused
    multiply-add gives it: the product is exact in float64 (24 + 24
    bits), the sum is rounded to odd in float64 (TwoSum gives its exact
    error) and then to nearest even in float32, which rounds the exact
    value once."""
    p = a.double() * torch.as_tensor(b, dtype=torch.float64,
                                     device=a.device)
    c = torch.as_tensor(c, dtype=torch.float64, device=a.device)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)          # p + c == s + err exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _grid(n_in: int, n_out: int, dev: torch.device) -> torch.Tensor:
    """Sample centres, half-pixel aligned: (i + 0.5) * (n_in / n_out) -
    0.5 in float32, the multiply-add fused."""
    i = torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5
    return _fma(i, float(np.float32(n_in / n_out)), -0.5)


def bilinear_resize(plane: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """uint8 / int (H, W) -> (out_h, out_w) uint8 on the plane's device,
    bilinear with edge clamp, half-pixel aligned sample centres."""
    h, w = plane.shape
    dev = plane.device
    x = plane.to(torch.float32)
    ys = _grid(h, out_h, dev)
    xs = _grid(w, out_w, dev)
    y0 = torch.clamp(torch.floor(ys), 0, h - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = torch.clamp(ys - y0.to(torch.float32), 0.0, 1.0)[:, None]
    wx = torch.clamp(xs - x0.to(torch.float32), 0.0, 1.0)[None, :]
    a = x[y0][:, x0]
    b = x[y0][:, x1]
    c = x[y1][:, x0]
    d = x[y1][:, x1]
    top = _fma(a, 1 - wx, b * wx)
    bot = _fma(c, 1 - wx, d * wx)
    out = _fma(top, 1 - wy, bot * wy)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def scale_yuv420(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                 out_h: int, out_w: int, device: str = "cuda"):
    """Scale a 4:2:0 triplet of numpy planes on ``device``; output dims
    rounded down to even. Returns numpy uint8 planes."""
    dev = resolve_device(device)
    out_h, out_w = out_h & ~1, out_w & ~1
    return tuple(
        bilinear_resize(torch.from_numpy(np.ascontiguousarray(p)).to(dev),
                        oh, ow).cpu().numpy()
        for p, oh, ow in ((y, out_h, out_w), (u, out_h // 2, out_w // 2),
                          (v, out_h // 2, out_w // 2)))
