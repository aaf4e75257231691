"""The port's colour conversion (``ops/color.py``) against vcp_tpu's, at
tolerance 0, on frames drawn from numpy seeds: NV12 <-> I420, YUV 4:2:0
-> RGB (even sizes and odd crops, whose chroma planes are a sample
wider or taller than half), RGB -> YUV 4:2:0 over the whole 0..255 cube,
and an RGB round trip."""

import numpy as np
import pytest
import torch

from vcp_tpu.ops import color as jc
from vcp_tpu_torch.ops import color as tc


def _planes(rng, h, w):
    hc, wc = (h + 1) // 2, (w + 1) // 2
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (hc, wc), dtype=np.uint8),
            rng.integers(0, 256, (hc, wc), dtype=np.uint8))


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("shape", [(32, 64), (6, 10)])
def test_nv12_i420(shape):
    rng = np.random.default_rng(shape[0])
    y, u, v = _planes(rng, *shape)
    jy, juv = jc.i420_to_nv12(y, u, v)
    ty, tuv = tc.i420_to_nv12(*_t(y, u, v))
    assert np.array_equal(np.asarray(juv), tuv.numpy())
    assert np.array_equal(np.asarray(jy), ty.numpy())
    back = tc.nv12_to_i420(ty, tuv)
    ref = jc.nv12_to_i420(jy, juv)
    for a, b in zip(ref, back):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert all(np.array_equal(a, b.numpy()) for a, b in zip((y, u, v),
                                                             back))


@pytest.mark.parametrize("shape", [(48, 64), (17, 31), (35, 20), (1, 1)])
def test_yuv420_to_rgb(shape):
    """Every sample value, including the odd crops: the chroma planes are
    ceil(H/2) x ceil(W/2) and the upsample is cut to (H, W)."""
    rng = np.random.default_rng(sum(shape))
    y, u, v = _planes(rng, *shape)
    ref = np.asarray(jc.yuv420_to_rgb(y, u, v))
    got = tc.yuv420_to_rgb(*_t(y, u, v))
    assert got.dtype == torch.uint8 and got.shape == (*shape, 3)
    assert np.array_equal(ref, got.numpy())


@pytest.mark.parametrize("shape", [(32, 48), (2, 2), (18, 6)])
def test_rgb_to_yuv420(shape):
    rng = np.random.default_rng(7 + shape[1])
    rgb = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    rgb[0, 0] = (0, 0, 0)
    rgb[-1, -1] = (255, 255, 255)
    ref = jc.rgb_to_yuv420(rgb)
    got = tc.rgb_to_yuv420(torch.from_numpy(rgb))
    for a, b in zip(ref, got):
        assert b.dtype == torch.uint8
        assert np.array_equal(np.asarray(a), b.numpy())


def test_round_trip():
    """RGB -> YUV -> RGB through the port equals vcp_tpu's round trip."""
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    j = np.asarray(jc.yuv420_to_rgb(*jc.rgb_to_yuv420(rgb)))
    t = tc.yuv420_to_rgb(*tc.rgb_to_yuv420(torch.from_numpy(rgb)))
    assert np.array_equal(j, t.numpy())
