"""8x8 transform, quantizer and scans of vcp_tpu_torch against vcp_tpu's
``ops/transform8.py``, exact equality."""

import numpy as np
import pytest
import torch

from vcp_tpu.ops import transform8 as j8
from vcp_tpu_torch.ops import transform8 as t8

QPS = [0, 5, 11, 12, 23, 30, 37, 51]


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _res(seed, shape=(3, 5, 8, 8), lo=-255, hi=256):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, shape).astype(np.int32)


def test_tables():
    np.testing.assert_array_equal(t8.MF8_TABLE, j8.MF8_TABLE)
    np.testing.assert_array_equal(t8.V8_TABLE, j8.V8_TABLE)
    np.testing.assert_array_equal(t8.ZIGZAG_8x8, j8.ZIGZAG_8x8)
    assert t8.MAX_LEVEL == j8.MAX_LEVEL


@pytest.mark.parametrize("seed", [0, 1])
def test_fdct8_idct8(seed):
    x = _res(seed)
    _eq(t8.fdct8(torch.from_numpy(x)), j8.fdct8(x))
    # idct8 on coefficient-sized input, including its largest magnitudes
    c = _res(seed + 10, lo=-(1 << 15), hi=1 << 15)
    _eq(t8.idct8(torch.from_numpy(c)), j8.idct8(c))
    flat = np.full((1, 8, 8), 255, np.int32)
    _eq(t8.fdct8(torch.from_numpy(flat)), j8.fdct8(flat))


@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("qp", QPS)
def test_quant8_dequant8(qp, intra):
    coef = np.array(j8.fdct8(_res(qp)))
    coef[0, 0, 0, 0] = 1 << 17            # reaches the level clamp
    z_j = j8.quant8(coef, qp, intra)
    z_t = t8.quant8(torch.from_numpy(coef), qp, intra)
    _eq(z_t, z_j)
    assert int(z_t.abs().max()) <= t8.MAX_LEVEL
    _eq(t8.dequant8(z_t, qp), j8.dequant8(np.asarray(z_j), qp))


@pytest.mark.parametrize("qp", [10, 26, 40])
def test_roundtrip_recon(qp):
    """The whole luma path of a plane: blocks, transform, quantize,
    dequantize, inverse, back to the plane."""
    rng = np.random.default_rng(qp)
    plane = rng.integers(-60, 61, (32, 48)).astype(np.int32)

    def run(m, x):
        z = m.quant8(m.fdct8(m.to_blocks8(x)), qp, intra=False)
        return z, m.from_blocks8(m.idct8(m.dequant8(z, qp)))

    z_j, rec_j = run(j8, plane)
    z_t, rec_t = run(t8, torch.from_numpy(plane))
    _eq(z_t, z_j)
    _eq(rec_t, rec_j)
    assert z_t.any()


def test_blocks_and_scans():
    plane = _res(7, (2, 32, 48), 0, 256)
    b_j = j8.to_blocks8(plane)
    b_t = t8.to_blocks8(torch.from_numpy(plane))
    _eq(b_t, b_j)
    _eq(t8.from_blocks8(b_t), plane)
    s_j = j8.zigzag8(np.asarray(b_j))
    s_t = t8.zigzag8(b_t)
    _eq(s_t, s_j)
    _eq(t8.unzigzag8(s_t), j8.unzigzag8_jnp(np.asarray(s_j)))
    _eq(t8.unzigzag8(s_t), b_j)
