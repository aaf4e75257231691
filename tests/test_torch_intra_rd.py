"""RD intra frames of vcp_tpu_torch against vcp_tpu's on the CPU: the
I16 / i8 frame ``intra_rd.encode_iframe_rd8`` on gradient, texture and
noise content, and the I16-only frame ``encode_iframe_rd`` (anti-diagonal
wavefront) at frames taller and wider than they are long, QPs 0, 28 and
51, with and without the deblock: every output array equal. The float32 costs that drive the
decisions are compared with a relative tolerance of 1e-5 (the port sums
the bit proxies exactly, XLA in float32 in its own order; and XLA's log2
differs from the port's table by one float32 step in about half the
entries), the decisions themselves exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vcp_tpu.codec.h264 import intra_rd as jir
from vcp_tpu.ops import transform as jtf
from vcp_tpu_torch.codec.h264 import intra_rd as tir
from vcp_tpu_torch.codec.h264 import rdcost

H, W = 64, 96


def _content(kind, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    if kind == "gradient":
        y = 40 + 1.3 * xx + 0.9 * yy + 8 * np.sin((xx + 2 * yy) / 9.0)
    elif kind == "texture":
        y = 128 + 70 * np.sin(xx / 2.3) * np.cos(yy / 1.7) \
            + rng.integers(-12, 13, (H, W))
    else:
        y = rng.integers(0, 256, (H, W)).astype(np.float64)
    cy, cx = np.mgrid[0:H // 2, 0:W // 2].astype(np.float64)
    u = 128 + 40 * np.sin(cx / 6.0) + rng.integers(-3, 4, (H // 2, W // 2))
    v = 90 + 1.5 * cy + rng.integers(-3, 4, (H // 2, W // 2))
    return tuple(np.clip(p, 0, 255).astype(np.uint8) for p in (y, u, v))


def _t(a):
    return torch.from_numpy(np.array(a))


CASES = [("gradient", 24, True), ("gradient", 36, False),
         ("texture", 20, True), ("texture", 30, False),
         ("noise", 28, True), ("noise", 44, False)]


@pytest.mark.parametrize("kind,qp,deblock", CASES)
def test_encode_iframe_rd8(kind, qp, deblock):
    y, u, v = _content(kind, qp)
    qpc = jtf.chroma_qp(qp)
    want = jir.encode_iframe_rd8(y, u, v, qp, qpc, deblock)
    got = tir.encode_iframe_rd8(_t(y), _t(u), _t(v), qp, qpc, deblock)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    i8 = got["i8"].numpy()
    # the losing representation's levels are zeroed
    assert not got["i8_luma"].numpy()[~i8].any()
    assert not got["luma_ac"].numpy()[i8].any()


def test_both_mb_types_win_somewhere():
    """Across the cases above some MBs choose I_NxN/i8 and some I16, and
    every I16 and chroma mode and most i8 modes occur."""
    i8, modes, cmodes, i8_modes = [], [], [], []
    for kind, qp, deblock in CASES:
        out = tir.encode_iframe_rd8(*map(_t, _content(kind, qp)), qp,
                                    jtf.chroma_qp(qp), deblock)
        use = out["i8"].numpy()
        i8.append(use.mean())
        modes.append(out["modes"].numpy()[~use])
        cmodes.append(out["cmodes"].numpy())
        i8_modes.append(out["i8_modes"].numpy()[use])
    assert max(i8) > 0.3 and min(i8) < 0.7, i8
    assert set(np.concatenate(modes)) == {0, 1, 2, 3}
    assert set(np.concatenate([c.ravel() for c in cmodes])) == {0, 1, 2, 3}
    assert len(set(np.concatenate([m.ravel() for m in i8_modes]))) >= 6


# (content, MB rows, MB columns): n_mby > n_mbx and n_mby < n_mbx
RD_SHAPES = [("gradient", 5, 3), ("texture", 3, 6)]


@pytest.mark.parametrize("kind,nby,nbx", RD_SHAPES)
@pytest.mark.parametrize("qp", [0, 28, 51])
@pytest.mark.parametrize("deblock", [True, False])
def test_encode_iframe_rd(kind, nby, nbx, qp, deblock):
    y, u, v = (p[:16 * nby // k, :16 * nbx // k]
               for p, k in zip(_content(kind, qp), (1, 2, 2)))
    qpc = jtf.chroma_qp(qp)
    want = jir.encode_iframe_rd(y, u, v, qp, qpc, deblock)
    got = tir.encode_iframe_rd(_t(y), _t(u), _t(v), qp, qpc, deblock)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_encode_iframe_rd_modes():
    """Across the shapes and QPs above every I16 and chroma mode is
    chosen somewhere."""
    modes, cmodes = set(), set()
    for kind, nby, nbx in RD_SHAPES:
        for qp in (0, 28, 51):
            y, u, v = (_t(p[:16 * nby // k, :16 * nbx // k])
                       for p, k in zip(_content(kind, qp), (1, 2, 2)))
            out = tir.encode_iframe_rd(y, u, v, qp, jtf.chroma_qp(qp))
            modes |= set(out["modes"].numpy().ravel().tolist())
            cmodes |= set(out["cmodes"].numpy().ravel().tolist())
    assert modes == cmodes == {0, 1, 2, 3}


def test_diagonal_maps_and_tables():
    from vcp_tpu.codec.h264.decoder import _I8_TABS
    from vcp_tpu.codec.h265.intra_rd import diagonal_maps2
    for shape in ((4, 6), (1, 5), (7, 2), (68, 120)):
        for a, b in zip(tir.diagonal_maps2(*shape), diagonal_maps2(*shape)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tir.diagonal_maps(*shape),
                        jir._diagonal_maps(*shape)):
            np.testing.assert_array_equal(a, b)
    assert tir.diagonal_maps(68, 120)[0].shape == (187, 68)
    ref = np.stack([np.stack(_I8_TABS[m]) for m in range(3, 9)])
    np.testing.assert_array_equal(tir.I8_TABS, ref)
    assert (tir.I16_OVERHEAD_BITS, tir.I8_OVERHEAD_BITS) == \
        (jir.I16_OVERHEAD_BITS, jir.I8_OVERHEAD_BITS)
    np.testing.assert_array_equal(tir._CHROMA_UE_BITS, jir._CHROMA_UE_BITS)


@pytest.mark.parametrize("qp", [18, 27, 41])
def test_luma_and_i8_trials(qp):
    """One batch of lanes through the I16 trial and the 8x8 block trial:
    modes, levels and recon exact, the winning costs to 1e-5."""
    rng = np.random.default_rng(qp)
    n = 12
    lam2 = rdcost.lam2_for_qp(qp)
    base = rng.integers(30, 220, (n, 1, 1))
    cur = np.clip(base + rng.integers(-25, 26, (n, 16, 16)), 0, 255) \
        .astype(np.int32)
    top = np.clip(base[:, 0] + rng.integers(-20, 21, (n, 16)), 0, 255) \
        .astype(np.int32)
    left = np.clip(base[:, 0] + rng.integers(-20, 21, (n, 16)), 0, 255) \
        .astype(np.int32)
    corner = base[:, 0, 0].astype(np.int32)
    avt = rng.random(n) < 0.7
    avl = rng.random(n) < 0.7
    want = jir._luma_modes(cur, top, left, corner, avt, avl, qp,
                           jnp.float32(lam2))
    got = tir._luma_modes(_t(cur), _t(top), _t(left), _t(corner), _t(avt),
                          _t(avl), qp, lam2)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-5)

    avtl = avt & avl
    avtr = avt & (rng.random(n) < 0.5)
    pred_mode = rng.integers(0, 9, n).astype(np.int32)
    args = (cur[:, :8, :8], top, left[:, :8], corner, avt, avl, avtl, avtr)
    want = jir._i8_block_trial(*args, qp, jnp.float32(lam2), pred_mode)
    got = tir._i8_block_trial(*map(_t, args), qp, lam2, _t(pred_mode))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-5)


def test_rdcost_pieces():
    """lambda2 equals XLA's for every QP; the level-bit table is within
    one float32 step of XLA's log2 form; first_argmin takes the first
    minimum like jnp.argmin."""
    for qp in range(52):
        want = 0.9 * jnp.power(2.0, (jnp.int32(qp) - 12) / 3.0)
        assert rdcost.lam2_for_qp(qp) == float(np.asarray(want)), qp
    a = jnp.arange(rdcost.MAX_LEVEL + 1).astype(jnp.float32)
    want = np.asarray(jnp.where(a > 0, 2.0 * jnp.log2(a + 1.0) + 1.7, 0.0))
    got = rdcost._bits_table()
    assert got.dtype == np.float32 and got[0] == 0
    np.testing.assert_allclose(got, want, rtol=2e-7)
    rng = np.random.default_rng(0)
    c = rng.integers(0, 3, (9, 40)).astype(np.float32)
    c[:, 0] = np.inf
    for dim in (0, 1):
        np.testing.assert_array_equal(
            rdcost.first_argmin(_t(c), dim).numpy(),
            np.asarray(jnp.argmin(c, axis=dim)))
    lv = rng.integers(-2000, 2001, (4, 6, 16, 16)).astype(np.int32)
    want = np.asarray(jir._bits_proxy(lv))
    np.testing.assert_allclose(
        rdcost.level_bits(_t(lv), (2, 3)).numpy(), want, rtol=1e-6)
