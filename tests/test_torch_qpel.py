"""The quarter-pel tools of vcp_tpu_torch (efforts 7-9) against vcp_tpu
on the CPU, tolerance 0: ``mc_luma_q`` (the 16-case quarter-pel MC) at
every block geometry and at the largest vectors the refinement reaches,
``refine_quarter`` / ``refine_subpel``, ``mc_chroma_q`` at odd phases
on the 8x8 partition grid, and the P and B steps at subpel 2."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcp_tpu.codec.h264 import gop_ops as jg
from vcp_tpu.ops import motion as jm
from vcp_tpu_torch.codec.h264 import gop_ops as tg
from vcp_tpu_torch.ops import motion as tm

GEOMETRIES = [16, 8, (8, 16), (16, 8)]


def _quarter_pair(seed, h, w, shift=(0.25, 1.75)):
    """Smooth texture moved by a quarter-pel amount, plus a little noise:
    quarter-pel candidates win in many blocks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)

    def tex(y, x):
        return (128 + 50 * np.sin(x / 3.1) * np.cos(y / 4.3)
                + 30 * np.sin((x + y) / 7.0))

    cur = np.clip(tex(yy, xx) + rng.integers(-2, 3, (h, w)), 0, 255)
    ref = np.clip(tex(yy + shift[0], xx + shift[1])
                  + rng.integers(-2, 3, (h, w)), 0, 255)
    return cur.astype(np.int32), ref.astype(np.int32)


def _planes(ref, sr):
    """Both packages' stacked half-pel planes of ``ref`` padded by sr + 6,
    and the margin (sr + 3) at which integer position (0, 0) sits."""
    pad = sr + 6
    jp = jnp.stack(jm.half_planes(jnp.pad(ref, pad, mode="edge")))
    tp = torch.stack(tm.half_planes(
        tm.pad_edge(torch.from_numpy(ref), pad, pad, pad, pad)))
    return jp, tp, pad - 3


def _grid(bs, h, w):
    bh, bw = (bs, bs) if isinstance(bs, int) else bs
    return h // bh, w // bw


@pytest.mark.parametrize("bs", GEOMETRIES)
@pytest.mark.parametrize("kind", ["random", "edge+", "edge-", "corners"])
def test_mc_luma_q(bs, kind):
    """Every phase at every geometry, and vectors at +-(4 sr + 5): a
    full-pel vector stays within +-sr, the half-pel step adds up to 2
    quarters and the quarter-pel walk up to 3 (its three steps of -1,
    or of +1, along an axis can all win), and the sr + 3 margin of the
    planes holds every sample those vectors read."""
    sr, h, w = 8, 48, 64
    rng = np.random.default_rng(GEOMETRIES.index(bs))
    _, ref = _quarter_pair(7, h, w)
    ref[:3, :5] = 255          # extremes at the corners: the clamps act
    ref[-2:, -4:] = 0
    jp, tp, margin = _planes(ref, sr)
    lim = 4 * sr + 5
    nby, nbx = _grid(bs, h, w)
    if kind == "random":
        mvq = rng.integers(-lim, lim + 1, (nby, nbx, 2))
    elif kind == "corners":
        mvq = rng.choice([-lim, -lim + 1, lim - 1, lim], (nby, nbx, 2))
    else:
        mvq = np.full((nby, nbx, 2), lim if kind == "edge+" else -lim)
        mvq[..., 1] -= rng.integers(0, 4, (nby, nbx))   # every x phase
    mvq = mvq.astype(np.int32)
    want = np.asarray(jm.mc_luma_q(jp, jnp.asarray(mvq), margin, bs=bs))
    got = tm.mc_luma_q(tp, torch.from_numpy(mvq), margin, bs=bs)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mc_luma_q_every_case():
    """Each of the 16 quarter-pel cases as a frame-uniform vector."""
    _, ref = _quarter_pair(8, 32, 48)
    jp, tp, margin = _planes(ref, 4)
    for case in range(16):
        mvq = np.broadcast_to(np.array([4 + case // 4, -8 + case % 4],
                                       np.int32), (2, 3, 2)).copy()
        want = np.asarray(jm.mc_luma_q(jp, jnp.asarray(mvq), margin))
        got = tm.mc_luma_q(tp, torch.from_numpy(mvq), margin)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(case))


@pytest.mark.parametrize("bs", GEOMETRIES)
@pytest.mark.parametrize("sr,lam,seed", [(8, 4, 1), (16, 0, 2), (4, 9, 3)])
def test_refine_subpel(bs, sr, lam, seed):
    """refine_half, then refine_quarter around it, as refine_subpel and
    piecewise, from full-pel vectors that reach the search range."""
    h, w = 48, 64
    cur, ref = _quarter_pair(seed, h, w)
    jp, tp, margin = _planes(ref, sr)
    nby, nbx = _grid(bs, h, w)
    rng = np.random.default_rng(seed)
    mvf = rng.integers(-1, 2, (nby, nbx, 2)).astype(np.int32)
    mvf[0, 0] = (-sr, sr)            # the window's corners
    mvf[-1, -1] = (sr, -sr)
    cur_t, mvf_t = torch.from_numpy(cur), torch.from_numpy(mvf)
    want_h = np.asarray(jm.refine_subpel(cur, jp, mvf, lam, margin, bs=bs))
    got_h = tm.refine_subpel(cur_t, tp, mvf_t, lam, margin, bs=bs)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    want = np.asarray(jm.refine_subpel(cur, jp, mvf, lam, margin,
                                       quarter=True, bs=bs))
    got = tm.refine_subpel(cur_t, tp, mvf_t, lam, margin, quarter=True,
                           bs=bs)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tm.refine_quarter(cur_t, tp, got_h, lam, margin, bs=bs).numpy(),
        want)
    assert (np.abs(want) <= 4 * sr + 5).all()


def test_refine_quarter_picks_odd_phases():
    """On content moved by a quarter-pel amount the refinement leaves
    the half-pel grid in most blocks."""
    cur, ref = _quarter_pair(4, 64, 96)
    jp, tp, margin = _planes(ref, 8)
    mvf = np.zeros((4, 6, 2), np.int32)
    mvq = tm.refine_subpel(torch.from_numpy(cur), tp,
                           torch.from_numpy(mvf), 2, margin, quarter=True)
    odd = ((mvq.numpy() & 1) == 1).any(-1)
    assert odd.mean() > 0.5, odd
    np.testing.assert_array_equal(
        mvq.numpy(), np.asarray(jm.refine_subpel(cur, jp, mvf, 2, margin,
                                                 quarter=True)))


@pytest.mark.parametrize("sr", [8, 16, 24])
def test_mc_chroma_q_odd_phases_bs8(sr):
    """Chroma MC of quarter-pel luma vectors (every 1/8 phase) on the
    8x8 partition grid, up to +-(4 sr + 5)."""
    rng = np.random.default_rng(sr)
    m = sr // 2 + 2
    ru = rng.integers(0, 256, (32, 48)).astype(np.int32)
    lim = 4 * sr + 5
    mvq = rng.integers(-lim, lim + 1, (8, 12, 2)).astype(np.int32)
    mvq[0, :2] = ((lim, lim), (-lim, -lim))
    assert set((mvq & 7).ravel().tolist()) == set(range(8))
    got = tm.mc_chroma_q(torch.from_numpy(ru), torch.from_numpy(mvq), m,
                         bs=8)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jm.mc_chroma_q(ru, mvq, m, bs=8)))


def _planes3(seed, h, w, shift):
    cur, ref = _quarter_pair(seed, h, w, shift)
    rng = np.random.default_rng(seed)
    cu, ru = (rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
              for _ in range(2))
    return (cur, cu, cu), (ref, ru, ru)


def test_pstep_subpel2():
    """The chunked P step at subpel 2 (``-preset p7 -bf 0``): pyramid
    search at +-16, quarter-pel refinement, the 16-case MC, the 8x8
    transform, deblocking."""
    cur, ref = _planes3(11, 64, 96, (0.75, -2.25))
    pstep = jax.jit(functools.partial(jg._pstep, subpel=2, deblock=True,
                                      t8=True), static_argnums=(8,))
    want = pstep(*[jnp.asarray(a) for a in cur + ref], 24, 24, 16, 6)
    got = tg._pstep(*[torch.from_numpy(a) for a in cur + ref], 24, 24, 16,
                    6, subpel=2, deblock=True, t8=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mv = got[0].reshape(-1, tg.MB_WORDS)[:, :2].numpy()
    assert ((mv & 1) == 1).any(), "no quarter-pel vector"


def test_bframe_subpel2_dominant_snap():
    """The B step at subpel 2: both lists quarter-refined, the uniform
    candidate's vector snapped to the quarter grid (snap 1)."""
    cur, r0 = _planes3(12, 64, 96, (0.25, 1.25))
    _, r1 = _planes3(13, 64, 96, (-0.5, -1.75))
    args = cur + r0 + r1
    want = jg.encode_bframe(*[jnp.asarray(a) for a in args], 28, 28, 16, 7,
                            2, True)
    got = tg.encode_bframe(*[torch.from_numpy(a) for a in args], 28, 28, 16,
                           7, 2, True)
    for k in ("mv0", "mv1", "mode", "recon_y", "recon_u", "recon_v"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    mv = np.concatenate([got["mv0"].numpy(), got["mv1"].numpy()])
    assert ((mv & 1) == 1).any(), "no quarter-pel vector"


@pytest.mark.parametrize("snap", [1, 2, 4])
def test_dominant_mv_snap(snap):
    """The frame-dominant vector: lower median, floored to the snap
    grid (1 keeps quarter phases), for odd and even MB counts."""
    rng = np.random.default_rng(snap)
    for n in (15, 16):
        mv = rng.integers(-37, 38, (n, 1, 2)).astype(np.int32)
        flat = np.sort(mv.reshape(-1, 2), axis=0)[(n - 1) // 2]
        want = (flat // snap) * snap
        got = tg.dominant_mv(torch.from_numpy(mv), snap).numpy()
        np.testing.assert_array_equal(got, want)
