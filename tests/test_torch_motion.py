"""Plain motion search / MC and the half-pel tools of vcp_tpu_torch
against vcp_tpu (XLA code and the Pallas search kernel in interpret mode,
with and without its fused prediction), exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vcp_tpu.ops import motion as jm
from vcp_tpu.ops.motion_pallas import full_search_pallas
from vcp_tpu_torch.ops import motion as tm
from vcp_tpu_torch.ops import motion_cuda


def _pair(seed, h, w, shift=(1, -2), noise=3):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, (h, w)).astype(np.int32)
    ref = np.clip(np.roll(cur, shift, (0, 1))
                  + rng.integers(-noise, noise + 1, (h, w)), 0, 255)
    return cur, ref.astype(np.int32)


@pytest.mark.parametrize("sr,lam", [(4, 4), (8, 4), (8, 0)])
def test_full_search_and_mc_luma(sr, lam):
    cur, ref = _pair(sr + lam, 64, 80)
    mv_j, cost_j = jm.full_search(cur, ref, sr, lam)
    mv_t, cost_t = tm.full_search(torch.from_numpy(cur),
                                  torch.from_numpy(ref), sr, lam)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(cost_t.numpy(), np.asarray(cost_j))
    pred = tm.mc_luma(torch.from_numpy(ref), mv_t, sr)
    np.testing.assert_array_equal(pred.numpy(),
                                  np.asarray(jm.mc_luma(ref, mv_j, sr)))


def test_flat_content_ties():
    """All-equal SADs: the first offset in dy-major, dx-ascending order
    wins (lam 0), and the zero vector wins with lam > 0."""
    cur = np.full((48, 64), 77, np.int32)
    for lam in (0, 3):
        mv_j, _ = jm.full_search(cur, cur, 4, lam)
        mv_t, _ = tm.full_search(torch.from_numpy(cur),
                                 torch.from_numpy(cur), 4, lam)
        np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))


@pytest.mark.parametrize("sr", [4, 8])
def test_plain_matches_pallas_kernel(sr):
    """The plain version (the CUDA kernel's reference) against the TPU
    kernel itself, interpret mode, with the fused prediction."""
    cur, ref = _pair(100 + sr, 64, 128)
    mv_p, pred_p = full_search_pallas(cur, ref, sr, 4, interpret=True,
                                      with_pred=True)
    mv_t, pred_t = motion_cuda.motion_search(
        torch.from_numpy(cur), torch.from_numpy(ref), sr, 4, with_pred=True)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_p))
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_p))


@pytest.mark.parametrize("sr", [4, 8])
def test_plain_matches_pallas_search_only_kernel(sr):
    """The search-only TPU kernel (no fused prediction), interpret mode,
    against the wrapper's plain version."""
    cur, ref = _pair(200 + sr, 64, 128, shift=(-2, 3))
    mv_p = full_search_pallas(cur, ref, sr, 4, interpret=True)
    mv_t = motion_cuda.motion_search(torch.from_numpy(cur),
                                     torch.from_numpy(ref), sr, 4)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_p))
    assert mv_t.numpy().any()


def _subpel_pair(seed, h, w, shift=(0.5, 1.5)):
    """Smooth texture moved by a fractional number of pixels, plus a
    little noise: half-pel candidates win in most MBs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)

    def tex(y, x):
        return (128 + 50 * np.sin(x / 3.1) * np.cos(y / 4.3)
                + 30 * np.sin((x + y) / 7.0))

    cur = np.clip(tex(yy, xx) + rng.integers(-2, 3, (h, w)), 0, 255)
    ref = np.clip(tex(yy + shift[0], xx + shift[1])
                  + rng.integers(-2, 3, (h, w)), 0, 255)
    return cur.astype(np.int32), ref.astype(np.int32)


@pytest.mark.parametrize("sr,seed", [(4, 1), (8, 2)])
def test_half_planes(sr, seed):
    _, ref = _subpel_pair(seed, 48, 80)
    ref[:3, :5] = 255          # extremes at a corner: the clamps act
    ref[-2:, -4:] = 0
    pad = sr + 6
    want = jm.half_planes(jnp.pad(ref, pad, mode="edge"))
    got = tm.half_planes(tm.pad_edge(torch.from_numpy(ref), pad, pad, pad,
                                     pad))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("sr,lam,seed", [(4, 4, 3), (8, 5, 4), (8, 0, 5)])
def test_half_pel_refine_and_mc(sr, lam, seed):
    """refine_half, mc_luma_h and the fused refine_half_mc each against
    vcp_tpu's, and the fused pair against the unfused one directly."""
    cur, ref = _subpel_pair(seed, 64, 96)
    pad = sr + 6
    margin = pad - 3
    jp = jnp.stack(jm.half_planes(jnp.pad(ref, pad, mode="edge")))
    tp = torch.stack(tm.half_planes(
        tm.pad_edge(torch.from_numpy(ref), pad, pad, pad, pad)))
    mv_full, _ = jm.full_search(cur, ref, sr, lam)
    mvf_t = torch.from_numpy(np.array(mv_full))
    cur_t = torch.from_numpy(cur)

    mvq_j = jm.refine_half(cur, jp, mv_full, lam, margin)
    mvq_t = tm.refine_half(cur_t, tp, mvf_t, lam, margin)
    np.testing.assert_array_equal(mvq_t.numpy(), np.asarray(mvq_j))
    assert ((mvq_t.numpy() & 3) == 2).any(), "no half-pel vector chosen"
    pred_j = jm.mc_luma_h(jp, mvq_j, margin)
    pred_t = tm.mc_luma_h(tp, mvq_t, margin)
    np.testing.assert_array_equal(pred_t.numpy(), np.asarray(pred_j))

    mvq_fj, pred_fj = jm.refine_half_mc(cur, jp, mv_full, lam, margin)
    mvq_ft, pred_ft = tm.refine_half_mc(cur_t, tp, mvf_t, lam, margin)
    np.testing.assert_array_equal(mvq_ft.numpy(), np.asarray(mvq_fj))
    np.testing.assert_array_equal(pred_ft.numpy(), np.asarray(pred_fj))
    assert torch.equal(mvq_ft, mvq_t) and torch.equal(pred_ft, pred_t)


@pytest.mark.parametrize("sr,lam", [(12, 0), (12, 8), (16, 8)])
def test_hier_search(sr, lam):
    """The pyramid search on smooth content moved by several pixels, on
    shifted noise, and on noise that decorrelates (the zero vector)."""
    for cur, ref in (_subpel_pair(1, 64, 96, (3.5, -6.0)),
                     _pair(2, 64, 96, (5, -9)),
                     _pair(3, 48, 64, (0, 0), noise=40)):
        want = np.asarray(jm.hier_search(cur, ref, sr, lam))
        got = tm.hier_search(torch.from_numpy(cur), torch.from_numpy(ref),
                             sr, lam)
        np.testing.assert_array_equal(got.numpy(), want)


def test_aligned_windows():
    rng = np.random.default_rng(6)
    planes = rng.integers(0, 256, (4, 64 + 22, 80 + 22)).astype(np.int32)
    mv = rng.integers(-8, 9, (4, 5, 2)).astype(np.int32)
    got = tm.aligned_windows(torch.from_numpy(planes), torch.from_numpy(mv),
                             11)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jm.aligned_windows(jnp.asarray(planes), mv,
                                                   11)))


@pytest.mark.parametrize("sr", [4, 8])
def test_mc_chroma_q(sr):
    rng = np.random.default_rng(sr)
    m = sr // 2 + 2
    ru = rng.integers(0, 255, (48, 64)).astype(np.int32)
    mvq = rng.integers(-4 * sr - 2, 4 * sr + 3, (6, 8, 2)).astype(np.int32)
    got = tm.mc_chroma_q(torch.from_numpy(ru), torch.from_numpy(mvq), m)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jm.mc_chroma_q(ru, mvq, m)))


def test_wrapper_on_cpu_runs_plain_without_launch():
    cur, ref = _pair(3, 32, 48)
    def counts():
        return (motion_cuda.motion_search.launches_with_pred,
                motion_cuda.motion_search.launches_search_only)
    before = counts()
    mv = motion_cuda.motion_search(torch.from_numpy(cur),
                                   torch.from_numpy(ref), 4, 4)
    mv_j, _ = jm.full_search(cur, ref, 4, 4)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_j))
    motion_cuda.motion_search(torch.from_numpy(cur), torch.from_numpy(ref),
                              4, 4, with_pred=True)
    assert counts() == before
