"""Plain deblocking of vcp_tpu_torch against vcp_tpu's XLA wavefront,
boundary strengths and tables (the cases of tests/test_deblock.py), exact
equality. The Pallas kernels are compared in test_torch_deblock_general
and test_torch_deblock_fast."""

import numpy as np
import pytest
import torch

from vcp_tpu.ops import deblock as jd
from vcp_tpu.ops import transform as jtf
from vcp_tpu_torch.ops import deblock as td
from vcp_tpu_torch.ops import deblock_cuda


def _frame(seed, h, w, intra_all, density=0.5, qp=30, sparse_mv=False):
    rng = np.random.default_rng(seed)
    n_mby, n_mbx = h // 16, w // 16
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    qp_mb = np.full((n_mby, n_mbx), qp, np.int32)
    intra = np.full((n_mby, n_mbx), intra_all, bool)
    nz = rng.random((h // 4, w // 4)) < density
    mv = rng.integers(-8, 9, (n_mby, n_mbx, 2))
    if sparse_mv:
        mv = (rng.random((n_mby, n_mbx, 1)) < max(density, 0.2)) * mv
    return y, u, v, qp_mb, intra, nz, mv.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


CASES = [((64, 80), False), ((48, 64), True)]


@pytest.mark.parametrize("shape,intra_all", CASES)
def test_deblock_frame_matches_xla(shape, intra_all):
    args = _frame(11, *shape, intra_all)
    ref = jd.deblock_frame(*args, jtf.CHROMA_QP_FULL)
    _eq(td.deblock_frame(*map(_t, args)), ref)


@pytest.mark.parametrize("vertical", [True, False])
@pytest.mark.parametrize("intra_all", [True, False])
def test_bs_and_qp_edges(vertical, intra_all):
    y, u, v, qp_mb, intra, nz, mv = _frame(31, 64, 96, intra_all)
    qp_mb = np.random.default_rng(3).integers(0, 52, qp_mb.shape)
    qp_mb = qp_mb.astype(np.int32)
    np.testing.assert_array_equal(
        td.compute_bs_luma(_t(intra), _t(nz), _t(mv), vertical).numpy(),
        np.asarray(jd.compute_bs_luma(intra, nz, mv, vertical)))
    for chroma in (False, True):
        np.testing.assert_array_equal(
            td.compute_qp_edges(_t(qp_mb), vertical, chroma).numpy(),
            np.asarray(jd.compute_qp_edges(qp_mb, vertical, chroma,
                                           jtf.CHROMA_QP_FULL)))


@pytest.mark.parametrize("vertical", [True, False])
@pytest.mark.parametrize("intra_all", [True, False])
def test_bs_with_t8_grid(vertical, intra_all):
    """Interior 4-offset edges of transform-8x8 MBs get bS 0."""
    y, u, v, qp_mb, intra, nz, mv = _frame(33, 64, 96, intra_all)
    t8 = np.random.default_rng(34).random(qp_mb.shape) < 0.5
    got = td.compute_bs_luma(_t(intra), _t(nz), _t(mv), vertical,
                             t8=_t(t8)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jd.compute_bs_luma(intra, nz, mv, vertical, t8=t8)))
    plain = td.compute_bs_luma(_t(intra), _t(nz), _t(mv), vertical).numpy()
    assert (got != plain).any() and (got[1::2] == plain[1::2]).all()


@pytest.mark.parametrize("intra_all,no_strong", [(True, False),
                                                 (False, True)])
def test_deblock_frame_with_t8_matches_xla(intra_all, no_strong):
    args = _frame(12, 64, 80, intra_all)
    t8 = np.random.default_rng(35).random(args[3].shape) < 0.5
    kw = dict(no_strong=no_strong, qp_scalar=30 if no_strong else None)
    ref = jd.deblock_frame(*args, jtf.CHROMA_QP_FULL, t8=t8, **kw)
    _eq(td.deblock_frame(*map(_t, args), t8=_t(t8), **kw), ref)


def test_tables_and_scalars():
    for name in ("ALPHA", "BETA", "TC0"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
    for qp in range(52):
        qc = int(jtf.CHROMA_QP_FULL[qp])
        want = (jd.ALPHA[qp], jd.BETA[qp], *jd.TC0[:, qp],
                jd.ALPHA[qc], jd.BETA[qc], *jd.TC0[:, qc])
        assert td.deblock_scalars(qp) == tuple(int(x) for x in want)


def test_wrappers_on_cpu_do_not_launch():
    y, u, v, qp_mb, intra, nz, mv = _frame(5, 32, 48, False)
    def counts():
        return (deblock_cuda.deblock_fast.launches,
                deblock_cuda.deblock_general.launches,
                deblock_cuda.deblock_general.launches_no_strong)
    before = counts()
    td.deblock_frame(*map(_t, (y, u, v, qp_mb, intra, nz, mv)))
    td.deblock_frame(*map(_t, (y, u, v, qp_mb, intra, nz, mv)),
                     no_strong=True, qp_scalar=30)
    td.deblock_frame(*map(_t, (y, u, v, qp_mb, intra, nz, mv)),
                     no_strong=True)
    assert counts() == before
