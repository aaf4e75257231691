"""deblock_general (plain version on the CPU) against vcp_tpu's
threshold-grid Pallas deblock kernel, with the strong filter and without
it (all-inter, per-MB QP), interpret mode, exact equality."""

import numpy as np
import pytest

import jax.numpy as jnp

from vcp_tpu.ops import deblock as jd
from vcp_tpu.ops import transform as jtf
from vcp_tpu_torch.ops import deblock as td
from vcp_tpu_torch.ops import deblock_cuda

from test_torch_deblock import CASES, _eq, _frame, _t


def _jax_grids(intra, nz, mv, qp_mb, cqp):
    """vcp_tpu's per-edge threshold grids, built as tests/test_deblock.py
    builds them for ``_deblock_pallas``."""
    def grid_v(bs_e, qp_e, rep):
        pad = jnp.zeros((1, bs_e.shape[1]), jnp.int32)
        bs = jnp.concatenate([pad, bs_e], axis=0).T
        qp = jnp.concatenate([pad, qp_e], axis=0).T
        return jd._thr_stack(jd._repeat_rows(bs.T, rep).T,
                             jd._repeat_rows(qp.T, rep).T)

    n_mby, n_mbx = qp_mb.shape
    hc, wc = 8 * n_mby, 8 * n_mbx
    bs_v = jd.compute_bs_luma(intra, nz, mv, True)
    bs_h = jd.compute_bs_luma(intra, nz, mv, False)
    vthr = grid_v(bs_v, jd.compute_qp_edges(qp_mb, True, False), 4)
    hthr = jnp.swapaxes(
        grid_v(bs_h, jd.compute_qp_edges(qp_mb, False, False), 4), 1, 2)
    cvthr = grid_v(
        jd._repeat_rows(bs_v[1::2], 2).reshape(wc // 4 - 1, hc),
        jd._repeat_rows(jd.compute_qp_edges(qp_mb, True, True, cqp), 4), 1)
    chthr = jnp.swapaxes(grid_v(
        jd._repeat_rows(bs_h[1::2], 2).reshape(hc // 4 - 1, wc),
        jd._repeat_rows(jd.compute_qp_edges(qp_mb, False, True, cqp), 4),
        1), 1, 2)
    return vthr, hthr, cvthr, chthr


@pytest.mark.parametrize("shape,intra_all", CASES)
def test_general_matches_pallas_kernel(shape, intra_all):
    """deblock_general_plain (the CUDA kernel's reference) against the
    TPU kernel ``wavefront_pallas`` with strong=True, interpret mode."""
    y, u, v, qp_mb, intra, nz, mv = _frame(13, *shape, intra_all)
    h, w = shape
    bs_v = jd.compute_bs_luma(intra, nz, mv, True)
    bs_h = jd.compute_bs_luma(intra, nz, mv, False)
    grids = _jax_grids(jnp.asarray(intra), jnp.asarray(nz),
                       jnp.asarray(mv), jnp.asarray(qp_mb),
                       jtf.CHROMA_QP_FULL)
    ref = jd._deblock_pallas(y, u, v, *grids, h // 16, w // 16,
                             interpret=True, strong=True)
    tgrids = td.threshold_grids(_t(np.asarray(bs_v)), _t(np.asarray(bs_h)),
                                _t(qp_mb))
    for a, b in zip(tgrids, grids):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _eq(deblock_cuda.deblock_general(_t(y), _t(u), _t(v), *tgrids), ref)


@pytest.mark.parametrize("shape", [(64, 80), (48, 64)])
def test_general_no_strong_matches_pallas_kernel(shape):
    """strong=False on an all-inter frame (bS <= 3) whose QP differs from
    MB to MB, the case the uniform-QP form cannot take: the plain version
    against ``wavefront_pallas`` with strong=False, interpret mode."""
    y, u, v, qp_mb, intra, nz, mv = _frame(17, *shape, False)
    h, w = shape
    qp_mb = np.random.default_rng(18).integers(20, 45, qp_mb.shape) \
        .astype(np.int32)
    bs_v = jd.compute_bs_luma(intra, nz, mv, True)
    bs_h = jd.compute_bs_luma(intra, nz, mv, False)
    assert int(np.asarray(bs_v).max()) <= 3 and len(np.unique(qp_mb)) > 1
    grids = _jax_grids(jnp.asarray(intra), jnp.asarray(nz),
                       jnp.asarray(mv), jnp.asarray(qp_mb),
                       jtf.CHROMA_QP_FULL)
    ref = jd._deblock_pallas(y, u, v, *grids, h // 16, w // 16,
                             interpret=True, strong=False)
    tgrids = td.threshold_grids(_t(np.asarray(bs_v)), _t(np.asarray(bs_h)),
                                _t(qp_mb))
    out = deblock_cuda.deblock_general(_t(y), _t(u), _t(v), *tgrids,
                                       strong=False)
    _eq(out, ref)
    assert not np.array_equal(out[0].numpy(), y)
    # and through deblock_frame's own route for this case
    _eq(td.deblock_frame(*map(_t, (y, u, v, qp_mb, intra, nz, mv)),
                         no_strong=True), ref)
