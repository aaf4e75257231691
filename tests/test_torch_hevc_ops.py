"""vcp_tpu_torch.ops.transform_hevc and ops.deblock_hevc, and the numpy
twins of the HEVC MC, against vcp_tpu on the CPU: the same seeded numpy
inputs, exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcp_tpu.codec.h265 import frame_ops as jfo
from vcp_tpu.ops import deblock_hevc as jdb
from vcp_tpu.ops import transform_hevc as jth
from vcp_tpu_torch.codec.h265 import frame_ops as tfo
from vcp_tpu_torch.ops import deblock_hevc as tdb
from vcp_tpu_torch.ops import transform_hevc as tth

QPS = range(52)


def _t(a):
    return torch.from_numpy(np.array(a, np.int32))


def _eq(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_array_equal(port, np.asarray(ref))


def test_tables_equal():
    for n in (4, 8, 16, 32):
        _eq(tth.trans_matrix(n), jth.trans_matrix(n))
    _eq(tth.QUANT_SCALE, jth.QUANT_SCALE)
    _eq(tth.LEVEL_SCALE, jth.LEVEL_SCALE)
    _eq(tdb.BETA_TABLE, jdb.BETA_TABLE)
    _eq(tdb.TC_TABLE, jdb.TC_TABLE)
    for off in (-12, -3, 0, 2, 12):
        assert [tth.chroma_qp(q, off) for q in range(-4, 60)] == \
            [jth.chroma_qp(q, off) for q in range(-4, 60)]


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("intra", [True, False])
def test_transform_chain_all_qps(log2, intra):
    """fwd, quant, dequant and inv of +-255 residuals at every QP: the
    torch path (float64 matmuls), vcp_tpu's int32 einsums and the numpy
    twins agree exactly."""
    n = 1 << log2
    rng = np.random.default_rng(log2)
    res = rng.integers(-255, 256, (6, n, n)).astype(np.int32)
    res[0] = 255
    res[1] = -255
    res[2] = np.where((np.arange(n)[:, None] + np.arange(n)) % 2, 255, -255)
    c_j = np.asarray(jth.fwd(res, log2))
    c_t = tth.fwd(_t(res), log2)
    _eq(c_t, c_j)
    _eq(tth.fwd_np(res, log2), c_j)
    for qp in QPS:
        z_j = np.asarray(jth.quant(c_j, qp, log2, intra))
        z_t = tth.quant(c_t, qp, log2, intra)
        _eq(z_t, z_j)
        _eq(tth.quant_np(c_j, qp, log2, intra), z_j)
        d_j = np.asarray(jth.dequant(z_j, qp, log2))
        d_t = tth.dequant(z_t, qp, log2)
        _eq(d_t, d_j)
        _eq(tth.dequant_np(z_j, qp, log2), d_j)
        r_j = np.asarray(jth.inv(d_j, log2))
        _eq(tth.inv(d_t, log2), r_j)
        _eq(tth.inv_np(d_j, log2), r_j)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_inverse_of_saturated_coefficients(log2):
    """The inverse transform of coefficients at the 16-bit clip (+-32768,
    the largest dequant output): the widest sums the float64 matmul sees
    stay exact."""
    n = 1 << log2
    rng = np.random.default_rng(10 + log2)
    c = rng.choice(np.array([-32768, 32767, 0], np.int32), (5, n, n))
    c[0] = 32767
    c[1] = -32768
    _eq(tth.inv(_t(c), log2), jth.inv(c, log2))
    _eq(tth.inv_np(c, log2), jth.inv(c, log2))


def test_blocks_round_trip():
    x = np.arange(64 * 96, dtype=np.int32).reshape(64, 96)
    b = tth.to_blocks(_t(x), 32)
    _eq(b, jth.to_blocks(x, 32))
    _eq(tth.from_blocks(b), x)


def _planes(rng, h, w, kind):
    if kind == "noise":
        return tuple(rng.integers(0, 256, s).astype(np.int32)
                     for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    # smooth planes with small steps on the block grid: the normal and
    # strong filters both fire
    yy, xx = np.mgrid[0:h, 0:w]
    y = 100 + (xx // 8) * 3 + (yy // 8) * 2 + rng.integers(-1, 2, (h, w))
    cy, cx = np.mgrid[0:h // 2, 0:w // 2]
    u = 120 + (cx // 8) * 4 + rng.integers(-1, 2, cy.shape)
    v = 130 - (cy // 8) * 4 + rng.integers(-1, 2, cy.shape)
    return tuple(np.clip(p, 0, 255).astype(np.int32) for p in (y, u, v))


@pytest.mark.parametrize("kind", ["steps", "noise"])
@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("qp", [0, 22, 30, 37, 51])
def test_deblock_frame(kind, intra, qp):
    """deblock_frame_hevc (torch), its numpy entry point and vcp_tpu's
    jnp and numpy versions, intra and P (random nz / mv grids)."""
    rng = np.random.default_rng(qp + 7 * intra)
    h, w = 96, 128
    y, u, v = _planes(rng, h, w, kind)
    qpc = jth.chroma_qp(qp)
    kw = {}
    if not intra:
        nz32 = rng.random((h // 32, w // 32)) < 0.5
        mv = rng.integers(-9, 10, (h // 32, w // 32, 2)).astype(np.int32)
        mv[0, 1] = mv[0, 0] + [0, 3]            # a difference below 4
        kw = {"nz32": nz32, "mv": mv}
    ref = jdb.deblock_frame_hevc(
        *(jnp.asarray(p) for p in (y, u, v)), qp, qpc, intra,
        **{k: jnp.asarray(a) for k, a in kw.items()})
    ref_np = jdb.deblock_frame_hevc(y, u, v, qp, qpc, intra, xp=np, **kw)
    tkw = {k: torch.from_numpy(a) for k, a in kw.items()}
    out = tdb.deblock_frame_hevc(_t(y), _t(u), _t(v), qp, qpc, intra, **tkw)
    out_np = tdb.deblock_frame_hevc_np(y, u, v, qp, qpc, intra, **kw)
    changed = 0
    for a, b, c, d, src in zip(out, out_np, ref, ref_np, (y, u, v)):
        _eq(a, c)
        _eq(b, c)
        _eq(np.asarray(d), c)
        changed += int((np.asarray(c) != src).sum())
    if qp >= 30 and kind == "steps":
        assert changed > 0                     # the filter did work


def test_edge_filters_with_per_segment_thresholds():
    """The foreign decoder's use of the luma / chroma edge filters (numpy,
    a beta and tc per segment, as its AQ streams need), against vcp_tpu's
    and the torch namespace."""
    rng = np.random.default_rng(3)
    p = rng.integers(90, 140, (5, 12, 4, 4)).astype(np.int32)
    q = p[..., ::-1] + rng.integers(-6, 7, p.shape).astype(np.int32)
    bs = rng.integers(0, 3, (5, 12)).astype(np.int32)
    beta = jdb.BETA_TABLE[rng.integers(20, 52, (5, 12))]
    tc = jdb.TC_TABLE[rng.integers(20, 54, (5, 12))]
    ref = jdb._luma_edge_filter(p, q, bs, beta, tc, np)
    for got in (tdb._luma_edge_filter(p, q, bs, beta, tc, np),
                tdb._luma_edge_filter(_t(p), _t(q), _t(bs), _t(beta),
                                      _t(tc), torch)):
        for a, b in zip(got, ref):
            _eq(a, b)
    pc = rng.integers(0, 256, (5, 16, 2)).astype(np.int32)
    qc = rng.integers(0, 256, (5, 16, 2)).astype(np.int32)
    bsc = np.where(rng.random((5, 16)) < 0.5, 2, 0).astype(np.int32)
    tcc = jdb.TC_TABLE[rng.integers(0, 54, (5, 16))]
    ref = jdb._chroma_edge_filter(pc, qc, bsc, tcc, np)
    for got in (tdb._chroma_edge_filter(pc, qc, bsc, tcc, np),
                tdb._chroma_edge_filter(_t(pc), _t(qc), _t(bsc), _t(tcc),
                                        torch)):
        for a, b in zip(got, ref):
            _eq(a, b)


@pytest.mark.parametrize("span", [3, 20, 69])
def test_mc_numpy_twins(span):
    """The validation decoder's MC twins equal vcp_tpu's, and the
    quarter-pel ones equal the torch MC over the fractional planes at
    vectors up to +-``span`` quarter samples."""
    rng = np.random.default_rng(span)
    ref = rng.integers(0, 256, (64, 96)).astype(np.int32)
    refc = rng.integers(0, 256, (32, 48)).astype(np.int32)
    mvq = rng.integers(-span, span + 1, (2, 3, 2)).astype(np.int32)
    mvf = mvq >> 2
    _eq(tfo.mc_luma_np(ref, mvf), jfo.mc_luma_np(ref, mvf))
    _eq(tfo.mc_chroma_np(refc, mvf), jfo.mc_chroma_np(refc, mvf))
    _eq(tfo.mc_luma_q_np(ref, mvq), jfo.mc_luma_q_np(ref, mvq))
    _eq(tfo.mc_chroma_q_np(refc, mvq), jfo.mc_chroma_q_np(refc, mvq))
    pad = span // 4 + 4
    planes = tfo.luma_frac_planes(_t(ref), pad)
    _eq(tfo.mc_luma_q(planes, _t(mvq), pad), jfo.mc_luma_q_np(ref, mvq))
    cpad = span // 8 + 3
    _eq(tfo.mc_chroma_q(_t(refc), _t(mvq), cpad),
        jfo.mc_chroma_q_np(refc, mvq))
