"""The schedule of the one-launch deblocking kernel, on the CPU.

``deblock_mb_plain`` filters what one block step of ``deblock_wave``
filters. Applied to every macroblock in any order that respects the
kernel's wait rule (row y in order; before MB x of row y, row y-1 has
finished MB min(x+1, nMBx-1)) it must equal ``deblock_general_plain`` and,
through it, vcp_tpu's Pallas kernel in interpret mode; an order that
breaks the rule by one MB must not. Exact equality throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vcp_tpu.ops import deblock as jd
from vcp_tpu.ops import transform as jtf
from vcp_tpu_torch.ops import deblock as td

from test_torch_deblock import _eq, _t
from test_torch_deblock_general import _jax_grids

SHAPES = [(64, 80), (48, 64), (16, 96), (80, 16)]


def _dense_frame(seed, h, w, intra_all):
    """Smooth content with 4x4 blocking steps and per-MB QPs high enough
    that most edges are filtered."""
    rng = np.random.default_rng(seed)
    n_mby, n_mbx = h // 16, w // 16

    def plane(hh, ww):
        yy, xx = np.mgrid[0:hh, 0:ww]
        steps = np.repeat(np.repeat(
            rng.integers(-6, 7, (hh // 4, ww // 4)), 4, 0), 4, 1)
        return np.clip(100 + (xx * 60) // ww + (yy * 40) // hh + steps
                       + rng.integers(-2, 3, (hh, ww)), 0, 255) \
            .astype(np.int32)

    y, u, v = plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2)
    qp_mb = rng.integers(30, 45, (n_mby, n_mbx)).astype(np.int32)
    intra = np.full((n_mby, n_mbx), intra_all, bool)
    nz = rng.random((h // 4, w // 4)) < 0.6
    mv = rng.integers(-8, 9, (n_mby, n_mbx, 2)).astype(np.int32)
    return y, u, v, qp_mb, intra, nz, mv


def _bs(intra, nz, mv):
    return (td.compute_bs_luma(_t(intra), _t(nz), _t(mv), True),
            td.compute_bs_luma(_t(intra), _t(nz), _t(mv), False))


def _run_order(planes, grids, order, strong):
    y, u, v = (_t(p).clone() for p in planes)
    for mbx, mby in order:
        td.deblock_mb_plain(y, u, v, grids, mbx, mby, strong)
    return y, u, v


def _raster(n_mby, n_mbx):
    return [(x, y) for y in range(n_mby) for x in range(n_mbx)]


def _diagonal(n_mby, n_mbx, lag=2):
    """Wavefront order d = mbx + lag * mby, lower rows first within a
    diagonal; lag 2 is the spec-order wavefront, lag 1 starts MB (x, y)
    after MB (x, y-1) but before MB (x+1, y-1)."""
    return [(d - lag * y, y) for d in range(n_mbx + lag * (n_mby - 1))
            for y in reversed(range(n_mby)) if 0 <= d - lag * y < n_mbx]


def _random_legal(n_mby, n_mbx, seed):
    """A random order bound only by the kernel's wait rule."""
    rng = np.random.default_rng(seed)
    done = [0] * n_mby
    order = []
    while len(order) < n_mby * n_mbx:
        ready = [y for y in range(n_mby) if done[y] < n_mbx and (
            y == 0 or done[y - 1] >= min(done[y] + 2, n_mbx))]
        y = int(rng.choice(ready))
        order.append((done[y], y))
        done[y] += 1
    return order


ORDERS = {"raster": _raster, "diagonal": _diagonal,
          **{f"random{s}": (lambda a, b, s=s: _random_legal(a, b, 100 + s))
             for s in range(5)}}


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("shape", SHAPES)
def test_mb_steps_in_legal_order_match_plain(shape, order):
    h, w = shape
    intra_all = shape in ((48, 64), (80, 16))   # strong filter on these
    y, u, v, qp_mb, intra, nz, mv = _dense_frame(41, h, w, intra_all)
    grids = td.threshold_grids(*_bs(intra, nz, mv), _t(qp_mb))
    ref = td.deblock_general_plain(_t(y), _t(u), _t(v), *grids,
                                   strong=intra_all)
    assert int((ref[0] != _t(y)).sum()) > y.size // 20
    out = _run_order((y, u, v), grids, ORDERS[order](h // 16, w // 16),
                     intra_all)
    _eq(out, ref)


@pytest.mark.parametrize("shape,intra_all", [((64, 80), False),
                                             ((48, 64), True)])
def test_mb_steps_match_pallas_kernel(shape, intra_all):
    """The per-MB steps against the TPU kernel ``wavefront_pallas`` in
    interpret mode, as test_torch_deblock_general runs it."""
    h, w = shape
    y, u, v, qp_mb, intra, nz, mv = _dense_frame(43, h, w, intra_all)
    jgrids = _jax_grids(jnp.asarray(intra), jnp.asarray(nz),
                        jnp.asarray(mv), jnp.asarray(qp_mb),
                        jtf.CHROMA_QP_FULL)
    ref = jd._deblock_pallas(y, u, v, *jgrids, h // 16, w // 16,
                             interpret=True, strong=intra_all)
    grids = td.threshold_grids(*_bs(intra, nz, mv), _t(qp_mb))
    out = _run_order((y, u, v), grids,
                     _random_legal(h // 16, w // 16, 7), intra_all)
    _eq(out, ref)


@pytest.mark.parametrize("shape,intra_all", [((64, 80), False),
                                             ((48, 64), True)])
def test_order_one_mb_too_early_differs(shape, intra_all):
    """Starting MB (x, y) when row y-1 has finished MB x but not MB x+1
    changes the result on dense content: the wait rule is tight."""
    h, w = shape
    y, u, v, qp_mb, intra, nz, mv = _dense_frame(47, h, w, intra_all)
    grids = td.threshold_grids(*_bs(intra, nz, mv), _t(qp_mb))
    ref = td.deblock_general_plain(_t(y), _t(u), _t(v), *grids,
                                   strong=intra_all)
    early = _diagonal(h // 16, w // 16, lag=1)
    assert sorted(early) == sorted(_raster(h // 16, w // 16))
    out = _run_order((y, u, v), grids, early, intra_all)
    assert not torch.equal(out[0], ref[0])


@pytest.mark.parametrize("qp", [26, 38])
@pytest.mark.parametrize("shape", [(64, 80), (16, 96), (80, 16)])
def test_uniform_qp_steps_match_fast_plain(shape, qp):
    """The uniform-QP form: per-MB steps over ``fast_grids`` equal
    ``deblock_fast_plain``."""
    h, w = shape
    y, u, v, _, intra, nz, mv = _dense_frame(53 + qp, h, w, False)
    bs_v, bs_h = _bs(intra, nz, mv)
    scal = td.deblock_scalars(qp)
    ref = td.deblock_fast_plain(_t(y), _t(u), _t(v), bs_v, bs_h, scal)
    assert not torch.equal(ref[0], _t(y))
    out = _run_order((y, u, v), td.fast_grids(bs_v, bs_h, scal),
                     _random_legal(h // 16, w // 16, qp), False)
    _eq(out, ref)
