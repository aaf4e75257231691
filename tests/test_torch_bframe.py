"""The B step of vcp_tpu_torch (two-list search, frame-dominant vector,
RD mode decision, forced skips, two-list deblock bS) and its CABAC
B-slice writer against vcp_tpu on the CPU: decisions, levels, recon and
NAL units exact, float RD costs to 1e-5.

vcp_tpu reads VCP_HIER_ME while it traces, so the case that sets it uses
a frame width that no other test encodes."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_encoder_quality import moving_frames
from vcp_tpu.codec.h264 import bframe as jb
from vcp_tpu.codec.h264 import gop_ops as jg
from vcp_tpu.codec.h264 import headers as jh
from vcp_tpu.codec.h264 import pframe as jp
from vcp_tpu.codec.h264.frame_ops import pad_plane
from vcp_tpu.ops import deblock as jd
from vcp_tpu.ops import transform as jtf
from vcp_tpu_torch.codec.h264 import bframe as tb
from vcp_tpu_torch.codec.h264 import gop_ops as tg
from vcp_tpu_torch.codec.h264 import headers as th
from vcp_tpu_torch.codec.h264 import rdcost
from vcp_tpu_torch.ops import deblock as td

H = 64
QP_B = 29


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _planes(w):
    """A B picture (display 1) between its anchors (display 0 and 3)."""
    fr = moving_frames(4, w=w)
    pad = [tuple(pad_plane(p, 16 if k == 0 else 8) for k, p in enumerate(f))
           for f in fr]
    return pad[1], pad[0], pad[3]


@pytest.mark.parametrize("n,sign", [(24, 1), (40, 1), (8160, 1), (24, -1),
                                    (8160, -1), (7, 1)])
def test_dominant_mv_lower_median(n, sign):
    """The lower median sorted[(n-1)//2] per component, as
    jnp.quantile(method="nearest") takes it at the 96x64 (n = 24) and
    1080p (n = 8160) MB counts, then floored to the snap grid (also for
    negative medians); torch.quantile's "nearest" rounds half to even
    and would take the upper one."""
    rng = np.random.default_rng(n)
    mv = (sign * rng.integers(-3, 40, (n, 1, 2))).astype(np.int32)
    # distinct x components, so the two middle values differ
    mv[:, 0, 0] = sign * (rng.permutation(n) - 3)
    for snap in (1, 2, 4):
        g = jnp.quantile(jnp.asarray(mv.reshape(-1, 2), jnp.float32), 0.5,
                         axis=0, method="nearest").astype(jnp.int32)
        want = (np.asarray(g) // snap) * snap
        got = tg.dominant_mv(_t(mv), snap).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.sort(mv.reshape(-1, 2), axis=0)[(n - 1) // 2] // snap
            * snap)
    if n % 2 == 0:
        q = torch.quantile(_t(mv.reshape(-1, 2)).float(), 0.5, dim=0,
                           interpolation="nearest")
        assert q[0] != np.asarray(g)[0]


# (width, subpel, sr, env, deblock)
CASES = {
    "half-pel-pyramid": (96, 1, 12, {}, True),
    "half-pel-no-deblock": (96, 1, 12, {}, False),
    "half-pel-sr8": (96, 1, 8, {}, True),
    "full-pel": (96, 0, 8, {}, True),
    "half-pel-exhaustive": (160, 1, 12, {"VCP_HIER_ME": "0"}, True),
}


@pytest.fixture(scope="module")
def bframes():
    out = {}
    for name, (w, subpel, sr, env, deblock) in CASES.items():
        cur, r0, r1 = _planes(w)
        lam = jp.lam_for_qp(QP_B)
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            j = jg.encode_bframe(*cur, *r0, *r1, QP_B, QP_B, sr, lam, subpel,
                                 deblock)
            t = tg.encode_bframe(*map(_t, cur + r0 + r1), QP_B, QP_B, sr,
                                 lam, subpel, deblock)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        out[name] = ({k: np.asarray(v) for k, v in j.items()}, t, w)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_encode_bframe(bframes, name):
    j, t, _ = bframes[name]
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy().astype(np.int64),
                                      j[k].astype(np.int64), err_msg=k)


def test_bframe_cases_use_every_mode(bframes):
    """Across the cases every mode occurs, and some MBs carry no
    residual (B_Skip / B_Direct material)."""
    modes = np.concatenate([j["mode"].ravel() for j, _, _ in
                            bframes.values()])
    assert set(modes) == {0, 1, 2}
    assert any((j["luma"] == 0).all(axis=(-1, -2)).any()
               for j, _, _ in bframes.values())


def test_mode_costs_match_xla():
    """The per-MB candidate costs of the mode decision (SSD + lambda2 *
    (level bits + MV bits)) against the XLA formulas, to 1e-5."""
    cur, r0, _ = _planes(96)
    y, p0 = cur[0].astype(np.int32), r0[0].astype(np.int32)
    n_mby, n_mbx = H // 16, 96 // 16
    rng = np.random.default_rng(1)
    mv = rng.integers(-50, 51, (n_mby, n_mbx, 2)).astype(np.int32)
    lam2_j = 0.9 * jnp.power(2.0, (jnp.int32(QP_B) - 12) / 3.0)
    zc = jtf.quant4(jtf.fdct4(jtf.to_blocks4(y - p0)), QP_B, intra=False)
    rec = jnp.clip(p0 + jtf.from_blocks4(jtf.idct4(jtf.dequant4(zc, QP_B))),
                   0, 255)
    d = (y - rec).astype(jnp.float32)
    dist = (d * d).reshape(n_mby, 16, n_mbx, 16).sum(axis=(1, 3))
    a = jnp.abs(zc.astype(jnp.float32))
    lb = jnp.where(a > 0, 2.0 * jnp.log2(a + 1.0) + 1.7, 0.0)
    bits = lb.reshape(n_mby, 4, n_mbx, 4, 16).sum(axis=(1, 3, 4))
    am = jnp.abs(jnp.asarray(mv)).astype(jnp.float32)
    mvb = 2.0 * jnp.log2(am[..., 0] + 1.0) + 2.0 * jnp.log2(am[..., 1] + 1.0) \
        + 2.0
    c_j = dist + lam2_j * bits + lam2_j * (mvb + 3.0)

    lam2 = rdcost.lam2_for_qp(QP_B)
    assert abs(lam2 - float(lam2_j)) <= 1e-5 * lam2
    ssd, lbits, _ = tg.luma_trial(_t(y), _t(p0), QP_B)
    c_t = ssd + lam2 * lbits + lam2 * (rdcost.mv_bits(_t(mv)) + 3.0)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("vertical", [True, False])
def test_bs_two_list(seed, vertical):
    """bS of B pictures: list-usage changes, per-list vector steps of one
    sample, residual and intra edges."""
    rng = np.random.default_rng(seed)
    nby, nbx = 3, 5
    mode = rng.integers(0, 3, (nby, nbx))
    use = np.stack([mode != 1, mode != 0], axis=-1)
    mv0 = rng.integers(-6, 7, (nby, nbx, 2)).astype(np.int32)
    mv1 = rng.integers(-6, 7, (nby, nbx, 2)).astype(np.int32)
    nz = rng.random((4 * nby, 4 * nbx)) < 0.2
    intra = rng.random((nby, nbx)) < 0.1
    j = jd.compute_bs_luma(jnp.asarray(intra), jnp.asarray(nz),
                           (jnp.asarray(mv0), jnp.asarray(mv1),
                            jnp.asarray(use)), vertical)
    t = td.compute_bs_luma(_t(intra), _t(nz), (_t(mv0), _t(mv1), _t(use)),
                           vertical)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (np.asarray(j) == 1).any()


def _sps_pps(mod, w, t8):
    sp = mod.SeqParams(width=w, height=H, profile_idc=100 if t8 else 77,
                       poc_type=0, num_ref_frames=2)
    return sp, mod.PicParams(init_qp=26, cabac=True, transform_8x8=t8)


@pytest.mark.parametrize("name,t8,colocated", [
    ("half-pel-pyramid", True, "zero-safe"),
    ("half-pel-pyramid", True, "none"),
    ("full-pel", False, "zero"),
    ("half-pel-exhaustive", True, "zero-safe"),
])
def test_write_bslice_on_vcp_tpu_output(bframes, name, t8, colocated):
    """The B-slice writer on vcp_tpu's own B output, with the colocated
    anchor's colZero / col_safe grids (none: the writer's defaults)."""
    j, _, w = bframes[name]
    data = {k: v for k, v in j.items() if not k.startswith("recon")}
    rng = np.random.default_rng(len(name))
    if colocated != "none":
        data["col_zero"] = rng.random(j["mode"].shape) < 0.5
    if colocated == "zero-safe":
        data["col_safe"] = data["col_zero"] | (rng.random(j["mode"].shape)
                                               < 0.5)
    nal_j = jb.write_bslice(*_sps_pps(jh, w, t8), frame_num=2, qp=QP_B,
                            data=dict(data), deblock=True, cabac=True,
                            poc_lsb=2)
    nal_t = tb.write_bslice(*_sps_pps(th, w, t8), frame_num=2, qp=QP_B,
                            data=dict(data), deblock=True, poc_lsb=2)
    assert nal_t == nal_j
