"""The partitioned P step of vcp_tpu_torch (``-p h264-cpu``'s P anchors:
every partition granularity searched at once, the half-pel partition
decision, the intra overlay) and its CABAC slice writers against vcp_tpu
on the CPU: decisions, levels, recon and NAL units exact, float RD costs
to 1e-5.

vcp_tpu reads VCP_HIER_ME, VCP_INTRA_GATE and VCP_GATE_MARGIN while it
traces and caches the trace by frame size and static arguments, so each
case that sets one of them uses a frame width that no other case of
these tests encodes."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_encoder_quality import moving_frames
from vcp_tpu.codec.h264 import headers as jh
from vcp_tpu.codec.h264 import intra_rd as j_ird
from vcp_tpu.codec.h264 import pframe as jp
from vcp_tpu.codec.h264.frame_ops import pad_plane
from vcp_tpu.ops import motion as jm
from vcp_tpu_torch.codec.h264 import entropy as t_entropy
from vcp_tpu_torch.codec.h264 import gop_ops as t_gop
from vcp_tpu_torch.codec.h264 import headers as th
from vcp_tpu_torch.codec.h264 import intra_rd as t_ird
from vcp_tpu_torch.codec.h264 import pframe as tp
from vcp_tpu_torch.codec.h264 import rdcost
from vcp_tpu_torch.ops import motion as tm

H = 64
QP = 25


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _padded(w, idx):
    fr = moving_frames(max(idx) + 1, w=w)
    return [tuple(pad_plane(p, 16 if k == 0 else 8)
                  for k, p in enumerate(fr[i])) for i in idx]


def _pair(seed, h, w, shift=(2, -3)):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, (h, w)).astype(np.int32)
    ref = np.clip(np.roll(cur, shift, (0, 1)) + rng.integers(-3, 4, (h, w)),
                  0, 255).astype(np.int32)
    return cur, ref


def _assert_dicts_equal(j, t):
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_array_equal(
            t[k].numpy().astype(np.int64), np.asarray(j[k]).astype(np.int64),
            err_msg=k)


@pytest.mark.parametrize("sr,lam", [(4, 5), (12, 0), (12, 7), (24, 5)])
def test_full_search_parts(sr, lam):
    cur, ref = _pair(sr + lam, 48, 80)
    for a, b in zip(jm.full_search_parts(cur, ref, sr, lam),
                    tm.full_search_parts(_t(cur), _t(ref), sr, lam)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("sr,lam", [(12, 5), (16, 0), (24, 5)])
def test_hier_search_parts(sr, lam):
    """Every granularity's winner of the pyramid search, with its
    zero-vector fallback; the 16x16 form equals ``hier_search``."""
    cur, ref = _pair(40 + sr, 64, 96, shift=(5, -7))
    parts = tm.hier_search_parts(_t(cur), _t(ref), sr, lam)
    for a, b in zip(jm.hier_search_parts(cur, ref, sr, lam), parts):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        tm.hier_search(_t(cur), _t(ref), sr, lam).numpy(), parts[0].numpy())


@pytest.mark.parametrize("gran", [16, 8, "h", "v"])
def test_zero_sad(gran):
    cur, ref = _pair(7, 32, 48)
    np.testing.assert_array_equal(
        tm._zero_sad(_t(cur), _t(ref), gran).numpy(),
        np.asarray(jm._zero_sad(cur, ref, gran)))


def test_mc_luma_uniform():
    cur, ref = _pair(3, 48, 64)
    sr = 12
    pad, margin = sr + 6, sr + 3
    pj = jnp.stack(jm.half_planes(jnp.pad(ref, pad, mode="edge")))
    pt = torch.stack(tm.half_planes(tm.pad_edge(_t(ref), pad, pad, pad,
                                                pad)))
    for g in ([0, 0], [-6, 10], [8, -2], [-50, 46], [52, -52]):
        np.testing.assert_array_equal(
            tm.mc_luma_uniform(pt, torch.tensor(g, dtype=torch.int32),
                               margin, 0, 48, 64).numpy(),
            np.asarray(jm.mc_luma_uniform(pj, jnp.asarray(g, jnp.int32),
                                          margin, 0, 48, 64)))


def test_rate_proxies_match_xla():
    """The host tables of the MV-rate proxies against XLA's float32
    log2 formulas."""
    a = np.arange(-300, 301, dtype=np.int32)
    af = jnp.abs(jnp.asarray(a)).astype(jnp.float32)
    se_j = jnp.where(af == 0, 1.0, 2.0 * jnp.log2(2.0 * af + 1.0) + 1.0)
    np.testing.assert_allclose(rdcost.se_bits(_t(a)).numpy(),
                               np.asarray(se_j), rtol=1e-5)
    mv = np.stack([a, a[::-1]], axis=-1)
    m = jnp.abs(jnp.asarray(mv)).astype(jnp.float32)
    mv_j = (2.0 * jnp.log2(m[..., 0] + 1.0) + 2.0 * jnp.log2(m[..., 1] + 1.0)
            + 2.0)
    np.testing.assert_allclose(rdcost.mv_bits(_t(mv)).numpy(),
                               np.asarray(mv_j), rtol=1e-5)


def test_luma_trial_costs():
    """The partition trial's SSD and bit proxy against the XLA formula."""
    from vcp_tpu.ops import transform as jtf
    cur, pred = _pair(11, 48, 64, shift=(1, 1))
    n_mby, n_mbx = 3, 4
    zt = jtf.quant4(jtf.fdct4(jtf.to_blocks4(cur - pred)), QP, intra=False)
    rec = jnp.clip(pred + jtf.from_blocks4(jtf.idct4(jtf.dequant4(zt, QP))),
                   0, 255)
    d = (cur - rec).astype(jnp.float32)
    ssd_j = (d * d).reshape(n_mby, 16, n_mbx, 16).sum(axis=(1, 3))
    a = jnp.abs(zt.astype(jnp.float32))
    lb = jnp.where(a > 0, 2.0 * jnp.log2(a + 1.0) + 1.7, 0.0)
    nz = jnp.any(a.reshape(n_mby, 4, n_mbx, 4, 16) > 0, axis=-1)
    bits_j = lb.reshape(n_mby, 4, n_mbx, 4, 16).sum(axis=(1, 3, 4)) \
        + 3.0 * nz.astype(jnp.float32).sum(axis=(1, 3))
    ssd, bits, nzb = t_gop.luma_trial(_t(cur), _t(pred), QP)
    np.testing.assert_array_equal(ssd.numpy(), np.asarray(ssd_j))
    np.testing.assert_allclose((bits + 3.0 * nzb).numpy(),
                               np.asarray(bits_j), rtol=1e-5)


# (width, sr, env, deblock, intra_mbs): each row with an env var has its
# own width
CASES = {
    "hier": (96, 24, {}, True, True),
    "hier-no-overlay": (96, 24, {}, True, False),
    "hier-no-deblock": (96, 12, {}, False, True),
    "exhaustive": (144, 24, {"VCP_HIER_ME": "0"}, True, True),
    "gate-forced": (176, 12, {"VCP_INTRA_GATE": "0"}, True, True),
    "gate-margin": (208, 24, {"VCP_GATE_MARGIN": "0"}, True, True),
}


@pytest.fixture(scope="module")
def pframes():
    """Each case's JAX and torch P step on the same anchor pair (frame 0
    -> frame 3 of the moving content), computed once per module."""
    out = {}
    for name, (w, sr, env, deblock, intra) in CASES.items():
        cur, ref = _padded(w, (3, 0))
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            j = jp._encode_pframe_device_parts(
                *cur, *ref, QP, QP, sr, jp.lam_for_qp(QP), deblock, 1, True,
                intra)
            t = tp.encode_pframe(*map(_t, cur + ref), QP, QP, sr, deblock,
                                 1, True, True, intra)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        out[name] = ({k: np.asarray(v) for k, v in j.items()}, t, w)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_encode_pframe_parts(pframes, name):
    j, t, _ = pframes[name]
    _assert_dicts_equal(j, t)


def test_pframe_cases_use_their_tools(pframes):
    """The content makes the tools fire: partitioned MBs, and intra MBs
    where the overlay runs."""
    for name in ("hier", "exhaustive", "gate-forced", "gate-margin"):
        j, _, _ = pframes[name]
        assert j["parts"].any(), name
        assert j["intra"].any(), name
    assert "intra" not in pframes["hier-no-overlay"][0]


def _sps_pps(mod, w):
    sp = mod.SeqParams(width=w, height=H, profile_idc=100, poc_type=0,
                       num_ref_frames=2)
    return sp, mod.PicParams(init_qp=26, cabac=True, transform_8x8=True)


@pytest.mark.parametrize("name", ["hier", "hier-no-overlay", "exhaustive",
                                  "gate-forced"])
def test_pslice_writers_on_vcp_tpu_output(pframes, name):
    """The intra and partition writers (and the 16x16 one, when no MB is
    partitioned) on vcp_tpu's own output dicts give vcp_tpu's NAL
    units."""
    j, _, w = pframes[name]
    data = {k: v for k, v in j.items() if not k.startswith("recon")}
    data["mv"] = data["mv8"][::2, ::2]
    nal_j = jp.write_pslice(*_sps_pps(jh, w), frame_num=1, qp=QP,
                            data=dict(data), deblock=True, cabac=True,
                            poc_lsb=6)
    nal_t = t_entropy.write_pslice(*_sps_pps(th, w), frame_num=1, qp=QP,
                                   data=dict(data), deblock=True, poc_lsb=6)
    assert nal_t == nal_j


def test_pslice_parts_writer_every_shape():
    """A P slice with every partition type and some skipped MBs, through
    the partition writer."""
    rng = np.random.default_rng(5)
    n_mby, n_mbx = 4, 6
    mv8 = rng.integers(-20, 21, (2 * n_mby, 2 * n_mbx, 2)).astype(np.int32)
    quads = mv8.reshape(n_mby, 2, n_mbx, 2, 2)
    quads[0, :, :, :] = quads[0, :1, :, :1]            # row 0: 16x16
    quads[1, :, :, 1] = quads[1, :, :, 0]              # row 1: 16x8
    quads[2, 1] = quads[2, 0]                          # row 2: 8x16
    mv8 = quads.reshape(2 * n_mby, 2 * n_mbx, 2)
    luma = np.where(rng.random((n_mby, n_mbx, 16, 16)) < 0.1,
                    rng.integers(-3, 4, (n_mby, n_mbx, 16, 16)), 0)
    data = {"mv8": mv8, "mv": mv8[::2, ::2], "parts": np.ones((n_mby, n_mbx)),
            "t8": rng.random((n_mby, n_mbx)) < 0.3,
            "luma": luma.astype(np.int32),
            "cb_dc": np.zeros((n_mby, n_mbx, 4), np.int32),
            "cr_dc": rng.integers(-1, 2, (n_mby, n_mbx, 4)).astype(np.int32),
            "cb_ac": np.zeros((n_mby, n_mbx, 4, 16), np.int32),
            "cr_ac": np.zeros((n_mby, n_mbx, 4, 16), np.int32)}
    data["luma"][data["t8"]] = 0
    _, ptype = t_entropy.mv8_grid_xy(data, n_mby, n_mbx)
    assert set(ptype.ravel()) == {0, 1, 2, 3}
    nal_j = jp.write_pslice(*_sps_pps(jh, 96), frame_num=2, qp=QP,
                            data=dict(data), deblock=False, cabac=True,
                            poc_lsb=4)
    nal_t = t_entropy.write_pslice(*_sps_pps(th, 96), frame_num=2, qp=QP,
                                   data=dict(data), deblock=False,
                                   poc_lsb=4)
    assert nal_t == nal_j


def test_intra_overlay_pass():
    """The overlay wavefront on planes that start as another frame's
    recon, with inter costs that let some MBs go intra (both I16 and
    i8) and keep others inter."""
    w = 96
    (cy, cu, cv), (ry, ru, rv) = _padded(w, (3, 1))
    rng = np.random.default_rng(2)
    inter_cost = rng.uniform(0, 1e4, (H // 16, w // 16)).astype(np.float32)
    j = j_ird.intra_overlay_pass(*(jnp.asarray(a, jnp.int32) for a in
                                   (cy, cu, cv, ry, ru, rv)),
                                 jnp.asarray(inter_cost), QP, QP)
    t = t_ird.intra_overlay_pass(*(_t(a).to(torch.int32) for a in
                                   (cy, cu, cv, ry, ru, rv)),
                                 _t(inter_cost), QP, QP)
    _assert_dicts_equal(j, t)
    intra, i8 = np.asarray(j["intra"]), np.asarray(j["i8"])
    assert intra.any() and not intra.all()
    assert (intra & i8).any() and (intra & ~i8).any()
