"""The HEVC intra frames of vcp_tpu_torch (the row-pattern
``frame_ops.encode_iframe`` and the RD wavefront
``intra_rd.encode_iframe_rd``), their predictors and cost pieces, against
vcp_tpu on the CPU: levels, modes and recon exactly, costs to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcp_tpu.codec.h265 import foreign as jforeign
from vcp_tpu.codec.h265 import frame_ops as jfo
from vcp_tpu.codec.h265 import intra_rd as jrd
from vcp_tpu.ops import transform_hevc as jth
from vcp_tpu_torch.codec.h264 import rdcost
from vcp_tpu_torch.codec.h265 import frame_ops as tfo
from vcp_tpu_torch.codec.h265 import intra_rd as trd

from video_util import synth_video

H, W = 96, 128          # 3 x 4 CTUs: every availability case of a CTU


def _t(a):
    return torch.from_numpy(np.array(a, np.int32))


def _content(kind: str):
    """Padded int32 (y, u, v) of one frame."""
    rng = np.random.default_rng(len(kind))
    if kind == "synth":
        y, u, v = synth_video(W, H, 1)[0]
    elif kind == "saturated":     # 0 / 255 blocks and stripes
        y = np.where(rng.random((H, W)) < 0.5, 255, 0)
        y[:, ::7] = 255 - y[:, ::7]
        u = np.where(rng.random((H // 2, W // 2)) < 0.5, 255, 0)
        v = 255 - u
    else:                         # uniform noise
        y = rng.integers(0, 256, (H, W))
        u = rng.integers(0, 256, (H // 2, W // 2))
        v = rng.integers(0, 256, (H // 2, W // 2))
    return tuple(np.asarray(p, np.int32) for p in (y, u, v))


CASES = [("synth", 22), ("synth", 37), ("saturated", 0), ("saturated", 51),
         ("noise", 51)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def intra_case(request):
    """vcp_tpu's two intra frames of one (content, QP) case."""
    kind, qp = request.param
    planes = _content(kind)
    qpc = jth.chroma_qp(qp)
    jp = [jnp.asarray(p) for p in planes]
    row = {k: np.asarray(a) for k, a in
           jfo.encode_iframe(*jp, qp, qpc).items()}
    rd = {k: np.asarray(a) for k, a in
          jrd.encode_iframe_rd(*jp, qp, qpc).items()}
    return planes, qp, qpc, row, rd


def _check(out, ref):
    assert set(out) == set(ref)
    for k, a in ref.items():
        np.testing.assert_array_equal(out[k].numpy(), a, err_msg=k)


def test_row_pattern_iframe(intra_case):
    planes, qp, qpc, row, _ = intra_case
    _check(tfo.encode_iframe(*(_t(p) for p in planes), qp, qpc), row)


def test_rd_iframe(intra_case):
    planes, qp, qpc, _, rd = intra_case
    out = trd.encode_iframe_rd(*(_t(p) for p in planes), qp, qpc)
    _check(out, rd)


def test_rd_iframe_chooses_left_dependent_modes():
    """On rows of constant value (a vertical gradient) the RD frame picks
    planar or a mode below 26: the wavefront reaches the modes the row
    pattern cannot."""
    yy = np.mgrid[0:H, 0:W][0]
    y = (40 + 2 * yy + 30 * np.sin(yy / 5.0)).astype(np.int32)
    u = np.full((H // 2, W // 2), 128, np.int32)
    out = trd.encode_iframe_rd(_t(y), _t(u), _t(u), 30, jth.chroma_qp(30))
    m = out["modes"].numpy()
    assert ((m == 0) | ((m >= 2) & (m < 26))).sum() >= m.size // 2, m


def test_lam2_every_qp():
    """HEVC's lambda2 is 0.9 * 2^((qp-12)/3) in float64 rounded once to
    float32, at every QP and with a multiplier; it is not H.264's float32
    pow (the two differ at 26 of the 52 QPs)."""
    differ = 0
    for qp in range(52):
        want = np.float32(0.9 * 2.0 ** ((qp - 12) / 3.0))
        assert np.float32(tfo.lam2_hevc(qp)) == want
        assert tfo.lam2_hevc(qp) == float(want)
        assert tfo.lam2_hevc(qp, 1.7) == float(
            np.float32(0.9 * 2.0 ** ((qp - 12) / 3.0) * 1.7))
        differ += tfo.lam2_hevc(qp) != rdcost.lam2_for_qp(qp)
    assert differ == 26


def test_level_bits_cover_the_hevc_range():
    """The bit proxy over levels up to the HEVC clip 32767, against
    vcp_tpu's float32 log2 sum (to 1e-5), and exact in float64 whatever
    the order of a 32x32 block's terms."""
    rng = np.random.default_rng(4)
    z = rng.integers(-32767, 32768, (7, 32, 32)).astype(np.int32)
    z[0] = 0
    z[1, :4] = 32767
    z[2] = rng.integers(-3, 4, (32, 32))
    got = tfo.hevc_level_bits(_t(z), (1, 2)).numpy()
    ref = np.asarray(jrd._bits_proxy(jnp.asarray(z)[:, None]))[:, 0]
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    flip = _t(z).flip(1).flip(2)
    np.testing.assert_array_equal(
        tfo.hevc_level_bits(flip, (1, 2)).numpy(), got)


def test_ssd_of_a_32x32_block_is_an_integer_sum():
    """The HEVC costs' SSD (``rdcost.ssd``) over 32x32 blocks, also past
    2^24 (1024 * 255^2), is the exact integer sum rounded once."""
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (3, 32, 32)).astype(np.int32)
    b = rng.integers(0, 256, (3, 32, 32)).astype(np.int32)
    a[0], b[0] = 255, 0
    got = rdcost.ssd(_t(a), _t(b), (1, 2)).numpy()
    want = ((a - b).astype(np.int64) ** 2).sum((1, 2)).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_top_mode_predictions():
    rng = np.random.default_rng(8)
    for w in (32, 96, 160):
        bot = rng.integers(0, 256, w).astype(np.int32)
        nbx = w // 32
        got = tfo._top_mode_preds(_t(bot), nbx).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jfo._top_mode_preds(jnp.asarray(bot), nbx)[0]))
        np.testing.assert_array_equal(got, tfo.top_mode_preds_np(bot, nbx))


@pytest.mark.parametrize("mode", range(35))
def test_prediction_of_every_mode(mode):
    """pred_mode of all 35 modes from references with every availability
    pattern equals vcp_tpu's and the foreign decoder's intra_pred."""
    rng = np.random.default_rng(mode)
    L = 8
    left32 = rng.integers(0, 256, (L, 32)).astype(np.int32)
    top64 = rng.integers(0, 256, (L, 64)).astype(np.int32)
    corner = rng.integers(0, 256, L).astype(np.int32)
    av = np.array([[a & 1, a >> 1 & 1, a >> 2 & 1] for a in range(L)], bool)
    avl, avt, avtr = av[:, 0], av[:, 1], av[:, 1] & av[:, 2]
    jrefs = jrd.build_refs(*(jnp.asarray(a) for a in (left32, top64, corner,
                                                      avl, avt, avtr)))
    trefs = trd.build_refs(*(torch.from_numpy(a) for a in (
        left32, top64, corner, avl, avt, avtr)))
    for a, b in zip(trefs, jrefs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jfilt = jrd.filter_refs(*jrefs)
    tfilt = trd.filter_refs(*trefs)
    for a, b in zip(tfilt, jfilt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = trd.pred_mode(trefs, tfilt, mode).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jrd.pred_mode(jrefs, jfilt, mode)))
    refs = trefs if mode in (1, 10, 26) else tfilt
    for k in range(L):
        lft, c, top = (r[k].numpy() if r.dim() > 1 else int(r[k])
                       for r in refs)
        want = jforeign.intra_pred(lft, c, top, 32, mode, luma=True)
        np.testing.assert_array_equal(got[k], want)
