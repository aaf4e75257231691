"""Sparse IDR and P-chunk device outputs of vcp_tpu_torch against
vcp_tpu's on the CPU (rows [:count] of the compacted buffers, recon
planes), plus the table and state carry-over. Exact equality."""

import os

import numpy as np
import pytest
import torch

from vcp_tpu.codec.h264 import cabac_tables as j_cabac
from vcp_tpu.codec.h264 import decoder as j_decoder
from vcp_tpu.codec.h264 import frame_ops as j_frame
from vcp_tpu.codec.h264 import gop_ops as jg
from vcp_tpu.codec.h264 import tables as j_tables
from vcp_tpu.ops import deblock as j_deblock
from vcp_tpu.ops import transform as jtf
from vcp_tpu.ops import transform8 as jt8
from vcp_tpu_torch import state
from vcp_tpu_torch.codec.h264 import gop_ops as tg

from test_torch_encoder_quality import moving_frames

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "gradmotion_320x192.npz")


def _golden_frames(n):
    z = np.load(GOLDEN)
    return [(z[f"f{i}_y"], z[f"f{i}_u"], z[f"f{i}_v"]) for i in range(n)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def reference_tables():
    """vcp_tpu's copies of every table the port keeps."""
    return {
        "MF_TABLE": jtf.MF_TABLE, "V_TABLE": jtf.V_TABLE,
        "CHROMA_QP_FULL": jtf.CHROMA_QP_FULL,
        "ALPHA": j_deblock.ALPHA, "BETA": j_deblock.BETA,
        "TC0": j_deblock.TC0,
        "ZIGZAG_4x4": np.asarray(j_tables.ZIGZAG_4x4),
        "LUMA_BLK_ORDER": j_frame.LUMA_BLK_ORDER,
        "DECIMATE_TAB": jg._DECIMATE_TAB,
        "CTX_INIT_I": np.asarray(j_cabac.CTX_INIT_I),
        "CTX_INIT_PB": np.asarray(j_cabac.CTX_INIT_PB),
        "MF8_TABLE": jt8.MF8_TABLE, "V8_TABLE": jt8.V8_TABLE,
        "ZIGZAG_8x8": jt8.ZIGZAG_8x8,
        "I8_TABS": np.stack([np.stack(j_decoder._I8_TABS[m])
                             for m in range(3, 9)]),
        **_hevc_reference_tables(),
    }


def _hevc_reference_tables():
    """vcp_tpu's copies of the HEVC tables the port keeps (dicts and
    functions flattened as ``state.hevc_tables`` does)."""
    from vcp_tpu.codec import cabac
    from vcp_tpu.codec.h265 import ctx, frame_ops, intra_rd
    from vcp_tpu.codec.h265.foreign import ANGLE, INV_ANGLE
    from vcp_tpu.ops import deblock_hevc
    from vcp_tpu.ops import transform_hevc as jth
    out = {f"trans_matrix({n})": jth.trans_matrix(n) for n in (4, 8, 16, 32)}
    out.update({f"coeff_scan({k})": np.asarray(ctx.coeff_scan(k))
                for k in (2, 3, 4, 5)})
    out.update({
        "QUANT_SCALE": jth.QUANT_SCALE, "LEVEL_SCALE": jth.LEVEL_SCALE,
        "_CHROMA_QP_MAP": jth._CHROMA_QP_MAP,
        "BETA_TABLE": deblock_hevc.BETA_TABLE,
        "TC_TABLE": deblock_hevc.TC_TABLE,
        "RANGE_TAB_LPS": np.asarray(cabac.RANGE_TAB_LPS),
        "TRANS_IDX_LPS": np.asarray(cabac.TRANS_IDX_LPS),
        "CTX_SETS": np.asarray(list(ctx.CTX_SETS.values())),
        "INIT_VALUES": np.concatenate(
            [np.asarray(ctx.INIT_VALUES[k]) for k in ctx.CTX_SETS], axis=1),
        "ANGLE": np.asarray([ANGLE.get(m, 0) for m in range(35)]),
        "INV_ANGLE": np.asarray(sorted(INV_ANGLE.items())),
        "MODESET": np.asarray(intra_rd.MODESET),
        "ANG_MODES": np.asarray(frame_ops.ANG_MODES),
        "ANG_ANGLE": np.asarray(frame_ops.ANG_ANGLE),
    })
    return out


@pytest.fixture(scope="module")
def frames():
    return _golden_frames(4)


@pytest.mark.parametrize("deblock", [True, False])
def test_iframe_sparse(frames, deblock):
    y, u, v = frames[0]
    qp, qpc = 24, jtf.chroma_qp(24)
    j = jg.encode_iframe_sparse(y, u, v, qp, qpc, deblock)
    t = tg.encode_iframe_sparse(_t(y), _t(u), _t(v), qp, qpc, deblock)
    cnt = int(np.asarray(j[1])[0])
    assert int(t[1][0]) == cnt
    _eq(t[0], j[0])
    _eq(t[2][:cnt], np.asarray(j[2])[:cnt])
    for a, b in zip(t[3:], j[3:]):
        _eq(a, b)
    n_mbx = y.shape[1] // 16
    dj = jg.unpack_sparse_iframe(np.asarray(j[0]), np.asarray(j[2]), cnt,
                                 n_mbx)
    dt = tg.unpack_sparse_iframe(t[0].numpy(), t[2][:cnt].numpy(), cnt,
                                 n_mbx)
    for k in dj:
        np.testing.assert_array_equal(dt[k], dj[k])


@pytest.mark.parametrize("deblock", [True, False])
def test_pchunk_sparse_from_reference_state(frames, deblock):
    """Seed the port mid-GOP from the JAX encoder's recon (state carry
    over) and compare one 3-frame P chunk."""
    qp, qpc = 26, jtf.chroma_qp(26)
    h, w = frames[0][0].shape
    j_i = jg.encode_iframe_sparse(*frames[0], qp - 3, jtf.chroma_qp(qp - 3),
                                  deblock)
    recon = tuple(np.asarray(p) for p in j_i[3:])
    st = state.from_reference(reference_tables(), recon, qp, device="cpu")
    assert st.qpc == qpc
    buf = jg.pack_frames(frames[1:4])
    np.testing.assert_array_equal(tg.pack_frames(frames[1:4]), buf)
    jo = jg.encode_pchunk_sparse(buf, *recon, qp, qpc, 8, 5, h, w, deblock,
                                 0, False)
    to = tg.encode_pchunk_sparse(_t(buf), *st.recon, qp, qpc, 8, 5, h, w,
                                 deblock, 0, False)
    _assert_chunks_equal(to, jo, h, w)


def _assert_chunks_equal(to, jo, h, w):
    """Sparse chunk tuples (bitmap, counts, meta, payload, recon planes)
    of the port and of vcp_tpu, and their host unpacking; returns the
    port's per-frame dicts."""
    mcount, bcount = (int(c) for c in np.asarray(jo[1]))
    _eq(to[0], jo[0])
    _eq(to[1], jo[1])
    _eq(to[2][:mcount], np.asarray(jo[2])[:mcount])
    _eq(to[3][:bcount], np.asarray(jo[3])[:bcount])
    for a, b in zip(to[4:], jo[4:]):
        _eq(a, b)
    dj = jg.unpack_sparse_chunk(np.asarray(jo[0]), np.asarray(jo[2]),
                                np.asarray(jo[3]), mcount, bcount,
                                h // 16, w // 16)
    dt = tg.unpack_sparse_chunk(to[0].numpy(), to[2][:mcount].numpy(),
                                to[3][:bcount].numpy(), mcount, bcount,
                                h // 16, w // 16)
    for a, b in zip(dt, dj):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    return dt


@pytest.mark.parametrize("qp,deblock,subpel,t8", [
    (24, True, 1, True), (32, True, 1, True), (28, False, 1, True),
    (26, True, 1, False), (26, True, 0, True)])
def test_pchunk_sparse_subpel_t8(qp, deblock, subpel, t8):
    """The half-pel / adaptive-8x8 P chunk (and each option alone): packed
    rows with their t8 flag words, unpacked dicts and recon planes."""
    fr = moving_frames(4, seed=qp)
    h, w = fr[0][0].shape
    qpc = jtf.chroma_qp(qp)
    j_i = jg.encode_iframe_sparse(*fr[0], qp - 3, jtf.chroma_qp(qp - 3),
                                  deblock)
    recon = tuple(np.asarray(p) for p in j_i[3:])
    buf = jg.pack_frames(fr[1:4])
    lam = 5
    jo = jg.encode_pchunk_sparse(buf, *recon, qp, qpc, 8, lam, h, w,
                                 deblock, subpel, t8)
    to = tg.encode_pchunk_sparse(_t(buf), *map(_t, recon), qp, qpc, 8, lam,
                                 h, w, deblock, subpel, t8)
    dicts = _assert_chunks_equal(to, jo, h, w)
    if subpel:
        assert any(((d["mv"] & 3) == 2).any() for d in dicts), \
            "no half-pel vector"
    if t8:
        n_t8 = sum(int(d["t8"].sum()) for d in dicts if "t8" in d)
        n_act = sum(int(d["active"].sum()) for d in dicts)
        assert 0 < n_t8 < n_act, (n_t8, n_act)


@pytest.mark.parametrize("qp", [20, 30, 40])
def test_residual_recon_t8(qp):
    """_residual_recon with both transforms: levels, recon, nz grid and
    the per-MB transform choice."""
    rng = np.random.default_rng(qp)
    fr = moving_frames(2, seed=qp)
    cur = [p.astype(np.int32) for p in fr[1]]
    pred = [np.clip(p.astype(np.int32) + rng.integers(-6, 7, p.shape), 0,
                    255).astype(np.int32) for p in fr[0]]
    qpc = jtf.chroma_qp(qp)
    want = jg._residual_recon(*cur, *pred, qp, qpc, t8=True)
    got = tg._residual_recon(*map(_t, cur), *map(_t, pred), qp, qpc,
                             t8=True)
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        _eq(a, b)
    share = float(got[9].numpy().mean())
    assert 0 < share < 1, share


def test_decimate_skip_and_flag_words():
    rng = np.random.default_rng(4)
    z = (rng.integers(-2, 3, (3, 5, 16, 16))
         * (rng.random((3, 5, 16, 16)) < 0.1)).astype(np.int32)
    _eq(tg.decimate_keep_mask(_t(z)), jg.decimate_keep_mask(z))
    mv = rng.integers(-3, 4, (2, 4, 6, 2)).astype(np.int32)
    mv[:, 1:3, 2:4] = 0
    _eq(tg.skip_mv_grid(_t(mv)), jg.skip_mv_grid(mv))
    flags = rng.random((3, 37)) < 0.5
    _eq(tg._flag_words(_t(flags)), jg._flag_words(flags))


def test_port_tables_equal_reference():
    ref = reference_tables()
    mine = state.port_tables()
    assert set(mine) == set(ref)
    for name, arr in mine.items():
        np.testing.assert_array_equal(arr, ref[name], err_msg=name)


def test_from_reference_rejects_a_different_table():
    ref = dict(reference_tables())
    ref["ALPHA"] = ref["ALPHA"].copy()
    ref["ALPHA"][20] += 1
    planes = (np.zeros((16, 16), np.uint8), np.zeros((8, 8), np.uint8),
              np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError, match="ALPHA"):
        state.from_reference(ref, planes, 26, device="cpu")
    del ref["ALPHA"]
    with pytest.raises(ValueError, match="missing"):
        state.from_reference(ref, planes, 26, device="cpu")
