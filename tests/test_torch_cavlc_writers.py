"""The port's CAVLC slice writers against vcp_tpu's, byte for byte, on
level arrays and vectors drawn from numpy seeds at two frame sizes (no
device step): the native I writer (row pattern and per-MB modes, levels
up to the escape codes), the native P writer (16x16 MBs, dense and with
the ``active`` mask of a sparse chunk), the Python P writer (8x8
transform, partitions, both) and the Python B writer (L0, L1, Bi,
B_Direct_16x16 and B_Skip MBs). Each slice is decoded by the port's host
decoder, which must parse back the nonzero levels that went in. The CAVLC
tables of the port's generated ``tables_gen.h`` equal vcp_tpu's."""

import numpy as np
import pytest

from vcp_tpu.codec.h264 import bframe as jb
from vcp_tpu.codec.h264 import entropy as je
from vcp_tpu.codec.h264 import headers as jh
from vcp_tpu.codec.h264 import pframe as jp
from vcp_tpu.native import build as j_build
from vcp_tpu_torch.codec.h264 import bframe as tb
from vcp_tpu_torch.codec.h264 import cavlc as t_cavlc
from vcp_tpu_torch.codec.h264 import decoder as t_decoder
from vcp_tpu_torch.codec.h264 import entropy as te
from vcp_tpu_torch.codec.h264 import headers as th
from vcp_tpu_torch.codec.h264 import pframe_dec
from vcp_tpu_torch.native import build as t_build
from vcp_tpu_torch.ops.transform import MAX_LEVEL

SHAPES = ((3, 5), (4, 2))          # (MB rows, MB columns)
QP = 26


def _sp_pp(mod, shape, t8=False, b=False):
    sp = mod.SeqParams(width=16 * shape[1], height=16 * shape[0],
                       **({"profile_idc": 100 if t8 else 77, "poc_type": 0,
                           "num_ref_frames": 2} if b else
                          {"profile_idc": 100} if t8 else {}))
    return sp, mod.PicParams(init_qp=26, cabac=False, transform_8x8=t8)


def _sparse(rng, shape, hi, density):
    """Random levels in [-hi, hi], each nonzero with ``density``."""
    lv = rng.integers(-hi, hi + 1, shape)
    return np.where(rng.random(shape) < density, lv, 0).astype(np.int32)


def _levels(rng, nby, nbx, hi=40, empty=0.3):
    """Inter level arrays; a share ``empty`` of the MBs has no residual,
    and some luma quadrants are empty (a partial CBP)."""
    d = {"luma": _sparse(rng, (nby, nbx, 16, 16), hi, 0.2),
         "cb_dc": _sparse(rng, (nby, nbx, 4), hi, 0.4),
         "cr_dc": _sparse(rng, (nby, nbx, 4), hi, 0.4),
         "cb_ac": _sparse(rng, (nby, nbx, 4, 16), hi, 0.1),
         "cr_ac": _sparse(rng, (nby, nbx, 4, 16), hi, 0.1)}
    d["cb_ac"][..., 0] = d["cr_ac"][..., 0] = 0      # DC rides in *_dc
    quads = rng.random((nby, nbx, 4)) < 0.3
    d["luma"][np.repeat(quads, 4, axis=-1)] = 0
    no_res = rng.random((nby, nbx)) < empty
    for k in d:
        d[k][no_res] = 0
    return d


def _nonzero(d, keys):
    return sorted(int(v) for k in keys for v in d[k].ravel() if v)


def _parsed_levels(monkeypatch, nals):
    """The nonzero levels the port's decoder parses from ``nals`` (SPS,
    PPS, slices), in sorted order per slice."""
    per_slice = []
    real = t_cavlc.decode_residual_block

    def record(*a):
        out = real(*a)
        per_slice[-1].extend(int(v) for v in out if v)
        return out

    for mod in (t_decoder, pframe_dec):
        monkeypatch.setattr(mod, "decode_residual_block", record)
    dec = t_decoder.H264Decoder()
    for nal in nals:
        per_slice.append([])
        dec.decode_annexb(nal)
    return [sorted(x) for x in per_slice if x]


def _islice(rng, shape, modes):
    nby, nbx = shape
    d = {"luma_dc": _sparse(rng, (nby, nbx, 16), MAX_LEVEL, 0.5),
         "luma_ac": _sparse(rng, (nby, nbx, 16, 16), 60, 0.15),
         "cb_dc": _sparse(rng, (nby, nbx, 4), 500, 0.5),
         "cr_dc": _sparse(rng, (nby, nbx, 4), 500, 0.5),
         "cb_ac": _sparse(rng, (nby, nbx, 4, 16), 20, 0.1),
         "cr_ac": _sparse(rng, (nby, nbx, 4, 16), 20, 0.1)}
    d["luma_ac"][..., 0] = d["cb_ac"][..., 0] = d["cr_ac"][..., 0] = 0
    # some MBs without AC (cbp 0) and without chroma AC (cbp_chroma 1)
    d["luma_ac"][rng.random((nby, nbx)) < 0.3] = 0
    no_cac = rng.random((nby, nbx)) < 0.3
    d["cb_ac"][no_cac] = d["cr_ac"][no_cac] = 0
    if modes:
        # a legal I16 / chroma mode per MB: V needs the top MB, H the
        # left, Plane both
        top = np.arange(nby)[:, None] > 0
        left = np.arange(nbx)[None, :] > 0
        m = rng.integers(0, 4, (nby, nbx))
        ok = np.select([m == 0, m == 1, m == 3], [top, left, top & left],
                       True)
        d["modes"] = np.where(ok, m, 2).astype(np.int32)
        c = rng.integers(0, 4, (nby, nbx))
        ok = np.select([c == 1, c == 2, c == 3], [left, top, top & left],
                       True)
        d["cmodes"] = np.where(ok, c, 0).astype(np.int32)
    return d


def _write_i(shape, data, rng):
    """The IDR through both writers; vcp_tpu's is handed random source
    planes."""
    sp_j, pp_j = _sp_pp(jh, shape)
    sp_t, pp_t = _sp_pp(th, shape)
    h, w = 16 * shape[0], 16 * shape[1]
    src = [rng.integers(0, 256, s, dtype=np.uint8)
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    kw = dict(frame_num=0, idr_pic_id=3, qp=QP - 3, deblock=True)
    nal_j = je.write_islice(sp_j, pp_j, data=dict(data), src_y=src[0],
                            src_u=src[1], src_v=src[2], cabac=False, **kw)
    nal_t = te.write_islice(sp_t, pp_t, data=dict(data), **kw)
    return nal_j, nal_t, sp_t, pp_t


def test_cavlc_tables_match_vcp_tpu():
    ours = t_build.cavlc_tables()
    theirs = j_build.generate_tables_header().splitlines()
    assert len(ours) == 10 and all(line in theirs for line in ours)
    assert all(line in t_build.generate_tables_header().splitlines()
               for line in ours)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("modes", [False, True])
def test_islice(shape, modes, monkeypatch):
    """The IDR writer: the row pattern or per-MB modes; luma DC levels up
    to the quantizers' clamp reach the level escape. Every MB is I16x16
    (vcp_tpu's CAVLC writer emits no I_PCM), so the output does not
    depend on the (random) source planes vcp_tpu's writer is handed."""
    rng = np.random.default_rng(100 * shape[0] + shape[1] + modes)
    data = _islice(rng, shape, modes)
    nal_j, nal_t, sp, pp = _write_i(shape, data, rng)
    assert nal_t == nal_j
    assert nal_t[3] & 0x1F == 5 and nal_t[3] >> 5 == 3
    parsed = _parsed_levels(monkeypatch, [th.write_sps(sp),
                                          th.write_pps(pp), nal_t])
    assert parsed == [_nonzero(data, ("luma_dc", "luma_ac", "cb_dc",
                                      "cr_dc", "cb_ac", "cr_ac"))]


def _mvs(rng, nby, nbx, zero=0.3):
    """Quarter-pel [dy, dx] vectors within +-40, some zero."""
    mv = rng.integers(-40, 41, (nby, nbx, 2)).astype(np.int32)
    mv[rng.random((nby, nbx)) < zero] = 0
    return mv


def _mv8(rng, nby, nbx):
    """An 8x8-grid field holding every partition shape: per MB 16x16,
    16x8, 8x16 or P_8x8 vectors."""
    kind = rng.integers(0, 4, (nby, nbx))
    mv8 = np.zeros((2 * nby, 2 * nbx, 2), np.int32)
    for y in range(nby):
        for x in range(nbx):
            q = rng.integers(-24, 25, (2, 2, 2))
            if kind[y, x] == 0:
                q[:] = q[0, 0]
            elif kind[y, x] == 1:
                q[:, 1] = q[:, 0]
            elif kind[y, x] == 2:
                q[1] = q[0]
            mv8[2 * y:2 * y + 2, 2 * x:2 * x + 2] = q
    return mv8


def _ref_idr(rng, shape, sp, pp):
    return te.write_islice(sp, pp, frame_num=0, idr_pic_id=0, qp=QP,
                           data=_islice(rng, shape, False), deblock=True)


def _write_p(shape, data, t8):
    kw = dict(frame_num=1, qp=QP, deblock=True, poc_lsb=0)
    sp_j, pp_j = _sp_pp(jh, shape, t8)
    sp_t, pp_t = _sp_pp(th, shape, t8)
    nal_j = jp.write_pslice(sp_j, pp_j, data=dict(data), cabac=False, **kw)
    nal_t = te.write_pslice(sp_t, pp_t, data=dict(data), **kw)
    return nal_j, nal_t, sp_t, pp_t


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["dense", "active", "t8", "parts",
                                  "t8-parts"])
def test_pslice(shape, kind, monkeypatch):
    """16x16 MBs (dense, and a sparse chunk's ``active`` mask with the
    skips' vectors re-derived) through the native writer; the 8x8
    transform (interleaved 4x4 transport), partitions and both through
    the Python writer."""
    rng = np.random.default_rng(7 * shape[0] + shape[1]
                                + 31 * len(kind))
    nby, nbx = shape
    data = _levels(rng, nby, nbx)
    data["mv"] = _mvs(rng, nby, nbx)
    if kind == "active":
        data["active"] = rng.random((nby, nbx)) < 0.6
        for k in ("luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac", "mv"):
            data[k][~data["active"]] = 0
    t8 = "t8" in kind
    if t8:
        data["t8"] = rng.random((nby, nbx)) < 0.5
    if "parts" in kind:
        data["mv8"] = _mv8(rng, nby, nbx)
        data["mv"] = data["mv8"][::2, ::2]
        data["parts"] = np.ones((nby, nbx), np.int32)
    nal_j, nal_t, sp, pp = _write_p(shape, data, t8)
    assert nal_t == nal_j
    parsed = _parsed_levels(monkeypatch, [
        th.write_sps(sp), th.write_pps(pp),
        _ref_idr(np.random.default_rng(0), shape, sp, pp), nal_t])
    assert parsed[-1] == _nonzero(data, ("luma", "cb_dc", "cr_dc",
                                         "cb_ac", "cr_ac"))


def _bslice_data(rng, shape):
    """B-slice inputs: every other MB (raster order) explicit, cycling
    through L0 / L1 / Bi, the others with the mode and vectors of the
    spatial-direct derivation (vcp_tpu's ``direct_spatial``), a share of
    them without residual (B_Skip), the rest B_Direct_16x16."""
    nby, nbx = shape
    data = _levels(rng, nby, nbx, empty=0.2)
    raster = np.arange(nby * nbx).reshape(nby, nbx)
    mode = (raster // 2 % 3).astype(np.int32)
    direct = raster % 2 == 1
    mv0, mv1 = _mvs(rng, nby, nbx), _mvs(rng, nby, nbx)
    col_zero = rng.random((nby, nbx)) < 0.4
    xy = [np.zeros((nby, nbx, 2), np.int64) for _ in range(2)]
    for y in range(nby):
        for x in range(nbx):
            if direct[y, x]:
                use = [mode != 1, mode != 0]
                u0, u1, d0, d1 = jb.direct_spatial(
                    xy[0], xy[1], use[0], use[1], x, y, nbx,
                    bool(col_zero[y, x]))
                mode[y, x] = jb._mode_of(u0, u1)
                for mv, dm in ((mv0, d0), (mv1, d1)):
                    if dm is not None:
                        mv[y, x] = (dm[1], dm[0])
                if rng.random() < 0.6:
                    for k in ("luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac"):
                        data[k][y, x] = 0
            for k, mv in enumerate((mv0, mv1)):
                xy[k][y, x] = (mv[y, x, 1], mv[y, x, 0])
    data.update(mode=mode, mv0=mv0, mv1=mv1, col_zero=col_zero,
                col_safe=col_zero | (rng.random((nby, nbx)) < 0.8))
    return data


@pytest.mark.parametrize("shape", SHAPES)
def test_bslice(shape, monkeypatch):
    rng = np.random.default_rng(shape[0] * 11 + shape[1])
    data = _bslice_data(rng, shape)
    kw = dict(frame_num=2, qp=QP + 4, deblock=True, poc_lsb=2)
    sp_j, pp_j = _sp_pp(jh, shape, b=True)
    sp_t, pp_t = _sp_pp(th, shape, b=True)
    nal_j = jb.write_bslice(sp_j, pp_j, data=dict(data), cabac=False, **kw)
    nal_t = tb.write_bslice(sp_t, pp_t, data=dict(data), **kw)
    assert nal_t == nal_j and nal_t[3] >> 5 == 0
    # all three modes, and MBs the writer codes as B_Skip
    mode = data["mode"]
    assert {0, 1, 2} <= set(mode.ravel().tolist())
    xy = [np.stack([m[..., 1], m[..., 0]], -1) for m in (data["mv0"],
                                                       data["mv1"])]
    use = [mode != 1, mode != 0]
    empty = ~(data["luma"].any((-1, -2)) | data["cb_dc"].any(-1)
              | data["cr_dc"].any(-1) | data["cb_ac"].any((-1, -2))
              | data["cr_ac"].any((-1, -2)))
    assert any(empty[y, x] and data["col_safe"][y, x] and jb._skippable(
        xy, use, x, y, shape[1], bool(data["col_zero"][y, x]),
        int(mode[y, x])) for y in range(shape[0]) for x in range(shape[1]))
    # decode after an IDR and a P anchor (display order I B P)
    anchor = dict(_levels(np.random.default_rng(1), *shape),
                  mv=_mvs(np.random.default_rng(2), *shape))
    p_nal = te.write_pslice(sp_t, pp_t, frame_num=1, qp=QP, data=anchor,
                            deblock=True, poc_lsb=4)
    parsed = _parsed_levels(monkeypatch, [
        th.write_sps(sp_t), th.write_pps(pp_t),
        _ref_idr(np.random.default_rng(0), shape, sp_t, pp_t), p_nal,
        nal_t])
    assert parsed[-1] == _nonzero(data, ("luma", "cb_dc", "cr_dc",
                                         "cb_ac", "cr_ac"))
