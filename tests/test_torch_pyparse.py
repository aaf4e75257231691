"""The port's decoder without its C++ parser and reconstruction
(``VCP_NO_NATIVE=1``), against vcp_tpu's Python routes and against the
port's native decode, at tolerance 0.

Streams: the first pictures of two x264 goldens (High profile CABAC with
B pictures, 8x8 transform, weighted and multi-reference prediction), the
port's own ``h264-cpu``-like B GOP (partitions, intra MBs in P
pictures, i8 MBs) and the same GOP in CAVLC.

* The frames decoded under ``VCP_NO_NATIVE=1`` equal the port's native
  frames and vcp_tpu's under either of its routes to the same code
  (``VCP_NATIVE_PARSE=0 VCP_NATIVE_RECON=0``, ``VCP_NO_NATIVE=1``).
* ``inter_recon.recon_inter_frame`` gives the planes of
  ``native_recon.recon_inter_native`` on every inter picture's ctx.
* The Python parsers (``cabac_syntax.parse_islice_cabac``,
  ``inter_cabac.parse_inter_slice_cabac``) leave the grids of the native
  parser on every slice, and the same final state as vcp_tpu's: every
  grid of the slice ctx, the intra queue and the I rows.
* A truncated CABAC slice raises ``DecodeError`` from the Python parser
  as it does from the native one."""

import copy
import os

import numpy as np
import pytest

from vcp_tpu.codec.h264 import cabac_syntax as jcs
from vcp_tpu.codec.h264 import inter_cabac as jic
from vcp_tpu.codec.h264.decoder import H264Decoder as JDecoder
from vcp_tpu_torch.codec import mp4 as t_mp4
from vcp_tpu_torch.codec.h264 import cabac_syntax as tcs
from vcp_tpu_torch.codec.h264 import inter_cabac as tic
from vcp_tpu_torch.codec.h264 import inter_recon as tir
from vcp_tpu_torch.codec.h264 import native_parse as tnp
from vcp_tpu_torch.codec.h264 import native_recon as tnr
from vcp_tpu_torch.codec.h264.decoder import DecodeError
from vcp_tpu_torch.codec.h264.decoder import H264Decoder as TDecoder
from vcp_tpu_torch.codec.h264.encoder import EncoderConfig, H264Encoder

from video_util import synth_video

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
NO_NATIVE = {"VCP_NO_NATIVE": "1"}
# vcp_tpu's two routes to its Python parse and NumPy reconstruction
THEIRS = {"py": {"VCP_NATIVE_PARSE": "0", "VCP_NATIVE_RECON": "0"},
          "nonative": NO_NATIVE}
ALL = ("VCP_NO_NATIVE", "VCP_NATIVE_PARSE", "VCP_NATIVE_RECON")


def _golden(name: str, n_pics: int) -> list[bytes]:
    """SPS, PPS and the first ``n_pics`` slices of a golden stream."""
    with open(os.path.join(GOLDEN, name), "rb") as fh:
        nals = t_mp4.split_annexb(fh.read())
    out, pics = [], 0
    for nal in nals:
        if nal[0] & 31 in (1, 5):
            if pics == n_pics:
                break
            pics += 1
        out.append(nal)
    return out


def _own_bgop(cabac: bool) -> list[bytes]:
    """The port's IDR + P + 2 B (+ P) at 96x64 with partitions, encoded
    on the CPU; with CABAC also the overlay (gate off) and i8."""
    os.environ["VCP_INTRA_GATE"] = "0"
    try:
        enc = H264Encoder(EncoderConfig(
            width=96, height=64, qp=26, gop_size=5, effort=6, cabac=cabac,
            bframes=2, transform8=cabac, parts=True), device="cpu")
        aus = enc.encode_gop(synth_video(96, 64, 5))
    finally:
        del os.environ["VCP_INTRA_GATE"]
    return t_mp4.split_annexb(enc.headers_annexb()
                              + b"".join(a[0] for a in aus))


STREAMS = {
    # I P B B B P B P: B pyramids over 3 B pictures, i8 and P_8x8
    "gradmotion": lambda: _golden("gradmotion_320x192_x264_crf26.264", 8),
    "texture": lambda: _golden("texture_256x160_x264_crf32.264", 8),
    "own-bgop": lambda: _own_bgop(True),
    # CAVLC: the parse is the decoder's own; the NumPy reconstruction
    # and deblock run under the switches
    "own-cavlc": lambda: _own_bgop(False),
}


def _frames(decoder_cls, nals, env, monkeypatch):
    for k in ALL:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = [tuple(np.asarray(p) for p in (f.y, f.u, f.v))
           for f in decoder_cls().decode_nals(list(nals))]
    for k in ALL:
        monkeypatch.delenv(k, raising=False)
    return out


@pytest.fixture(scope="module")
def decoded():
    """{stream: (nals, the port's native frames, its frames under
    ``VCP_NO_NATIVE=1``, {route: vcp_tpu's frames})}: each decode runs
    once per module."""
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for name, make in STREAMS.items():
            nals = make()
            out[name] = (nals, _frames(TDecoder, nals, {}, mp),
                         _frames(TDecoder, nals, NO_NATIVE, mp),
                         {r: _frames(JDecoder, nals, env, mp)
                          for r, env in THEIRS.items()})
        return out
    finally:
        mp.undo()


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(x, y) for fa, fb in zip(a, b) for x, y in zip(fa, fb))


@pytest.mark.parametrize("route", list(THEIRS))
@pytest.mark.parametrize("stream", list(STREAMS))
def test_decode_matches(stream, route, decoded):
    _, ref, ours, theirs = decoded[stream]
    assert len(ours) == len(ref) >= 5
    assert _equal(ours, ref)
    assert _equal(theirs[route], ref)


@pytest.mark.parametrize("stream", list(STREAMS))
def test_inter_recon_matches_native(stream, decoded, monkeypatch):
    """On every inter picture of a native decode, the NumPy
    reconstruction of a copy of the planes equals the native one."""
    nals, ref = decoded[stream][:2]
    real, same = tnr.recon_inter_native, []

    def both(ctx):
        twin = dict(ctx, **{k: ctx[k].copy() for k in "yuv"})
        tir.recon_inter_frame(twin)
        real(ctx)
        same.append(all(np.array_equal(twin[k], ctx[k]) for k in "yuv"))

    monkeypatch.setattr(tnr, "recon_inter_native", both)
    assert _equal(_frames(TDecoder, nals, {}, monkeypatch), ref)
    assert len(same) >= 4 and all(same)


# grids both parsers fill; the residual of an intra MB leaves the Python
# parser in its intra queue, so the residual grids are held on inter MBs
GRIDS = ("mv8_l0", "ref8_l0", "mv8_l1", "ref8_l1", "dec8", "intra_mb",
         "mv_valid", "qp_mb", "p_t8")
RESIDUALS = ("p_z_luma", "p_cdc", "p_cac")


def _inter_grids(ctx) -> dict:
    g = {k: np.array(ctx[k]) for k in GRIDS + RESIDUALS if k in ctx}
    for k in RESIDUALS:
        g[k][~g["mv_valid"]] = 0
    for k in ("nz_y", "nz_cb", "nz_cr"):
        g[k] = np.array(ctx[k].nz)
    return g


@pytest.mark.parametrize("stream", ["gradmotion", "texture", "own-bgop"])
def test_parse_matches_native(stream, decoded, monkeypatch):
    """Every slice of a native decode parsed by the Python parser too:
    an I slice's cbf, QP and t8 grids, a P or B slice's grids of the
    ctx, equal to the native parser's."""
    nals, ref = decoded[stream][:2]
    real_i, real_p, same = tnp.parse_slice_native, tnp.parse_inter_slice, []

    def parse_i(payload, qp, kind, init_idc, n_mby, n_mbx, pps_t8,
                *a, **kw):
        res = real_i(payload, qp, kind, init_idc, n_mby, n_mbx, pps_t8,
                     *a, **kw)
        if kind == 2:
            rows, st = tcs.parse_islice_cabac(payload, qp, n_mby, n_mbx,
                                              transform_8x8=pps_t8)
            qp_mb = [[e.get("qp", qp) for e in row] for row in rows]
            same.append(np.array_equal(res["cbf_l4"], st.cbf_l4)
                        and np.array_equal(res["cbf_cb"], st.cbf_c4[0])
                        and np.array_equal(res["cbf_cr"], st.cbf_c4[1])
                        and np.array_equal(res["qp_mb"], qp_mb)
                        and np.array_equal(res["p_t8"].astype(bool), st.t8))
        return res

    def parse_p(ctx, payload, qp, is_b, init_idc):
        twin = copy.deepcopy({k: v for k, v in ctx.items()
                              if k not in ("list0", "list1", "col")})
        twin.update({k: ctx[k] for k in ("list0", "list1", "col")
                     if k in ctx})
        tic.parse_inter_slice_cabac(twin, payload, qp, is_b, init_idc, [])
        res = real_p(ctx, payload, qp, is_b, init_idc)
        a, b = _inter_grids(twin), _inter_grids(ctx)
        same.append(all(np.array_equal(a[k], b[k]) for k in a))
        return res

    monkeypatch.setattr(tnp, "parse_slice_native", parse_i)
    monkeypatch.setattr(tnp, "parse_inter_slice", parse_p)
    assert _equal(_frames(TDecoder, nals, {}, monkeypatch), ref)
    assert len(same) >= 5 and all(same)


def _snapshot_inter(ctx, intra_queue) -> dict:
    keys = ("mv8_l0", "ref8_l0", "mv8_l1", "ref8_l1", "dec8", "intra_mb",
            "mv_valid", "qp_mb", "p_z_luma", "p_cdc", "p_cac", "p_t8")
    snap = {k: np.array(ctx[k]) for k in keys if k in ctx}
    for k in ("nz_y", "nz_cb", "nz_cr"):
        snap[k] = np.array(ctx[k].nz)
    snap["cur_qp"] = ctx["cur_qp"]
    snap["intra_queue"] = [(x, y, {k: np.array(v) for k, v in p.items()})
                           for x, y, p in intra_queue]
    return snap


def _snapshot_i(rows, st) -> dict:
    snap = {k: np.array(getattr(st, k)) for k in (
        "cbf_l4", "cbf_c4", "t8", "intra", "i_nxn", "cbp_luma8",
        "cbp_chroma", "chroma_mode")}
    snap["rows"] = [[{k: np.array(v) for k, v in e.items()} for e in row]
                    for row in rows]
    return snap


def _recorded(mod_i, mod_p, decoder_cls, nals, env, monkeypatch) -> list:
    """Snapshots of every Python parse of ``nals`` under ``env``."""
    snaps = []
    real_i, real_p = mod_i.parse_islice_cabac, mod_p.parse_inter_slice_cabac

    def parse_i(*a, **kw):
        rows, st = real_i(*a, **kw)
        snaps.append(_snapshot_i(rows, st))
        return rows, st

    def parse_p(ctx, payload, qp, is_b, init_idc, intra_queue):
        out = real_p(ctx, payload, qp, is_b, init_idc, intra_queue)
        snaps.append(_snapshot_inter(ctx, intra_queue))
        return out

    monkeypatch.setattr(mod_i, "parse_islice_cabac", parse_i)
    monkeypatch.setattr(mod_p, "parse_inter_slice_cabac", parse_p)
    _frames(decoder_cls, nals, env, monkeypatch)
    monkeypatch.undo()
    return snaps


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("stream", ["gradmotion", "texture", "own-bgop"])
def test_parser_state_matches(stream, decoded, monkeypatch):
    nals = decoded[stream][0]
    ours = _recorded(tcs, tic, TDecoder, nals, NO_NATIVE, monkeypatch)
    theirs = _recorded(jcs, jic, JDecoder, nals, THEIRS["py"], monkeypatch)
    assert len(ours) == len(theirs) >= 5
    for a, b in zip(ours, theirs):
        assert _same(a, b)


@pytest.mark.parametrize("k", [3, 4, 5])
def test_truncated_slice_raises(k, monkeypatch):
    """The IDR (k = 3), a P (k = 4) or a B (k = 5) slice cut to half its
    length."""
    nals = _golden("texture_256x160_x264_crf20.264", 4)
    assert nals[k][0] & 31 == (5 if k == 3 else 1)
    nals[k] = nals[k][: len(nals[k]) // 2]
    with pytest.raises(DecodeError):
        _frames(TDecoder, nals, NO_NATIVE, monkeypatch)
