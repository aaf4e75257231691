"""The port's host paths without its C++ library (``VCP_NO_NATIVE=1``)
against vcp_tpu's under the same switch and against the port's native
paths, at tolerance 0.

* Writers: level arrays and vectors drawn from numpy seeds go through
  vcp_tpu's writers under the switch, the port's Python writers and the
  port's native writers at QP 18 / 30 / 44; all three give the same NAL
  bytes (CAVLC I, CABAC I16 and i8, CAVLC and CABAC P 16x16 with the
  ``active`` mask of a sparse chunk, P with the 8x8 transform, P
  partitions, intra MBs in P, B), and so does the NAL escape.
* Encoder: ``executor.execute`` on the CPU under the switch gives the
  MP4 of vcp_tpu's under the switch and of the port's native run:
  effort 2 with CABAC and with CAVLC over two GOPs (the delta upload's
  carried tiles cross the second IDR), and an ``h264-cpu`` B GOP with
  partitions, the intra overlay and i8 MBs.
* Host pieces: the NumPy deblock equals the native one for the per-MB
  and per-8x8 vector grids and the general dict form, with and without
  t8; the tile pair of ``gop_ops.tile_delta`` equals the native pass and
  updates the carried tiles in place.
* The rule: without the switch a failed build raises and no Python
  writer runs; with it the encode completes and the library is never
  asked for.
"""

import numpy as np
import pytest

from vcp_tpu.codec.h264 import bframe as jb
from vcp_tpu.codec.h264 import entropy as je
from vcp_tpu.codec.h264 import headers as jh
from vcp_tpu.codec.h264 import pframe as jp
from vcp_tpu.codec.y4m import write_y4m
from vcp_tpu.pipeline import executor as j_executor
from vcp_tpu_torch import native
from vcp_tpu_torch.codec.h264 import bframe as tb
from vcp_tpu_torch.codec.h264 import cabac_syntax as tcs
from vcp_tpu_torch.codec.h264 import entropy as te
from vcp_tpu_torch.codec.h264 import gop_ops
from vcp_tpu_torch.codec.h264 import headers as th
from vcp_tpu_torch.codec.h264.encoder import EncoderConfig, H264Encoder
from vcp_tpu_torch.native import build as t_build
from vcp_tpu_torch.ops import deblock_host
from vcp_tpu_torch.pipeline import executor as t_executor
from vcp_tpu_torch.utils.bitstream import emulation_prevent

from video_util import synth_video

SHAPE = (3, 5)                     # MB rows, MB columns of the writers
QPS = (18, 30, 44)


def _sparse(rng, shape, hi, density):
    lv = rng.integers(-hi, hi + 1, shape)
    return np.where(rng.random(shape) < density, lv, 0).astype(np.int32)


def _inter_levels(rng, nby, nbx):
    """Level arrays of inter MBs; some MBs without residual, some luma
    quadrants empty (a partial CBP), some without chroma AC."""
    d = {"luma": _sparse(rng, (nby, nbx, 16, 16), 40, 0.2),
         "cb_dc": _sparse(rng, (nby, nbx, 4), 40, 0.4),
         "cr_dc": _sparse(rng, (nby, nbx, 4), 40, 0.4),
         "cb_ac": _sparse(rng, (nby, nbx, 4, 16), 20, 0.1),
         "cr_ac": _sparse(rng, (nby, nbx, 4, 16), 20, 0.1)}
    d["cb_ac"][..., 0] = d["cr_ac"][..., 0] = 0
    d["luma"][np.repeat(rng.random((nby, nbx, 4)) < 0.3, 4, axis=-1)] = 0
    no_cac = rng.random((nby, nbx)) < 0.3
    d["cb_ac"][no_cac] = d["cr_ac"][no_cac] = 0
    no_res = rng.random((nby, nbx)) < 0.3
    for k in d:
        d[k][no_res] = 0
    return d


def _modes(rng, nby, nbx):
    """Per-MB I16 and chroma modes."""
    return (rng.integers(0, 4, (nby, nbx)).astype(np.int32),
            rng.integers(0, 4, (nby, nbx)).astype(np.int32))


def _islice(rng, nby, nbx, modes: bool, i8: bool):
    d = {"luma_dc": _sparse(rng, (nby, nbx, 16), 2000, 0.5),
         "luma_ac": _sparse(rng, (nby, nbx, 16, 16), 60, 0.15),
         "cb_dc": _sparse(rng, (nby, nbx, 4), 500, 0.5),
         "cr_dc": _sparse(rng, (nby, nbx, 4), 500, 0.5),
         "cb_ac": _sparse(rng, (nby, nbx, 4, 16), 20, 0.1),
         "cr_ac": _sparse(rng, (nby, nbx, 4, 16), 20, 0.1)}
    d["luma_ac"][..., 0] = d["cb_ac"][..., 0] = d["cr_ac"][..., 0] = 0
    d["luma_ac"][rng.random((nby, nbx)) < 0.3] = 0
    no_cac = rng.random((nby, nbx)) < 0.3
    d["cb_ac"][no_cac] = d["cr_ac"][no_cac] = 0
    if modes or i8:
        d["modes"], d["cmodes"] = _modes(rng, nby, nbx)
    if i8:
        d["i8"] = rng.random((nby, nbx)) < 0.5
        d["i8_modes"] = rng.integers(0, 9, (nby, nbx, 4)).astype(np.int32)
        d["i8_luma"] = _sparse(rng, (nby, nbx, 4, 64), 30, 0.2)
        d["i8_luma"][rng.random((nby, nbx, 4)) < 0.3] = 0
    return d


def _mv8(rng, nby, nbx):
    """An 8x8-grid field with every partition shape: per MB 16x16, 16x8,
    8x16 or P_8x8 vectors ([dy, dx] quarter-pel)."""
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
    return mv8, (kind > 0).astype(np.int32)


def _case(kind: str, rng):
    """(entropy, transform_8x8, slice, data) of one writer case."""
    nby, nbx = SHAPE
    if kind in ("cavlc-i", "cabac-i16", "cabac-i8"):
        return ("cavlc" if kind == "cavlc-i" else "cabac", False, "I",
                _islice(rng, nby, nbx, modes=kind == "cabac-i16",
                        i8=kind == "cabac-i8"))
    if kind == "b":
        d = _inter_levels(rng, nby, nbx)
        d["mv0"] = rng.integers(-40, 41, (nby, nbx, 2)).astype(np.int32)
        d["mv1"] = rng.integers(-40, 41, (nby, nbx, 2)).astype(np.int32)
        zero = rng.random((nby, nbx)) < 0.3
        d["mv0"][zero] = d["mv1"][zero] = 0
        d["mode"] = rng.integers(0, 3, (nby, nbx)).astype(np.int32)
        d["col_zero"] = rng.random((nby, nbx)) < 0.5
        d["col_safe"] = rng.random((nby, nbx)) < 0.8
        return "cabac", True, "B", d
    d = _inter_levels(rng, nby, nbx)
    if kind in ("cavlc-p16", "p16"):
        d["mv"] = rng.integers(-40, 41, (nby, nbx, 2)).astype(np.int32)
        d["mv"][rng.random((nby, nbx)) < 0.3] = 0
        d["active"] = rng.random((nby, nbx)) < 0.7
        return ("cavlc" if kind == "cavlc-p16" else "cabac", False, "P", d)
    if kind == "p-t8":
        d["mv"] = rng.integers(-40, 41, (nby, nbx, 2)).astype(np.int32)
        d["t8"] = rng.random((nby, nbx)) < 0.5
        return "cabac", True, "P", d
    d["mv8"], d["parts"] = _mv8(rng, nby, nbx)
    d["mv"] = d["mv8"][::2, ::2]
    d["t8"] = rng.random((nby, nbx)) < 0.4
    if kind == "p-parts":
        return "cabac", True, "P", d
    # intra MBs among the partitions: I16 (AC blocks in "luma") and i8
    # (four 64-scans in "luma")
    intra = rng.random((nby, nbx)) < 0.4
    d["intra"] = intra
    d["i8"] = intra & (rng.random((nby, nbx)) < 0.5)
    d["imodes"], d["icmodes"] = _modes(rng, nby, nbx)
    d["luma_dc"] = _sparse(rng, (nby, nbx, 16), 300, 0.4)
    d["i8_modes"] = rng.integers(0, 9, (nby, nbx, 4)).astype(np.int32)
    i16 = intra & ~d["i8"]
    d["luma"][i16, :, 0] = 0
    d["t8"] = d["t8"] & ~intra
    return "cabac", True, "P", d


def _params(mod, entropy, t8, b):
    nby, nbx = SHAPE
    kw = {"profile_idc": 100 if t8 else 77}
    if b:
        kw.update(poc_type=0, num_ref_frames=2)
    sp = mod.SeqParams(width=16 * nbx, height=16 * nby, **kw)
    return sp, mod.PicParams(init_qp=26, cabac=entropy == "cabac",
                             transform_8x8=t8)


def _write_vcp_tpu(slice_type, sp, pp, qp, data):
    kw = dict(frame_num=1, qp=qp, data=dict(data), deblock=True,
              cabac=pp.cabac, poc_lsb=2)
    if slice_type == "I":
        h, w = 16 * sp.mb_height, 16 * sp.mb_width
        kw.update(frame_num=0, idr_pic_id=1, poc_lsb=0,
                  src_y=np.zeros((h, w), np.uint8),
                  src_u=np.zeros((h // 2, w // 2), np.uint8),
                  src_v=np.zeros((h // 2, w // 2), np.uint8))
        return je.write_islice(sp, pp, **kw)
    return (jb.write_bslice if slice_type == "B" else jp.write_pslice)(
        sp, pp, **kw)


def _write_port(slice_type, sp, pp, qp, data):
    kw = dict(frame_num=1, qp=qp, data=dict(data), deblock=True, poc_lsb=2)
    if slice_type == "I":
        kw.update(frame_num=0, idr_pic_id=1, poc_lsb=0)
        return te.write_islice(sp, pp, **kw)
    return (tb.write_bslice if slice_type == "B" else te.write_pslice)(
        sp, pp, **kw)


KINDS = ("cavlc-i", "cabac-i16", "cabac-i8", "cavlc-p16", "p16", "p-t8",
         "p-parts", "p-intra", "b")


@pytest.mark.parametrize("qp", QPS)
@pytest.mark.parametrize("kind", KINDS)
def test_writer_routes(kind, qp, monkeypatch):
    """vcp_tpu under the switch == the port's Python writer == the port's
    native writer, byte for byte."""
    rng = np.random.default_rng(1000 * KINDS.index(kind) + qp)
    entropy, t8, slice_type, data = _case(kind, rng)
    sp_j, pp_j = _params(jh, entropy, t8, slice_type == "B")
    sp_t, pp_t = _params(th, entropy, t8, slice_type == "B")
    monkeypatch.setenv("VCP_NO_NATIVE", "1")
    ref = _write_vcp_tpu(slice_type, sp_j, pp_j, qp, data)
    py = _write_port(slice_type, sp_t, pp_t, qp, data)
    monkeypatch.delenv("VCP_NO_NATIVE")
    nat = _write_port(slice_type, sp_t, pp_t, qp, data)
    assert py == ref
    assert nat == ref
    assert len(ref) > 10


@pytest.mark.parametrize("seed", [0, 1])
def test_nal_escape(seed, monkeypatch):
    """The escape of ``entropy._nal``: the native one and, under the
    switch, ``emulation_prevent``, on RBSPs rich in zero bytes."""
    rng = np.random.default_rng(seed)
    lib = native.get_lib()
    for _ in range(40):
        n = int(rng.integers(1, 300))
        rbsp = np.where(rng.random(n) < 0.6, 0,
                        rng.integers(0, 256, n)).astype(np.uint8)
        nat = te._nal(lib, rbsp, n, 1, 2)
        monkeypatch.setenv("VCP_NO_NATIVE", "1")
        py = te._nal(None, rbsp, n, 1, 2)
        monkeypatch.delenv("VCP_NO_NATIVE")
        assert py == nat == b"\x00\x00\x01\x41" + emulation_prevent(
            rbsp.tobytes())


# ---------------------------------------------------------------------------
# the encoder through both executors
# ---------------------------------------------------------------------------

W, H = 64, 48
BW, BH = 96, 64                    # the B GOP's frame size


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("nonative")
    paths = {}
    for name, (w, h, n) in {"speed": (W, H, 6), "bgop": (BW, BH, 5)}.items():
        paths[name] = str(d / f"{name}.y4m")
        write_y4m(paths[name], synth_video(w, h, n))
    return paths


ENCODES = {
    # effort 2 over two GOPs of 3: the second IDR is a delta upload
    "cabac": ("speed", "-c:v h264_nvenc -preset p2 -g 3", {}),
    "cavlc": ("speed", "-c:v h264_nvenc -preset p2 -g 3",
              {"VCP_CABAC": "0"}),
    # partitions, the intra overlay (gate off), i8 IDR MBs, 2 B pictures
    "h264-cpu": ("bgop", "-c:v libx264 -preset medium -crf 23",
                 {"VCP_INTRA_GATE": "0"}),
}


@pytest.mark.parametrize("name", list(ENCODES))
def test_encoder_matches(name, sources, tmp_path, monkeypatch):
    """The port's MP4 under the switch == vcp_tpu's under the switch ==
    the port's native MP4; the Python writers ran only under the
    switch."""
    src, args, env = ENCODES[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    for mod, fn in ((tcs, "write_islice_cabac"), (tcs, "write_pslice_cabac"),
                    (tcs, "write_pslice_cabac_intra"),
                    (tcs, "write_bslice_cabac"), (te, "_write_islice_py")):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _r=real, _n=fn, **kw: (
            calls.append((_n, kw["data"])), _r(*a, **kw))[1])
    out = {}
    for label, switch in (("vcp_tpu", True), ("python", True),
                          ("native", False)):
        if switch:
            monkeypatch.setenv("VCP_NO_NATIVE", "1")
        else:
            monkeypatch.delenv("VCP_NO_NATIVE")
        dst = str(tmp_path / f"{label}.mp4")
        if label == "vcp_tpu":
            j_executor.execute(sources[src], dst, args)
        else:
            n = len(calls)
            t_executor.execute(sources[src], dst, args, device="cpu")
            assert (len(calls) > n) == switch, label
        with open(dst, "rb") as fh:
            out[label] = fh.read()
    assert out["python"] == out["vcp_tpu"]
    assert out["native"] == out["vcp_tpu"]
    if name != "h264-cpu":
        return
    seen = {}
    for fn, data in calls:
        seen.setdefault(fn, []).append(data)
    assert {"write_pslice_cabac_intra", "write_bslice_cabac",
            "write_islice_cabac"} <= set(seen)
    p = seen["write_pslice_cabac_intra"]
    assert any(np.any(d["parts"]) for d in p)
    assert any(np.any(d["intra"]) for d in p)
    assert any(np.any(d.get("i8", False)) for d in seen["write_islice_cabac"])


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------

def _deblock_inputs(rng, mv_form: str, t8: bool):
    nby, nbx = 3, 4
    h, w = 16 * nby, 16 * nbx
    # samples close enough that most edges pass the alpha / beta tests
    planes = [rng.integers(120, 134, s).astype(np.int32)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    if mv_form == "mb":
        mvq = rng.integers(-8, 9, (nby, nbx, 2)).astype(np.int32)
    elif mv_form == "8x8":
        mvq = rng.integers(-8, 9, (2 * nby, 2 * nbx, 2)).astype(np.int32)
    else:
        g = (2 * nby, 2 * nbx)
        mvq = {"mv0": rng.integers(-8, 9, (*g, 2)).astype(np.int32),
               "id0": rng.integers(-1, 3, g),
               "mv1": rng.integers(-8, 9, (*g, 2)).astype(np.int32),
               "id1": rng.integers(-1, 3, g)}
        if mv_form == "dict-p":
            mvq = {k: mvq[k] for k in ("mv0", "id0")}
    return (planes, rng.integers(18, 46, (nby, nbx)).astype(np.int32),
            rng.random((nby, nbx)) < 0.25, rng.random((h // 4, w // 4)) < 0.3,
            mvq, (rng.random((nby, nbx)) < 0.4) if t8 else None)


@pytest.mark.parametrize("t8", [False, True])
@pytest.mark.parametrize("mv_form", ["mb", "8x8", "dict-p", "dict-b"])
def test_host_deblock(mv_form, t8, monkeypatch):
    """The NumPy filter == the native one == vcp_tpu's NumPy filter, on
    low-amplitude noise (most edges filter) with intra MBs, residual
    blocks, differing vectors and reference pictures."""
    from vcp_tpu.ops import deblock as jd
    rng = np.random.default_rng(["mb", "8x8", "dict-p", "dict-b"].index(
        mv_form) + 10 * t8)
    planes, qp, intra, nz, mvq, t8g = _deblock_inputs(rng, mv_form, t8)
    cq = np.clip(np.arange(52) + 2, 0, 51)      # a chroma QP offset of 2
    args = (qp, intra, nz, mvq, cq)
    nat = deblock_host.deblock_frame_host(*(p.copy() for p in planes),
                                          *args, t8=t8g)
    monkeypatch.setenv("VCP_NO_NATIVE", "1")
    py = deblock_host.deblock_frame_host(*planes, *args, t8=t8g)
    ref = jd.deblock_frame_host(*(p.copy() for p in planes), *args, t8=t8g)
    for a, b, c, p in zip(py, nat, ref, planes):
        assert a.dtype == np.int32
        assert np.array_equal(a, b) and np.array_equal(a, np.asarray(c))
        assert not np.array_equal(a, p)


@pytest.mark.parametrize("full", [False, True])
def test_tile_delta(full, monkeypatch):
    """The numpy pair under the switch == the native pass: the same
    (idx, tiles), and the carried tiles updated in place to the frame."""
    rng = np.random.default_rng(5 + full)
    h, w = 48, 80
    prev_planes = [rng.integers(0, 256, s, dtype=np.uint8)
                   for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    cur = [p.copy() for p in prev_planes]
    cur[0][16:32, 32:40] ^= 1                  # MB (1, 2)
    cur[2][20, 30] ^= 7                        # MB (2, 3)'s Cr
    start = gop_ops.tiles_from_planes_host(*prev_planes)
    out = {}
    for label in ("native", "python"):
        if label == "python":
            monkeypatch.setenv("VCP_NO_NATIVE", "1")
        prev = start.copy()
        idx, tiles = gop_ops.tile_delta(*cur, prev, full=full)
        assert np.array_equal(prev, gop_ops.tiles_from_planes_host(*cur))
        out[label] = (idx, tiles)
    assert np.array_equal(out["python"][0], out["native"][0])
    assert np.array_equal(out["python"][1], out["native"][1])
    want = np.arange(15) if full else np.array([7, 13])
    assert np.array_equal(out["python"][0], want)


# ---------------------------------------------------------------------------
# the rule: no silent fallback
# ---------------------------------------------------------------------------

def _encode_small():
    frames = synth_video(W, H, 3)
    enc = H264Encoder(EncoderConfig(width=W, height=H, qp=28, gop_size=3,
                                    effort=2), device="cpu")
    return enc.encode_gop(frames)


def test_failed_build_raises_without_switch(monkeypatch):
    """No switch: a failing build raises out of the encode, and no
    Python writer is reached."""
    def fail():
        raise RuntimeError("host entropy build failed: test")
    ran = []
    for fn in ("write_islice_cabac", "write_pslice_cabac"):
        monkeypatch.setattr(tcs, fn, lambda *a, **kw: ran.append(1))
    monkeypatch.setattr(te, "_write_islice_py",
                        lambda *a, **kw: ran.append(1))
    monkeypatch.setattr(t_build, "build", fail)
    monkeypatch.delenv("VCP_NO_NATIVE", raising=False)
    native.get_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="build failed"):
            _encode_small()
    finally:
        native.get_lib.cache_clear()
    assert ran == []


def test_switch_needs_no_library(monkeypatch):
    """``VCP_NO_NATIVE=1``: the same encode completes with the build
    failing, and the library loader is never entered."""
    def fail():
        raise RuntimeError("host entropy build failed: test")
    entered = []
    real = native._load
    monkeypatch.setattr(t_build, "build", fail)
    monkeypatch.setattr(native, "_load",
                        lambda: (entered.append(1), real())[1])
    monkeypatch.setenv("VCP_NO_NATIVE", "1")
    out = _encode_small()
    assert len(out) == 3 and entered == []
    with pytest.raises(RuntimeError, match="VCP_NO_NATIVE"):
        native.get_lib()
    assert native.disabled()
