"""The half-pel quality path of vcp_tpu_torch (``-c:v libx264 -preset
medium -bf 0``: pyramid or exhaustive full-pel search refined to half-pel,
adaptive 8x8 transform, RD intra IDR, High profile) against vcp_tpu on
the CPU: byte-identical NAL units and MP4 files.

vcp_tpu reads VCP_HIER_ME while it traces and caches the trace by frame
size and static arguments, so the cases with VCP_HIER_ME=0 use a frame
size (W0 x H) that no other test of this process encodes."""

import os

import numpy as np
import pytest

from vcp_tpu.codec.h264 import encoder as je
from vcp_tpu.codec.y4m import write_y4m
from vcp_tpu.pipeline import executor as j_executor
from vcp_tpu_torch import cli as t_cli
from vcp_tpu_torch.codec.h264 import encoder as te
from vcp_tpu_torch.codec.h264 import entropy as t_entropy
from vcp_tpu_torch.ops import motion as t_motion
from vcp_tpu_torch.ops import motion_cuda

W, H = 96, 64
W0 = 112                     # frame width of the VCP_HIER_ME=0 cases
QUALITY = "-c:v libx264 -preset medium -bf 0"


def moving_frames(n, w=W, cut=None, seed=0):
    """A gradient half and a texture half that move by a fractional number
    of pixels per frame, plus noise (half-pel vectors, both transforms and
    both intra MB types occur); inverted from frame ``cut`` on."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:w].astype(np.float64)
    cy, cx = np.mgrid[0:H // 2, 0:w // 2].astype(np.float64)
    out = []
    for t in range(n):
        x, yv = xx + 1.5 * t, yy + 0.5 * t
        grad = 60 + 0.8 * x + 0.5 * yv + 20 * np.sin(x / 17.0)
        tex = 128 + 60 * np.sin(x / 2.9) * np.cos(yv / 3.7)
        y = np.where(xx < w // 2, grad, tex) + rng.integers(-3, 4, (H, w))
        u = 128 + 30 * np.sin((cx + 0.75 * t) / 9.0)
        v = 128 + 30 * np.cos((cy + 0.25 * t) / 7.0)
        f = tuple(np.clip(p, 0, 255).astype(np.uint8) for p in (y, u, v))
        out.append(tuple(255 - p for p in f)
                   if cut is not None and t >= cut else f)
    return out


def _config(w, **kw):
    return dict(width=w, height=H, qp=25, gop_size=4, effort=5,
                transform8=True, parts=True, bframes=0, **kw)


def _assert_streams_equal(fr, kw):
    sps_j, pps_j, sam_j = je.encode_stream(fr, je.EncoderConfig(**kw))
    sps_t, pps_t, sam_t = te.encode_stream(fr, te.EncoderConfig(**kw),
                                           device="cpu")
    assert (sps_t, pps_t) == (sps_j, pps_j)
    assert sps_t[1] == 100                      # High profile
    assert [s[1] for s in sam_j] == [True, False, False, False, True,
                                     True, False]
    assert len(sam_t) == len(sam_j)
    for k, (a, b) in enumerate(zip(sam_t, sam_j)):
        assert a == b, f"access unit {k} differs"


@pytest.mark.parametrize("deblock", [True, False])
def test_encode_stream_half_pel_quality_shape(deblock):
    """Effort 5 without B pictures, search range 12: the pyramid search."""
    _assert_streams_equal(moving_frames(7, cut=5),
                          _config(W, deblock=deblock))


def test_encode_stream_golden_clip():
    """Four frames of the 320x192 gradient-motion golden clip (240 MBs a
    frame): the content the i8 and t8 tools are there for."""
    z = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "gradmotion_320x192.npz"))
    fr = [(z[f"f{i}_y"], z[f"f{i}_u"], z[f"f{i}_v"]) for i in range(4)]
    kw = dict(_config(320), height=192, qp=27)
    _, _, sam_j = je.encode_stream(fr, je.EncoderConfig(**kw))
    _, _, sam_t = te.encode_stream(fr, te.EncoderConfig(**kw), device="cpu")
    assert sam_t == sam_j


def test_encode_stream_exhaustive_search(monkeypatch):
    """VCP_HIER_ME=0: the exhaustive search-only search (the CUDA kernel's
    plain version here) feeds the half-pel refinement."""
    monkeypatch.setenv("VCP_HIER_ME", "0")
    hier = []
    monkeypatch.setattr(t_motion, "hier_search",
                        lambda *a, **k: hier.append(1))
    _assert_streams_equal(moving_frames(7, w=W0, cut=5), _config(W0))
    assert not hier


@pytest.mark.parametrize("hier_me", ["", "0"])
def test_quality_shape_uses_its_tools(monkeypatch, hier_me):
    """The effort-5 GOP really runs what this path adds: the pyramid
    search, or with VCP_HIER_ME=0 the search-only motion search; some IDR
    MBs are i8 and some I16, some P MBs take the 8x8 transform, and some
    vectors have a half-pel phase."""
    seen = {"i8": [], "t8": 0, "half": 0, "hier": 0, "search_only": 0}
    real_i, real_p = t_entropy.write_islice, t_entropy.write_pslice
    real_hier, real_search = t_motion.hier_search, motion_cuda.motion_search

    def spy_i(*a, **kw):
        seen["i8"].append(float(np.mean(kw["data"]["i8"])))
        return real_i(*a, **kw)

    def spy_p(*a, **kw):
        d = kw["data"]
        seen["t8"] += int(d["t8"].sum()) if "t8" in d else 0
        seen["half"] += int(((d["mv"] & 3) == 2).sum())
        return real_p(*a, **kw)

    def spy_hier(*a, **kw):
        seen["hier"] += 1
        return real_hier(*a, **kw)

    def spy_search(*a, with_pred=False, **kw):
        seen["search_only"] += not with_pred
        return real_search(*a, with_pred=with_pred, **kw)

    from vcp_tpu_torch.codec.h264 import gop_ops as t_gop
    monkeypatch.setenv("VCP_HIER_ME", hier_me)
    monkeypatch.setattr(t_entropy, "write_islice", spy_i)
    monkeypatch.setattr(t_entropy, "write_pslice", spy_p)
    monkeypatch.setattr(t_motion, "hier_search", spy_hier)
    monkeypatch.setattr(t_gop, "motion_search", spy_search)
    enc = te.H264Encoder(te.EncoderConfig(**_config(W)), device="cpu")
    assert len(enc.encode_gop(moving_frames(4))) == 4
    assert len(seen["i8"]) == 1 and 0 < seen["i8"][0] < 1, seen
    assert seen["t8"] > 0 and seen["half"] > 0, seen
    assert (seen["hier"], seen["search_only"]) == \
        ((0, 3) if hier_me == "0" else (3, 0)), seen


@pytest.mark.parametrize("ffargs,w,env", [
    # constant quality, then ABR: a bitrate this small makes the rate
    # controller move the QP (and with it lambda2) per GOP
    (f"{QUALITY} -crf 23 -movflags +faststart", W, {}),
    (f"{QUALITY} -b:v 3k -movflags +faststart", W, {}),
    ("-c:v h264_nvenc -preset p5 -bf 0 -b:v 10M", W, {}),
    (f"{QUALITY} -b:v 10M -movflags +faststart", W0, {"VCP_HIER_ME": "0"}),
    # effort 6: the same tools over a search range of 16
    ("-c:v libx264 -preset slow -bf 0 -crf 26", W, {}),
])
def test_encode_file_mp4_identical(tmp_path, monkeypatch, ffargs, w, env):
    """The CLI's MP4 equals vcp_tpu's byte for byte; the Y4M runs at 6
    fps, so its 6-frame GOPs each update the rate controller."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    src = str(tmp_path / "in.y4m")
    write_y4m(src, moving_frames(13, w=w, cut=9), fps_num=6)
    ref, out = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    j_executor.execute(src, ref, ffargs)
    assert t_cli.main(["encode", src, out, f"--ffmpeg-args={ffargs}",
                       "--device", "cpu"]) == 0
    with open(ref, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
