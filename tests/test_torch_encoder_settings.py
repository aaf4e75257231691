"""The port's H.264 encoder takes every setting vcp_tpu's takes: CAVLC
(``VCP_CABAC=0``), the I16-only RD IDR and the overrides that route to it
or around it (``VCP_T8``, ``VCP_RDI``, ``VCP_INTRA_P``, ``VCP_BFRAMES``,
``VCP_PARTS``). Each case encodes the same 3 frames at one shape through
both packages' ``executor.execute`` on the CPU: the MP4s are equal byte
for byte, or both fail with the same exception type, chained to the same
cause. ``encode_frame`` (the per-frame API) is held against vcp_tpu's
too."""

import numpy as np
import pytest

from vcp_tpu.codec.h264 import encoder as je
from vcp_tpu.codec.y4m import write_y4m
from vcp_tpu.pipeline import executor as j_executor
from vcp_tpu_torch.codec import mp4 as tm
from vcp_tpu_torch.codec.h264 import encoder as te
from vcp_tpu_torch.codec.h264 import headers as th
from vcp_tpu_torch.codec.ingest import open_video
from vcp_tpu_torch.config import BUILTIN_PRESETS
from vcp_tpu_torch.pipeline import executor as t_executor

from video_util import synth_video

W, H = 96, 64
QUALITY = "-c:v libx264 -preset medium -bf 0"


@pytest.fixture(scope="module")
def frames():
    return synth_video(W, H, 3)


@pytest.fixture(scope="module")
def src(frames, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("settings") / "in.y4m")
    write_y4m(path, frames)
    return path


def _outcome(executor, src, dst, args, **kw):
    """(MP4 bytes, None) or (None, (exception type, cause type))."""
    try:
        executor.execute(src, dst, args, **kw)
    except Exception as e:
        return None, (type(e).__name__, type(e.__cause__).__name__)
    with open(dst, "rb") as fh:
        return fh.read(), None


@pytest.mark.parametrize("preset,env,cavlc,fails", [
    # the 11 settings the port refused before CAVLC and the I16-only RD
    # IDR were ported
    ("h264-cpu", {"VCP_CABAC": "0"}, True, False),
    ("h264-nvenc", {"VCP_CABAC": "0"}, True, False),
    ("h264-nvenc", {"VCP_BFRAMES": "2", "VCP_T8": "1"}, False, False),
    (f"={QUALITY}", {"VCP_T8": "0"}, False, False),
    (f"={QUALITY}", {"VCP_RDI": "0"}, False, False),
    (f"={QUALITY}", {"VCP_CABAC": "0"}, True, False),
    ("h264-nvenc-hq", {"VCP_T8": "0"}, False, False),
    ("=-c:v libx264 -preset slower -bf 0", {"VCP_RDI": "0"}, False, False),
    ("=-c:v h264_nvenc -preset p4", {"VCP_T8": "1"}, False, False),
    ("=-c:v h264_nvenc -preset p4", {"VCP_RDI": "1"}, False, False),
    # the overlay without partitions: the P anchors carry no intra grid,
    # and both packages fail on the missing "intra" key
    ("=-c:v h264_nvenc -preset p4 -bf 2", {"VCP_INTRA_P": "1"}, False,
     True),
    # the Python CAVLC writers: partitioned P anchors and B slices, and
    # P slices with the 8x8 transform
    ("h264-cpu", {"VCP_CABAC": "0", "VCP_BFRAMES": "2", "VCP_PARTS": "1"},
     True, False),
    ("h264-cpu", {"VCP_CABAC": "0", "VCP_T8": "1"}, True, False),
])
def test_setting_matches_vcp_tpu(preset, env, cavlc, fails, src, tmp_path,
                                 monkeypatch):
    """``preset`` names a built-in preset, or, after "=", raw encode
    arguments. The port's MP4 decodes with its own host decoder, whose
    PPS shows the entropy mode."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = preset[1:] if preset.startswith("=") else BUILTIN_PRESETS[preset]
    ref, out = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    want = _outcome(j_executor, src, ref, args)
    got = _outcome(t_executor, src, out, args, device="cpu")
    assert got == want
    assert (want[0] is None) == fails
    if fails:
        assert want[1] == ("EncodeError", "KeyError")
        return
    pps = th.parse_pps(tm.Mp4Demuxer(out).video.pps[0][1:])
    assert pps.cabac == (not cavlc)
    assert len(list(open_video(out).frames)) == 3


@pytest.mark.parametrize("cabac", [True, False])
def test_encode_frame_matches_vcp_tpu(frames, cabac):
    """IDR + 2 P through ``encode_frame``: the same access units, flags
    and recon; a GOP of 2 puts a second IDR at the third frame."""
    for gop in (30, 2):
        kw = dict(width=W, height=H, qp=27, gop_size=gop, cabac=cabac)
        jenc = je.H264Encoder(je.EncoderConfig(**kw))
        tenc = te.H264Encoder(te.EncoderConfig(**kw), device="cpu")
        assert tenc.sps_pps_raw() == jenc.sps_pps_raw()
        for f in frames:
            assert tenc.encode_frame(*f) == jenc.encode_frame(*f)
        for a, b in zip(tenc.recon_planes, jenc.recon_planes):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert tenc.encode_frame(*frames[0], force_idr=True) == \
        jenc.encode_frame(*frames[0], force_idr=True)


def test_encode_frame_refuses_b_pictures(frames):
    kw = dict(width=W, height=H, bframes=2)
    for mod, extra in ((je, {}), (te, {"device": "cpu"})):
        enc = mod.H264Encoder(mod.EncoderConfig(**kw), **extra)
        with pytest.raises(ValueError, match="B frames"):
            enc.encode_frame(*frames[0])
