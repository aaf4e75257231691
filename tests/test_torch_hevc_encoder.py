"""End-to-end parity of the vcp_tpu_torch HEVC encoder with vcp_tpu on the
CPU: the three shipped presets through both executors and the port's
CLI (byte-identical hvc1 MP4s), and NAL units of ``encode_stream`` under
CRF and ABR at a size that is not a multiple of the CTU."""

import numpy as np
import pytest

from vcp_tpu.codec.args import parse_encode_args as j_parse
from vcp_tpu.codec.h265 import encoder as jenc
from vcp_tpu.codec.y4m import write_y4m
from vcp_tpu.config import BUILTIN_PRESETS
from vcp_tpu.pipeline import executor as j_executor
from vcp_tpu_torch import cli as t_cli
from vcp_tpu_torch.codec import mp4 as t_mp4
from vcp_tpu_torch.codec.args import parse_encode_args as t_parse
from vcp_tpu_torch.codec.h265 import encoder as tenc

from video_util import synth_video

W, H = 96, 64
CUT = 5


@pytest.fixture(scope="module")
def frames():
    """7 frames with a scene cut at frame 5 (an IDR lands there)."""
    out = synth_video(W, H, 7)
    return out[:CUT] + [tuple(255 - p for p in f) for f in out[CUT:]]


@pytest.mark.parametrize("preset", ["h265-nvenc", "h265-cpu",
                                    "h265-nvenc-hq"])
def test_preset_mp4_identical(frames, tmp_path, preset):
    """``-p h265-*`` through the port's CLI equals vcp_tpu's executor byte
    for byte: an hvc1 sample entry, IDRs at 0 and the cut, quarter-pel P
    frames; h265-cpu's IDRs are the RD wavefront (effort 5). At 6 fps the
    GOP is 6 frames, and a cut does not restart its count."""
    src = str(tmp_path / "in.y4m")
    write_y4m(src, frames, fps_num=6)
    ref, out = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    j_executor.execute(src, ref, BUILTIN_PRESETS[preset])
    assert t_cli.main(["encode", src, out, "-p", preset, "--device",
                       "cpu"]) == 0
    with open(ref, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
    v = t_mp4.Mp4Demuxer(out).video
    assert v.codec == "hvc1" and v.vps and v.sps and v.pps
    assert sorted(v.sync_samples) == [0, CUT, 6]


@pytest.mark.parametrize("args", [
    "-c:v libx265 -preset medium -crf 33 -g 3",
    # a bitrate this small moves the ABR controller's QP every GOP
    "-c:v hevc_nvenc -preset p4 -b:v 30k -g 3",
])
def test_encode_stream_odd_size(frames, args):
    """``encode_stream`` at 88x56 (padded to 96x64, cropped by the SPS
    conformance window), GOPs of 3 and the scene cut: the same VPS / SPS
    / PPS and NAL units as vcp_tpu's."""
    w, h = 88, 56
    crop = [(y[:h, :w], u[:h // 2, :w // 2], v[:h // 2, :w // 2])
            for y, u, v in frames]
    jc = jenc.HevcEncoderConfig.from_params(j_parse(args), w, h, 6, 1)
    tc = tenc.HevcEncoderConfig.from_params(t_parse(args), w, h, 6, 1)
    assert (jc.qp, jc.gop_size, jc.effort) == (tc.qp, tc.gop_size,
                                              tc.effort)
    ref = jenc.encode_stream(crop, jc)
    out = tenc.encode_stream(crop, tc, device="cpu")
    assert out[:3] == ref[:3]
    assert [s[1] for s in out[3]] == [True, False, False, True, False,
                                      True, True]
    for k, (a, b) in enumerate(zip(out[3], ref[3])):
        assert a == b, f"access unit {k} differs"


def test_recon_is_cropped_and_matches(frames):
    """The closed-loop recon the port keeps on its device equals vcp_tpu's
    after a GOP, cropped to the frame."""
    cfg = dict(width=W, height=H, qp=27, gop_size=8, effort=4)
    jx = jenc.HevcEncoder(jenc.HevcEncoderConfig(**cfg))
    tx = tenc.HevcEncoder(tenc.HevcEncoderConfig(**cfg), device="cpu")
    for f in frames[:3]:
        assert tx.encode_frame(*f) == jx.encode_frame(*f)
    for a, b in zip(tx.recon_planes, jx.recon_planes):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tx.recon_planes[0].shape == (H, W)
