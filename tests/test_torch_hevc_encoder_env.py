"""The HEVC encoder's environment switches and its MP4 + AAC input against
vcp_tpu on the CPU (byte-identical MP4s), and its device guard."""

import os

import numpy as np
import pytest
import torch

from vcp_tpu.codec.y4m import write_y4m
from vcp_tpu.config import BUILTIN_PRESETS
from vcp_tpu.pipeline import executor as j_executor
from vcp_tpu_torch import cli as t_cli
from vcp_tpu_torch.codec import mp4 as t_mp4
from vcp_tpu_torch.codec.aac import AacEncoder
from vcp_tpu_torch.codec.h265 import encoder as tenc

from video_util import synth_video

W, H = 128, 64


@pytest.fixture(scope="module")
def y4m(tmp_path_factory):
    """5 frames at 30 fps (one GOP: IDR + 4 P)."""
    path = str(tmp_path_factory.mktemp("hevc_env") / "in.y4m")
    write_y4m(path, synth_video(W, H, 5), fps_num=30)
    return path


def _both(src, tmp_path, ffargs):
    ref, out = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    j_executor.execute(src, ref, ffargs)
    assert t_cli.main(["encode", src, out, f"--ffmpeg-args={ffargs}",
                       "--device", "cpu"]) == 0
    with open(ref, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
    return out


@pytest.mark.parametrize("preset,env", [
    ("h265-cpu", {"VCP_HEVC_RDI": "0"}),          # row-pattern IDR, effort 5
    ("h265-nvenc", {"VCP_HEVC_RDI": "1"}),        # RD IDR at effort 4
    ("h265-cpu", {"VCP_HEVC_RDI_LAM": "2.5"}),    # RD IDR, lambda x 2.5
])
def test_env_switches(y4m, tmp_path, monkeypatch, preset, env):
    """Both packages read the switches at every call, so a test may set
    them at a frame size other tests use."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _both(y4m, tmp_path, BUILTIN_PRESETS[preset])


def test_rd_lambda_multiplier_changes_the_stream(y4m, tmp_path,
                                                 monkeypatch):
    """VCP_HEVC_RDI_LAM reaches the RD IDR: a large multiplier gives
    another stream than the default (and vcp_tpu agrees with both)."""
    a = open(_both(y4m, tmp_path, BUILTIN_PRESETS["h265-cpu"]), "rb").read()
    monkeypatch.setenv("VCP_HEVC_RDI_LAM", "40")
    b = open(_both(y4m, tmp_path, BUILTIN_PRESETS["h265-cpu"]), "rb").read()
    assert a != b


def test_mp4_with_aac_input(tmp_path):
    """``-p h265-nvenc-hq`` from an H.264 MP4 with an AAC track (both made
    by the port): the hvc1 video and the 192 kb/s AAC track equal
    vcp_tpu's byte for byte."""
    src = str(tmp_path / "in.y4m")
    write_y4m(src, synth_video(W, H, 4), fps_num=30)
    video = str(tmp_path / "v.mp4")
    assert t_cli.main(["encode", src, video, "--device", "cpu"]) == 0
    d = t_mp4.Mp4Demuxer(video)
    v = d.video
    w = t_mp4.Mp4Writer()
    vt = t_mp4.VideoTrack(codec="h264", width=v.width, height=v.height,
                          timescale=v.timescale, sps=v.sps, pps=v.pps)
    vt.samples = [t_mp4.Sample(data=d.sample(v, i), duration=dur,
                               is_sync=i in v.sync_samples)
                  for i, dur in enumerate(v.sample_durations)]
    t = np.arange(48000 * 4 // 30) / 48000
    pcm = (0.3 * np.sin(2 * np.pi * 440 * t))[:, None] * [1, 0.5]
    enc = AacEncoder(rate=48000, channels=2, bitrate=128000)
    at = t_mp4.AudioTrack(codec="aac", sample_rate=48000, channels=2,
                          timescale=48000,
                          decoder_config=enc.audio_specific_config(),
                          avg_bitrate=128000)
    at.samples = [t_mp4.Sample(data=a, duration=1024)
                  for a in enc.encode(pcm)]
    w.add_track(vt)
    w.add_track(at)
    mp4_in = str(tmp_path / "av.mp4")
    w.write(mp4_in)
    out = _both(mp4_in, tmp_path, BUILTIN_PRESETS["h265-nvenc-hq"])
    dm = t_mp4.Mp4Demuxer(out)
    assert dm.video.codec == "hvc1" and dm.audio.codec == "mp4a"


def test_hevc_default_device_raises_without_cuda(monkeypatch, y4m,
                                                 tmp_path, capsys):
    """Without a card the HEVC entry points raise (no CPU fallback);
    ``device="cpu"`` runs them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tenc.HevcEncoderConfig(width=W, height=H)
    with pytest.raises(RuntimeError, match="CUDA"):
        tenc.HevcEncoder(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tenc.encode_stream([], cfg)
    assert t_cli.main(["encode", y4m, str(tmp_path / "o.mp4"), "-p",
                       "h265-nvenc"]) == 1
    assert "error: RuntimeError:" in capsys.readouterr().err
    assert not os.path.exists(str(tmp_path / "o.mp4"))
    tenc.HevcEncoder(cfg, device="cpu")
