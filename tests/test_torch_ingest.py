"""MP4 / H.264 ingest of vcp_tpu_torch against vcp_tpu on the CPU: the
host decoder frame by frame on libx264 streams and on the port's own
MP4s, the demuxer's sample tables, MP4 -> MP4 transcodes through both
executors (with an AAC track too), garbage in the other containers, and
HEVC in MP4 (intra pictures decode, inter ones fail alike), tolerance
0."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from vcp_tpu.codec import ingest as j_ingest
from vcp_tpu.codec import mp4 as j_mp4
from vcp_tpu.codec.h264.decoder import H264Decoder as JDecoder
from vcp_tpu.codec.y4m import write_y4m
from vcp_tpu.pipeline import executor as j_executor
from vcp_tpu_torch import cli as t_cli
from vcp_tpu_torch.codec import ingest as t_ingest
from vcp_tpu_torch.codec import mp4 as t_mp4
from vcp_tpu_torch.codec.h264.decoder import DecodeError
from vcp_tpu_torch.codec.h264.decoder import H264Decoder as TDecoder
from vcp_tpu_torch.codec.h264.decoder import psnr
from vcp_tpu_torch.config import BUILTIN_PRESETS
from vcp_tpu_torch.pipeline import executor as t_executor

from test_torch_encoder_hq import qframes

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
X264 = sorted(glob.glob(os.path.join(GOLDEN, "*_x264_*.264")))
NVENC = BUILTIN_PRESETS["h264-nvenc"]


def _assert_frames_equal(got, want):
    assert len(got) == len(want) > 0
    for k, (a, b) in enumerate(zip(got, want)):
        for p, q, name in zip(a, b, "yuv"):
            np.testing.assert_array_equal(p, q, err_msg=f"frame {k} {name}")


def _planes(frames):
    return [(f.y, f.u, f.v) for f in frames]


def test_golden_streams_present():
    assert len(X264) == 8, X264


@pytest.mark.parametrize("path", X264, ids=os.path.basename)
def test_decoder_x264_goldens(path):
    """libx264 streams (High profile, CABAC, B-pyramid, weighted
    prediction, multi-ref): every frame equals vcp_tpu's decode."""
    with open(path, "rb") as fh:
        data = fh.read()
    got = _planes(TDecoder().decode_annexb(data))
    _assert_frames_equal(got, _planes(JDecoder().decode_annexb(data)))
    assert len(got) == 24


@pytest.mark.parametrize("k,match", [(4, "MB count mismatch"),
                                     (5, "sub-8x8 partitions")])
def test_decoder_truncated_cabac_slice(k, match):
    """A CABAC slice cut to half its length: the native parser's error
    code is a DecodeError naming what it met, where vcp_tpu's decoder
    raises too."""
    with open(os.path.join(GOLDEN, "texture_256x160_x264_crf20.264"),
              "rb") as fh:
        nals = t_mp4.split_annexb(fh.read())
    assert nals[k][0] & 31 == 1                  # a non-IDR slice
    nals[k] = nals[k][: len(nals[k]) // 2]
    with pytest.raises(DecodeError, match=match):
        TDecoder().decode_nals(nals)
    with pytest.raises(ValueError):
        JDecoder().decode_nals(nals)


@pytest.fixture(scope="module")
def port_mp4s(tmp_path_factory):
    """The port's own MP4s of 9 frames (one GOP) for the three shipped
    H.264 presets, encoded on the CPU: {preset: (path, source frames)}."""
    tmp = tmp_path_factory.mktemp("port_mp4")
    frames = qframes(9)
    src = str(tmp / "src.y4m")
    write_y4m(src, frames, fps_num=30)
    out = {}
    for preset in ("h264-nvenc", "h264-cpu", "h264-nvenc-hq"):
        path = str(tmp / f"{preset}.mp4")
        assert t_cli.main(["encode", src, path, "-p", preset,
                           "--device", "cpu"]) == 0
        out[preset] = (path, frames)
    return out


@pytest.mark.parametrize("preset", ["h264-nvenc", "h264-cpu",
                                    "h264-nvenc-hq"])
def test_decoder_port_mp4s(port_mp4s, preset):
    """Ingest of the port's MP4s (B pictures and ctts for h264-cpu and
    hq): the same frames in display order as vcp_tpu's ingest, close to
    the source."""
    path, src = port_mp4s[preset]
    tv, jv = t_ingest.open_video(path), j_ingest.open_video(path)
    assert (tv.width, tv.height, tv.fps_num, tv.fps_den, tv.num_frames) == \
        (jv.width, jv.height, jv.fps_num, jv.fps_den, jv.num_frames)
    got = list(tv.frames)
    _assert_frames_equal(got, list(jv.frames))
    assert len(got) == len(src) == 9
    assert min(psnr(g[0], s[0]) for g, s in zip(got, src)) > 30.0


def test_decoder_cavlc_mp4(port_mp4s, tmp_path, monkeypatch):
    """A CAVLC stream (``VCP_CABAC=0``), written by vcp_tpu and by the
    port, which write the same file: the CAVLC slice parsers and the
    numpy intra reconstruction give vcp_tpu's frames."""
    from vcp_tpu_torch.codec.h264.headers import parse_pps
    from vcp_tpu_torch.pipeline import executor as t_executor
    from vcp_tpu_torch.utils.bitstream import emulation_remove
    frames = port_mp4s["h264-nvenc"][1]
    src, path = str(tmp_path / "src.y4m"), str(tmp_path / "cavlc.mp4")
    ours = str(tmp_path / "cavlc-port.mp4")
    write_y4m(src, frames, fps_num=30)
    monkeypatch.setenv("VCP_CABAC", "0")
    j_executor.execute(src, path, NVENC)
    t_executor.execute(src, ours, NVENC, device="cpu")
    monkeypatch.delenv("VCP_CABAC")
    with open(path, "rb") as a, open(ours, "rb") as b:
        assert a.read() == b.read()
    pps = t_mp4.Mp4Demuxer(ours).video.pps[0]
    assert not parse_pps(emulation_remove(pps[1:])).cabac
    got = list(t_ingest.open_video(ours).frames)
    _assert_frames_equal(got, list(j_ingest.open_video(path).frames))
    assert len(got) == 9
    assert min(psnr(g[0], f[0]) for g, f in zip(got, frames)) > 30.0


def _with_audio(tmp_path, video_mp4, name="av.mp4", aus=None):
    """The video track of ``video_mp4`` plus an AAC track (48 kHz stereo)
    of ``aus``, by default 3 made-up samples, written by vcp_tpu's
    muxer."""
    d = j_mp4.Mp4Demuxer(video_mp4)
    v = d.video
    tr = j_mp4.VideoTrack(codec="h264", width=v.width, height=v.height,
                          timescale=v.timescale, sps=v.sps, pps=v.pps)
    for i in range(v.sample_count):
        tr.samples.append(j_mp4.Sample(
            data=d.sample(v, i), duration=v.sample_durations[i],
            is_sync=i in v.sync_samples))
    au = j_mp4.AudioTrack(codec="aac", sample_rate=48000, channels=2,
                          timescale=48000, decoder_config=b"\x11\x90")
    if aus is None:
        aus = [bytes([0x21, k, 0x40]) for k in range(3)]
    for a in aus:
        au.samples.append(j_mp4.Sample(data=a, duration=1024, is_sync=True))
    w = j_mp4.Mp4Writer()
    w.add_track(tr)
    w.add_track(au)
    path = str(tmp_path / name)
    w.write(path, faststart=True)
    return path


def test_demuxer_tables(port_mp4s, tmp_path):
    """Every field of every demuxed track equals vcp_tpu's, for a video
    MP4 with B pictures and for one with an AAC track."""
    path, _ = port_mp4s["h264-cpu"]
    for p in (path, _with_audio(tmp_path, path)):
        td, jd = t_mp4.Mp4Demuxer(p), j_mp4.Mp4Demuxer(p)
        assert [dataclasses.asdict(t) for t in td.tracks] == \
            [dataclasses.asdict(t) for t in jd.tracks]
        v = td.video
        for i in range(v.sample_count):
            assert td.sample_nals(v, i) == jd.sample_nals(jd.video, i)
    assert td.audio.decoder_config == b"\x11\x90"


def _execute_both(src, tmp_path, ffargs):
    ref, out = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    j_executor.execute(src, ref, ffargs)
    t_executor.execute(src, out, ffargs, device="cpu")
    with open(ref, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
    return out


def test_mp4_to_mp4_identical(port_mp4s, tmp_path):
    """An MP4 of ``h264-cpu`` (B pictures, partitions, intra MBs in P)
    transcoded with ``-p h264-nvenc``: the same MP4 bytes as vcp_tpu's."""
    path, _ = port_mp4s["h264-cpu"]
    out = _execute_both(path, tmp_path, NVENC)
    assert len(list(t_ingest.open_video(out).frames)) == 9


def test_aac_track_raises(port_mp4s, tmp_path):
    """An MP4 input with an AAC track (48 kHz stereo, the clip's length):
    ``-p h264-nvenc`` decodes the track and encodes it again at 128 kb/s,
    and the MP4 equals vcp_tpu's byte for byte; with ``-an`` too, without
    the track."""
    from vcp_tpu.codec.aac import AacEncoder
    t = np.arange(9 * 1600) / 48000
    pcm = np.stack([6000 * np.sin(2 * np.pi * 440 * t),
                    6000 * np.sin(2 * np.pi * 550 * t)], 1).astype(np.int16)
    enc = AacEncoder(rate=48000, channels=2, bitrate=192000)
    assert enc.audio_specific_config() == b"\x11\x90"
    aus = enc.encode(pcm)
    src = _with_audio(tmp_path, port_mp4s["h264-nvenc"][0], aus=aus)
    out = _execute_both(src, tmp_path, NVENC)
    d = t_mp4.Mp4Demuxer(out)
    got = [d.sample(d.audio, i) for i in range(d.audio.sample_count)]
    assert len(got) == len(aus) and got != aus
    out = _execute_both(src, tmp_path, NVENC + " -an")
    assert t_mp4.Mp4Demuxer(out).audio is None


@pytest.mark.parametrize("ext", [".mkv", ".webm", ".avi"])
def test_other_containers_raise(ext, tmp_path):
    """64 zero bytes in a Matroska / WebM / AVI file: the same
    EncodeError text from both executors."""
    path = str(tmp_path / f"in{ext}")
    with open(path, "wb") as fh:
        fh.write(b"\x00" * 64)
    errors = []
    for execute, error in ((j_executor.execute, j_executor.EncodeError),
                           (t_executor.execute, t_executor.EncodeError)):
        with pytest.raises(error) as info:
            execute(path, str(tmp_path / "o.mp4"), NVENC)
        errors.append(str(info.value))
    assert errors[0] == errors[1] and errors[0].startswith("IngestError: ")


@pytest.mark.parametrize("gop", [1, 0])
def test_hevc_mp4_ingest(gop, tmp_path):
    """HEVC in MP4 (an hvc1 file of the port's): intra-only (``-g 1``) it
    decodes in both packages to the same frames (ForeignHevcDecoder);
    with P frames both executors fail with the same EncodeError naming
    the inter slice."""
    from vcp_tpu.codec.y4m import write_y4m as j_write_y4m
    from video_util import synth_video
    src = str(tmp_path / "in.y4m")
    j_write_y4m(src, synth_video(96, 64, 3), fps_num=30)
    path = str(tmp_path / "hevc.mp4")
    args = "-c:v hevc_nvenc -preset p4 -b:v 8M" + (f" -g {gop}" if gop
                                                   else "")
    assert t_cli.main(["encode", src, path, f"--ffmpeg-args={args}",
                       "--device", "cpu"]) == 0
    assert t_mp4.Mp4Demuxer(path).video.codec == "hvc1"
    if gop == 1:
        got = list(t_ingest.open_video(path).frames)
        _assert_frames_equal(got, list(j_ingest.open_video(path).frames))
        assert len(got) == 3
        return
    errors = []
    for execute, error, kw in (
            (j_executor.execute, j_executor.EncodeError, {}),
            (t_executor.execute, t_executor.EncodeError, {"device": "cpu"})):
        with pytest.raises(error) as info:
            execute(path, str(tmp_path / "o.mp4"), NVENC, **kw)
        errors.append(str(info.value))
    assert errors[0] == errors[1] == ("IngestError: hevc: foreign HEVC "
                                      "inter slices unsupported")


def test_unknown_container_is_an_encode_error(tmp_path):
    """An extension neither package reads: IngestError, wrapped as
    EncodeError by both executors."""
    path = str(tmp_path / "in.xyz")
    with open(path, "wb") as fh:
        fh.write(b"\x00" * 64)
    for execute, error in ((j_executor.execute, j_executor.EncodeError),
                           (t_executor.execute, t_executor.EncodeError)):
        with pytest.raises(error, match="IngestError: unsupported input"):
            execute(path, str(tmp_path / "o.mp4"), NVENC)


def test_decoder_tables_match():
    """The VLC / CBP tables the decoder reads equal vcp_tpu's, and the
    VLC tables are prefix-free."""
    from vcp_tpu.codec.h264 import tables as jt
    from vcp_tpu_torch.codec.h264 import tables as tt
    tt.validate_tables()
    for name in ("ZIGZAG_4x4", "COEFF_TOKEN_NC0", "COEFF_TOKEN_NC2",
                 "COEFF_TOKEN_NC4", "COEFF_TOKEN_CHROMA_DC",
                 "TOTAL_ZEROS_4x4", "TOTAL_ZEROS_CHROMA_DC", "RUN_BEFORE",
                 "CBP_TABLE"):
        assert getattr(tt, name) == getattr(jt, name), name
