"""End-to-end parity of the vcp_tpu_torch encoder with vcp_tpu on the CPU
(byte-identical NAL units and MP4 files), its import boundary, and its
device guard. Every setting of ``EncoderConfig`` against vcp_tpu:
``test_torch_encoder_settings.py``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vcp_tpu.codec.h264 import encoder as je
from vcp_tpu.codec.y4m import write_y4m
from vcp_tpu.pipeline import executor as j_executor
from vcp_tpu_torch import cli as t_cli
from vcp_tpu_torch import device as t_device
from vcp_tpu_torch.codec.h264 import encoder as te

from video_util import synth_video

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden",
                      "texture_256x160_x264_crf26.264")
W, H = 96, 64
CUT = 9


@pytest.fixture(scope="module")
def frames():
    """13 frames with a scene cut at frame 9 (an IDR lands there)."""
    out = synth_video(W, H, 13)
    return out[:CUT] + [tuple(255 - p for p in f) for f in out[CUT:]]


@pytest.mark.parametrize("deblock", [True, False])
def test_encode_stream_nal_units_match(frames, deblock):
    kw = dict(width=W, height=H, qp=26, gop_size=6, deblock=deblock)
    sps_j, pps_j, sam_j = je.encode_stream(frames, je.EncoderConfig(**kw))
    sps_t, pps_t, sam_t = te.encode_stream(frames, te.EncoderConfig(**kw),
                                           device="cpu")
    assert (sps_t, pps_t) == (sps_j, pps_j)
    assert [s[1] for s in sam_j] == [True] + [False] * 5 + [True, False,
                                                            False, True] \
        + [False] * 3
    assert len(sam_t) == len(sam_j)
    for k, (a, b) in enumerate(zip(sam_t, sam_j)):
        assert a == b, f"access unit {k} differs"


QUALITY = "-c:v libx264 -preset medium -bf 0"


@pytest.mark.parametrize("args", [
    ["-p", "h264-nvenc"],
    # a bitrate this small makes the ABR controller move the QP per GOP
    ["--ffmpeg-args=-c:v h264_nvenc -preset p4 -b:v 2k -movflags "
     "+faststart"],
])
def test_encode_file_mp4_identical(frames, tmp_path, args):
    """The CLI's MP4 equals vcp_tpu's byte for byte (the writer stamps no
    time); the Y4M runs at 6 fps, so its 6-frame GOPs each update the
    rate controller."""
    from vcp_tpu.config import BUILTIN_PRESETS
    src = str(tmp_path / "in.y4m")
    write_y4m(src, frames, fps_num=6)
    ref, out = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    ffargs = BUILTIN_PRESETS["h264-nvenc"] if args[0] == "-p" \
        else args[0].split("=", 1)[1]
    j_executor.execute(src, ref, ffargs)
    assert t_cli.main(["encode", src, out, *args, "--device", "cpu"]) == 0
    with open(ref, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()


def test_no_jax_or_vcp_tpu_imports():
    """Importing every module of the port, and chip_smoke.py, pulls in
    neither jax nor vcp_tpu; neither does a host decode of an H.264
    stream (the decoder, its native parser and reconstruction, the host
    deblock; and under ``VCP_NO_NATIVE=1`` its Python parsers, NumPy
    reconstruction and NumPy deblock), an AAC encode, a resize, an HEVC encode of IDR + P (row
    and RD intra), its validation decode, a foreign HEVC decode or a copy
    task from a producer through the port's mini-redis to a consumer."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import vcp_tpu_torch\n"
        "for m in pkgutil.walk_packages(vcp_tpu_torch.__path__,"
        " 'vcp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from vcp_tpu_torch.codec.h264.decoder import H264Decoder\n"
        f"data = open({GOLDEN!r}, 'rb').read()\n"
        "assert len(H264Decoder().decode_annexb(data)) == 24\n"
        "import os\n"
        "os.environ['VCP_NO_NATIVE'] = '1'\n"
        "assert len(H264Decoder().decode_annexb(data)) == 24\n"
        "del os.environ['VCP_NO_NATIVE']\n"
        "import numpy, torch\n"
        "from vcp_tpu_torch.codec.aac import AacEncoder\n"
        "from vcp_tpu_torch.ops.scale import bilinear_resize\n"
        "assert len(AacEncoder().encode(numpy.zeros(2048))) == 2\n"
        "assert bilinear_resize(torch.zeros(8, 8), 4, 4).shape == (4, 4)\n"
        "from vcp_tpu_torch.codec.h265 import encoder, decoder, foreign\n"
        "from vcp_tpu_torch.codec.mp4 import split_annexb\n"
        "f = [(numpy.full((32, 64), 9 * k, numpy.uint8),"
        " numpy.full((16, 32), 128, numpy.uint8),"
        " numpy.full((16, 32), 128, numpy.uint8)) for k in range(3)]\n"
        "for eff, g in ((4, 30), (5, 1)):\n"
        "    c = encoder.HevcEncoderConfig(64, 32, effort=eff, gop_size=g)\n"
        "    v, s, p, out = encoder.encode_stream(f, c, device='cpu')\n"
        "    es = b''.join(b'\\0\\0\\0\\1' + n for n in (v, s, p))"
        " + b''.join(a for a, _ in out)\n"
        "    assert len(list(decoder.decode_annexb(es))) == 3\n"
        "fd = foreign.ForeignHevcDecoder()\n"
        "assert sum(fd.decode_nal(n) is not None"
        " for n in split_annexb(es)) == 3\n"
        "import os, struct, tempfile, time\n"
        "from vcp_tpu_torch.codec import mp4\n"
        "from vcp_tpu_torch.codec.h264 import headers as H\n"
        "from vcp_tpu_torch.config import Config\n"
        "from vcp_tpu_torch.pipeline.consumer import Consumer\n"
        "from vcp_tpu_torch.pipeline.producer import Producer\n"
        "from vcp_tpu_torch.queue.miniredis import MiniRedisServer\n"
        "srv = MiniRedisServer(port=0); srv.start()\n"
        "d = tempfile.mkdtemp(); cfg = Config()\n"
        "cfg.redis.address = srv.address\n"
        "cfg.producer.watch_directory = os.path.join(d, 'raw')\n"
        "cfg.producer.shared_directory = os.path.join(d, 'shared')\n"
        "cfg.producer.output_directory = os.path.join(d, 'out')\n"
        "cfg.producer.ffmpeg_preset = 'copy'\n"
        "tr = mp4.VideoTrack(codec='h264', width=64, height=48,"
        " timescale=30000,"
        " sps=[H.write_sps(H.SeqParams(width=64, height=48))[4:]],"
        " pps=[H.write_pps(H.PicParams())[4:]])\n"
        "nal = b'\\x65' + bytes(20)\n"
        "tr.samples.append(mp4.Sample(data=struct.pack('>I', len(nal))"
        " + nal, duration=1000, is_sync=True))\n"
        "w = mp4.Mp4Writer(); w.add_track(tr)\n"
        "src = os.path.join(d, 'in.mp4'); w.write(src)\n"
        "data = open(src, 'rb').read()\n"
        "prod = Producer(cfg, poll_interval=0.05, stability_checks=2,"
        " stability_interval=0.02)\n"
        "cons = Consumer(cfg, name='imports', device='cpu')\n"
        "prod.start(); cons.start()\n"
        "os.rename(src, os.path.join(cfg.producer.watch_directory,"
        " 'in.mp4'))\n"
        "t0 = time.monotonic()\n"
        "while cons.counters.succeeded < 1 and time.monotonic() - t0 < 30:\n"
        "    time.sleep(0.05)\n"
        "cons.stop(); prod.stop(); srv.stop()\n"
        "assert open(os.path.join(d, 'out', 'in.mp4'), 'rb').read()"
        " == data\n"
        "need = ['vcp_tpu_torch.codec.ingest',"
        " 'vcp_tpu_torch.codec.h264.decoder',"
        " 'vcp_tpu_torch.codec.h264.native_parse',"
        " 'vcp_tpu_torch.codec.h264.native_recon',"
        " 'vcp_tpu_torch.ops.deblock_host',"
        " 'vcp_tpu_torch.codec.h264.cabac_syntax',"
        " 'vcp_tpu_torch.codec.h264.inter_cabac',"
        " 'vcp_tpu_torch.codec.h264.inter_recon',"
        " 'vcp_tpu_torch.ops.color',"
        " 'vcp_tpu_torch.codec.cabac',"
        " 'vcp_tpu_torch.codec.h265.ctx',"
        " 'vcp_tpu_torch.codec.h265.residual',"
        " 'vcp_tpu_torch.codec.h265.syntax',"
        " 'vcp_tpu_torch.codec.h265.headers',"
        " 'vcp_tpu_torch.codec.h265.frame_ops',"
        " 'vcp_tpu_torch.codec.h265.intra_rd',"
        " 'vcp_tpu_torch.codec.h265.encoder',"
        " 'vcp_tpu_torch.codec.h265.decoder',"
        " 'vcp_tpu_torch.codec.h265.foreign',"
        " 'vcp_tpu_torch.ops.transform_hevc',"
        " 'vcp_tpu_torch.ops.deblock_hevc',"
        " 'vcp_tpu_torch.queue.miniredis', 'vcp_tpu_torch.codec.probe',"
        " 'vcp_tpu_torch.pipeline.watcher', 'vcp_tpu_torch.utils.fs']\n"
        "assert all(m in sys.modules for m in need)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'vcp_tpu'))\n"
        "print(len([m for m in sys.modules if m.startswith('vcp_tpu_torch')]),"
        " bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) > 40 and bad == "[]", out.stdout


def test_default_device_raises_without_cuda(monkeypatch, frames, tmp_path,
                                           capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_device.resolve_device()
    cfg = te.EncoderConfig(width=W, height=H)
    with pytest.raises(RuntimeError, match="CUDA"):
        te.H264Encoder(cfg)
    src = str(tmp_path / "in.y4m")
    write_y4m(src, frames[:2])
    # the executor wraps the failure as EncodeError, which the CLI reports
    assert t_cli.main(["encode", src, str(tmp_path / "o.mp4")]) == 1
    assert "error: RuntimeError:" in capsys.readouterr().err
    assert t_device.resolve_device("cpu") == torch.device("cpu")


def test_mp4_input_raises(frames, tmp_path):
    """An MP4 input that carries an AAC track (mono, 44.1 kHz): the
    default preset re-encodes the track at 128 kb/s beside the video, and
    ``-vn -c:a aac`` (no bitrate) passes it through alone; both MP4s
    equal vcp_tpu's byte for byte."""
    from vcp_tpu.codec import mp4 as jm
    from vcp_tpu.codec.aac import AacEncoder
    from vcp_tpu_torch.codec import mp4 as tm
    from vcp_tpu_torch.config import BUILTIN_PRESETS
    from vcp_tpu_torch.pipeline import executor as t_executor
    src = str(tmp_path / "in.y4m")
    write_y4m(src, frames[:2])
    video = str(tmp_path / "v.mp4")
    assert t_cli.main(["encode", src, video, "--device", "cpu"]) == 0
    d = jm.Mp4Demuxer(video)
    tr = jm.VideoTrack(codec="h264", width=W, height=H,
                       timescale=d.video.timescale, sps=d.video.sps,
                       pps=d.video.pps)
    tr.samples = [jm.Sample(data=d.sample(d.video, i), duration=1000,
                            is_sync=i == 0) for i in range(2)]
    enc = AacEncoder(rate=44100, channels=1, bitrate=96000)
    t = np.arange(3000) / 44100
    aus = enc.encode((8000 * np.sin(2 * np.pi * 330 * t)).astype(np.int16))
    au = jm.AudioTrack(codec="aac", sample_rate=44100, channels=1,
                       timescale=44100,
                       decoder_config=enc.audio_specific_config())
    au.samples = [jm.Sample(data=a, duration=1024) for a in aus]
    assert au.decoder_config == b"\x12\x08"
    w = jm.Mp4Writer()
    w.add_track(tr)
    w.add_track(au)
    av = str(tmp_path / "av.mp4")
    w.write(av)
    for args, handlers in ((BUILTIN_PRESETS["h264-nvenc"], ["vide", "soun"]),
                           ("-vn -c:a aac", ["soun"])):
        ref, out = str(tmp_path / "ref.mp4"), str(tmp_path / "o.mp4")
        j_executor.execute(av, ref, args)
        t_executor.execute(av, out, args, device="cpu")
        with open(ref, "rb") as a, open(out, "rb") as b:
            assert a.read() == b.read()
        d = tm.Mp4Demuxer(out)
        assert [x.handler for x in d.tracks] == handlers
        got = [d.sample(d.audio, i) for i in range(d.audio.sample_count)]
        assert len(got) == len(aus) and (got == aus) == ("-vn" in args)


@pytest.mark.parametrize("args", [
    "-c:v h264_nvenc -preset p4 -b:v 10M",
    "-c:v libx264 -preset medium -crf 23",
])
def test_missing_input_is_an_encode_error(tmp_path, capsys, args):
    """A missing input fails as EncodeError from both executors, chained
    to the FileNotFoundError, and the CLI reports it without a
    traceback."""
    from vcp_tpu_torch.pipeline import executor as t_executor
    for path in ("nope.y4m", "nope.mp4"):
        src = str(tmp_path / path)
        dst = str(tmp_path / "o.mp4")
        with pytest.raises(j_executor.EncodeError,
                           match="FileNotFoundError"):
            j_executor.execute(src, dst, args)
        with pytest.raises(t_executor.EncodeError,
                           match="FileNotFoundError") as info:
            t_executor.execute(src, dst, args, device="cpu")
        assert isinstance(info.value.__cause__, FileNotFoundError)
        assert t_cli.main(["encode", src, dst, f"--ffmpeg-args={args}",
                           "--device", "cpu"]) == 1
        assert "error: FileNotFoundError" in capsys.readouterr().err


def test_not_ported_passes_through_unwrapped(frames, tmp_path,
                                             monkeypatch):
    """NotImplementedError from the encoder is not wrapped as EncodeError,
    so a setting that is not ported stays loud. (Every H.264 setting runs
    now; the encoder is made to raise here.)"""
    from vcp_tpu_torch.pipeline import executor as t_executor

    def not_ported(*a, **kw):
        raise NotImplementedError("not ported yet: a setting (ROADMAP A10)")

    monkeypatch.setattr(te, "encode_stream", not_ported)
    src = str(tmp_path / "in.y4m")
    write_y4m(src, frames[:2])
    with pytest.raises(NotImplementedError, match="A10") as info:
        t_executor.execute(src, str(tmp_path / "o.mp4"),
                           "-c:v h264_nvenc -preset p4", device="cpu")
    assert not isinstance(info.value, t_executor.EncodeError)


def test_recon_planes_psnr(frames):
    """The encoder's recon of the last frame tracks the source."""
    enc = te.H264Encoder(te.EncoderConfig(width=W, height=H, qp=22),
                         device="cpu")
    enc.encode_gop(frames[:4])
    ry = enc.recon_planes[0].astype(np.float64)
    mse = np.mean((ry - frames[3][0].astype(np.float64)) ** 2)
    assert 10 * np.log10(255.0 ** 2 / mse) > 35.0


@pytest.mark.parametrize("width,height,cabac,high", [
    (96, 64, True, False), (1920, 1080, True, False), (100, 50, False, False),
    (1920, 1080, True, True)])
def test_headers_match(width, height, cabac, high):
    from vcp_tpu.codec.h264 import headers as jh
    from vcp_tpu.utils.bitstream import BitWriter as JW
    from vcp_tpu_torch.codec.h264 import headers as th
    from vcp_tpu_torch.utils.bitstream import BitWriter as TW
    skw = {"profile_idc": 100} if high else {}
    assert th.write_sps(th.SeqParams(width, height, **skw)) == \
        jh.write_sps(jh.SeqParams(width, height, **skw))
    assert th.write_pps(th.PicParams(cabac=cabac, transform_8x8=high)) == \
        jh.write_pps(jh.PicParams(cabac=cabac, transform_8x8=high))
    if high:
        cfg = te.EncoderConfig(width=width, height=height, effort=5,
                               transform8=True)
        enc = te.H264Encoder(cfg, device="cpu")
        assert enc.sp.profile_idc == 100 and enc.pp.transform_8x8
    for is_idr, deblock in ((True, True), (False, True), (False, False)):
        kw = dict(is_idr=is_idr, frame_num=3, slice_qp=31, idr_pic_id=2,
                  disable_deblocking=not deblock)
        jw, tw = JW(), TW()
        jh.write_slice_header(jw, jh.SeqParams(width, height),
                              jh.PicParams(cabac=cabac), **kw)
        th.write_slice_header(tw, th.SeqParams(width, height),
                              th.PicParams(cabac=cabac), **kw)
        jw.rbsp_trailing_bits()
        tw.rbsp_trailing_bits()
        assert tw.to_bytes() == jw.to_bytes()
