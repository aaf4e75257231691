"""Containers of vcp_tpu_torch against vcp_tpu on the CPU, tolerance 0:
the MKV and AVI demuxers field by field, ingest of H.264 in MKV and AVI
frame by frame, the MKV remux and ``-c copy`` byte for byte, whole
encodes of ``-p h264-nvenc`` from an MP4 with AAC, an MKV with AAC and an
AVI with PCM (byte-identical MP4s, the audio re-encoded at 128 kb/s), the
reference's handling of Matroska presentation timestamps, and the inputs
that fail (the same EncodeError text from both executors). The writers
here make the inputs: MP4 through the port's muxer, MKV and AVI
by hand."""

import dataclasses
import struct

import numpy as np
import pytest

from vcp_tpu.codec import avi as j_avi
from vcp_tpu.codec import ingest as j_ingest
from vcp_tpu.codec import mkv as j_mkv
from vcp_tpu.pipeline import executor as j_executor
from vcp_tpu_torch.codec import avi as t_avi
from vcp_tpu_torch.codec import ingest as t_ingest
from vcp_tpu_torch.codec import mkv as t_mkv
from vcp_tpu_torch.codec import mp4 as t_mp4
from vcp_tpu_torch.codec.aac import AacEncoder
from vcp_tpu_torch.codec.h264 import encoder as te
from vcp_tpu_torch.config import BUILTIN_PRESETS
from vcp_tpu_torch.pipeline import executor as t_executor

from test_mkv import _el, _uint
from video_util import synth_video

W, H, N = 96, 64, 4
NVENC = BUILTIN_PRESETS["h264-nvenc"]
RATE = 48000


# --- input writers ----------------------------------------------------------

def avcc(sps: bytes, pps: bytes) -> bytes:
    return (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1])
            + struct.pack(">H", len(sps)) + sps
            + bytes([1]) + struct.pack(">H", len(pps)) + pps)


def write_mkv(path, video=None, audio=None, default_duration_ns=0,
              video_codec="V_MPEG4/ISO/AVC", lacing=False):
    """Matroska with a timestamp scale of 1 ms. ``video``: (codec private,
    width, height, [(payload, timestamp ms, keyframe)]); ``audio``:
    (AudioSpecificConfig, rate, channels, [(payload, timestamp ms)]).
    Blocks are SimpleBlocks, in the order given, in two clusters (the
    second from 100 ms on, with its own cluster timestamp)."""
    entries, blocks = b"", []
    if video is not None:
        cp, w, h, samples = video
        e = (_uint(t_mkv.TRACK_NUMBER, 1) + _uint(t_mkv.TRACK_TYPE, 1)
             + _el(t_mkv.CODEC_ID, video_codec.encode())
             + _el(t_mkv.CODEC_PRIVATE, cp)
             + _el(t_mkv.VIDEO, _uint(t_mkv.PIXEL_WIDTH, w)
                   + _uint(t_mkv.PIXEL_HEIGHT, h)))
        if default_duration_ns:
            e += _uint(t_mkv.DEFAULT_DURATION, default_duration_ns)
        entries += _el(t_mkv.TRACK_ENTRY, e)
        blocks += [(1, d, ts, key) for d, ts, key in samples]
    if audio is not None:
        asc, rate, ch, samples = audio
        entries += _el(t_mkv.TRACK_ENTRY, (
            _uint(t_mkv.TRACK_NUMBER, 2) + _uint(t_mkv.TRACK_TYPE, 2)
            + _el(t_mkv.CODEC_ID, b"A_AAC") + _el(t_mkv.CODEC_PRIVATE, asc)
            + _el(t_mkv.AUDIO, _el(t_mkv.SAMPLING_FREQUENCY,
                                   struct.pack(">d", rate))
                  + _uint(t_mkv.CHANNELS, ch))))
        blocks += [(2, d, ts, True) for d, ts in samples]
    clusters = {0: b"", 100: b""}
    for track, data, ts, key in blocks:
        base = 0 if ts < 100 else 100
        flags = (0x80 if key else 0) | (0x02 if lacing else 0)
        clusters[base] += _el(t_mkv.SIMPLE_BLOCK, bytes([0x80 | track])
                              + struct.pack(">hB", ts - base, flags) + data)
    body = b"".join(_el(t_mkv.CLUSTER, _uint(t_mkv.CLUSTER_TIMESTAMP, base)
                        + c) for base, c in clusters.items() if c)
    info = _el(t_mkv.INFO, _uint(t_mkv.TIMESTAMP_SCALE, 1_000_000))
    with open(path, "wb") as fh:
        fh.write(_el(t_mkv.EBML_HEADER, b"") + _el(
            t_mkv.SEGMENT, info + _el(t_mkv.TRACKS, entries) + body))


def _chunk(ckid: bytes, payload: bytes) -> bytes:
    return ckid + struct.pack("<I", len(payload)) + payload + \
        b"\x00" * (len(payload) & 1)


def _list(ltype: bytes, *parts: bytes) -> bytes:
    return _chunk(b"LIST", ltype + b"".join(parts))


def write_avi(path, chunks, width, height, pcm=None, rate=RATE,
              fourcc=b"H264", fps=(30, 1), format_tag=1):
    """RIFF AVI: ``hdrl`` (``avih`` + one ``strl`` per stream), ``movi``
    (``00dc`` video chunks of Annex-B NAL units, ``01wb`` chunks of s16
    PCM, ``pcm`` (n, channels) int16, in four pieces) and ``idx1``."""
    def strh(kind, handler, scale, rate_, length):
        return _chunk(b"strh", kind + handler + struct.pack(
            "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, scale, rate_, 0, length, 0,
            0xFFFFFFFF, 0, 0, 0, width, height))

    streams = [_list(b"strl", strh(b"vids", fourcc, fps[1], fps[0],
                                   len(chunks)),
                     _chunk(b"strf", struct.pack(
                         "<IiiHH4sIiiII", 40, width, height, 1, 24, fourcc,
                         width * height * 3, 0, 0, 0, 0)))]
    movi = [_chunk(b"00dc", c) for c in chunks]
    if pcm is not None:
        ch = pcm.shape[1]
        streams.append(_list(b"strl", strh(b"auds", b"\x00" * 4, 1, rate,
                                           len(pcm)),
                             _chunk(b"strf", struct.pack(
                                 "<HHIIHH", format_tag, ch, rate,
                                 rate * 2 * ch, 2 * ch, 16))))
        for part in np.array_split(pcm, 4):
            movi.append(_chunk(b"01wb", part.astype("<i2").tobytes()))
    avih = _chunk(b"avih", struct.pack("<14I", 33333, 0, 0, 0x10,
                                       len(chunks), 0, len(streams), 0,
                                       width, height, 0, 0, 0, 0))
    idx = _chunk(b"idx1", b"".join(
        struct.pack("<4sIII", c[:4], 0x10, 0, 0) for c in movi))
    body = b"AVI " + _list(b"hdrl", avih, *streams) + \
        _list(b"movi", *movi) + idx
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def two_tone(n: int, channels: int, rate: int = RATE, seed: int = 0):
    """(n, channels) int16: 440 Hz and 1 kHz tones with a little seeded
    noise."""
    t = np.arange(n) / rate
    rng = np.random.default_rng(seed)
    tones = [9000 * np.sin(2 * np.pi * 440 * t),
             7000 * np.sin(2 * np.pi * 1000 * t + 0.3)]
    x = np.stack(tones[:channels], 1) + rng.normal(0, 200, (n, channels))
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def aac_track(pcm, rate=RATE, bitrate=128000):
    """An MP4 AudioTrack of the port's AAC-LC AUs of ``pcm``."""
    enc = AacEncoder(rate=rate, channels=pcm.shape[1], bitrate=bitrate)
    tr = t_mp4.AudioTrack(codec="aac", sample_rate=rate,
                          channels=pcm.shape[1], timescale=rate,
                          decoder_config=enc.audio_specific_config(),
                          avg_bitrate=bitrate)
    tr.samples = [t_mp4.Sample(data=au, duration=1024) for au in
                  enc.encode(pcm)]
    return tr


def write_mp4(path, sps, pps, samples, width, height, audio=None,
              faststart=True):
    """The port's muxer: the video samples (Annex-B AUs, IDR flags) at 30
    fps, and ``audio`` (an AudioTrack) if given."""
    te.mux_mp4(path, sps, pps, samples, width, height, 30, 1,
               faststart=faststart, audio_track=audio)


@dataclasses.dataclass
class Clip:
    frames: list
    sps: bytes
    pps: bytes
    samples: list          # [(annexb_au, is_idr)]
    pcm: np.ndarray        # (n, 2) int16, the clip's length at 30 fps
    aac: t_mp4.AudioTrack  # its AAC-LC AUs at 128 kb/s

    def mkv_video(self, order=None, ts=None):
        order = range(len(self.samples)) if order is None else order
        return (avcc(self.sps, self.pps), W, H, [
            (t_mp4.annexb_to_length_prefixed(self.samples[i][0]),
             (ts or {}).get(i, i * 33), self.samples[i][1]) for i in order])

    def avi_chunks(self):
        """Annex-B access units, the first led by the SPS and PPS (AVI
        has no place for them outside the stream)."""
        head = b"".join(b"\x00\x00\x00\x01" + n for n in (self.sps, self.pps))
        return [head * (i == 0) + au for i, (au, _) in
                enumerate(self.samples)]

    def mkv_audio(self):
        return (self.aac.decoder_config, RATE, 2,
                [(s.data, k * 1024 * 1000 // RATE)
                 for k, s in enumerate(self.aac.samples)])


@pytest.fixture(scope="module")
def clip():
    frames = synth_video(W, H, N)
    cfg = te.EncoderConfig(width=W, height=H, qp=24)
    sps, pps, samples = te.encode_stream(frames, cfg, device="cpu")
    pcm = two_tone(N * RATE // 30, 2)
    return Clip(frames, sps, pps, samples, pcm, aac_track(pcm))


@pytest.fixture(scope="module")
def inputs(clip, tmp_path_factory):
    """{name: path}: the clip as MP4 + AAC, MKV + AAC (unlaced blocks in
    decode order), AVI + s16 PCM, and a video-only MKV."""
    d = tmp_path_factory.mktemp("containers")
    out = {k: str(d / f"{k}.{k.split('-')[0]}") for k in
           ("mp4-aac", "mkv-aac", "avi-pcm", "mkv-video")}
    write_mp4(out["mp4-aac"], clip.sps, clip.pps, clip.samples, W, H,
              clip.aac)
    write_mkv(out["mkv-aac"], clip.mkv_video(), clip.mkv_audio())
    write_mkv(out["mkv-video"], clip.mkv_video())
    write_avi(out["avi-pcm"], clip.avi_chunks(), W, H, clip.pcm)
    return out


def _fields(track):
    return None if track is None else dataclasses.asdict(track)


def test_mkv_demuxer_fields(inputs):
    """Tracks, codec private data, every block's payload, timestamp and
    keyframe flag, across two clusters."""
    for name in ("mkv-aac", "mkv-video"):
        td, jd = t_mkv.MkvDemuxer(inputs[name]), j_mkv.MkvDemuxer(inputs[name])
        assert td.timestamp_scale == jd.timestamp_scale
        assert _fields(td.video) == _fields(jd.video)
        assert _fields(td.audio) == _fields(jd.audio)
    assert len(td.video.samples) == N and td.video.width == W


def test_avi_demuxer_fields(inputs):
    td, jd = t_avi.AviDemuxer(inputs["avi-pcm"]), \
        j_avi.AviDemuxer(inputs["avi-pcm"])
    assert _fields(td.video) == _fields(jd.video)
    assert _fields(td.audio) == _fields(jd.audio)
    assert td.video.fourcc in t_avi.H264_FOURCCS == j_avi.H264_FOURCCS
    assert (td.audio.channels, td.audio.sample_rate) == (2, RATE)


@pytest.mark.parametrize("name", ["mkv-aac", "avi-pcm"])
def test_open_video_frames(inputs, clip, name):
    """Ingest of H.264 in MKV and in AVI: vcp_tpu's frames, header and
    rate."""
    tv, jv = t_ingest.open_video(inputs[name]), \
        j_ingest.open_video(inputs[name])
    assert (tv.width, tv.height, tv.fps_num, tv.fps_den, tv.num_frames) == \
        (jv.width, jv.height, jv.fps_num, jv.fps_den, jv.num_frames)
    got, want = list(tv.frames), list(jv.frames)
    assert len(got) == len(want) == N
    for a, b in zip(got, want):
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("name", ["mkv-aac", "mkv-video"])
def test_remux_to_mp4_identical(inputs, tmp_path, name):
    """The MKV remux (``-c copy``): vcp_tpu's bytes, with and without
    faststart; the samples are the MKV blocks and the AAC frames."""
    for faststart in (True, False):
        ref, out = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
        assert t_mkv.remux_to_mp4(inputs[name], out, faststart) == \
            j_mkv.remux_to_mp4(inputs[name], ref, faststart)
        with open(ref, "rb") as a, open(out, "rb") as b:
            assert a.read() == b.read()
    blocks = t_mkv.MkvDemuxer(inputs[name])
    d = t_mp4.Mp4Demuxer(out)
    for tr, src in ((d.video, blocks.video), (d.audio, blocks.audio)):
        assert (tr is None) == (src is None)
        if tr is not None:
            assert [d.sample(tr, i) for i in range(tr.sample_count)] == \
                [s.data for s in src.samples]


@pytest.mark.parametrize("name", ["mp4-aac", "mkv-aac", "mkv-video"])
def test_copy_identical(inputs, tmp_path, name):
    """``-c copy`` through both executors: the same bytes; an MP4 comes
    out equal to its input."""
    ref, out = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    n_ref = j_executor.execute(inputs[name], ref, BUILTIN_PRESETS["copy"])
    n = t_executor.execute(inputs[name], out, BUILTIN_PRESETS["copy"],
                           device="cpu")
    with open(ref, "rb") as a, open(out, "rb") as b:
        data = b.read()
        assert a.read() == data and n == n_ref == len(data)
    if name.startswith("mp4"):
        with open(inputs[name], "rb") as fh:
            assert fh.read() == data


@pytest.fixture(scope="module")
def reference_encodes(inputs, tmp_path_factory):
    """vcp_tpu's ``-p h264-nvenc`` MP4 of each input, made once."""
    d = tmp_path_factory.mktemp("ref_encodes")
    out = {}
    for name in ("mp4-aac", "mkv-aac", "avi-pcm"):
        out[name] = str(d / f"{name}.mp4")
        j_executor.execute(inputs[name], out[name], NVENC)
    return out


@pytest.mark.parametrize("name", ["mp4-aac", "mkv-aac", "avi-pcm"])
def test_encode_file_identical(inputs, reference_encodes, clip, tmp_path,
                               name):
    """``-p h264-nvenc`` (``-c:a aac -b:a 128k``) from each container: the
    MP4 equals vcp_tpu's byte for byte; it holds the clip's N frames and
    an AAC track of as many frames as the source's: the AAC sources
    decoded and encoded again (other AUs), the PCM encoded at 128 kb/s
    (the AUs the clip's track was made of)."""
    out = str(tmp_path / "port.mp4")
    t_executor.execute(inputs[name], out, NVENC, device="cpu")
    with open(reference_encodes[name], "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
    d = t_mp4.Mp4Demuxer(out)
    assert [t.handler for t in d.tracks] == ["vide", "soun"]
    assert d.video.sample_count == N
    got = [d.sample(d.audio, i) for i in range(d.audio.sample_count)]
    src = [s.data for s in clip.aac.samples]
    assert len(got) == len(src) and (got == src) == (name == "avi-pcm")


def test_mkv_presentation_timestamps_shared(tmp_path):
    """A stream with B pictures whose MKV blocks (in decode order) carry
    presentation timestamps: both packages sort by them, so both ingest
    and remux give the same result, as the reference defines it."""
    frames = synth_video(W, H, 7)
    cfg = te.EncoderConfig(width=W, height=H, qp=24, bframes=2)
    sps, pps, samples = te.encode_stream(frames, cfg, device="cpu")
    assert any(s[2] for s in samples)
    pts = {i: (i + s[2]) * 33 for i, s in enumerate(samples)}
    path = str(tmp_path / "b.mkv")
    clip = Clip(frames, sps, pps, [s[:2] for s in samples], None, None)
    write_mkv(path, clip.mkv_video(ts=pts))

    def run(ingest):
        try:
            return [tuple(p.copy() for p in f)
                    for f in ingest.open_video(path).frames]
        except Exception as e:
            return type(e).__name__
    got, want = run(t_ingest), run(j_ingest)
    if isinstance(want, str):
        assert got == want
    else:
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for p, q in zip(a, b):
                np.testing.assert_array_equal(p, q)
    ref, out = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    j_mkv.remux_to_mp4(path, ref)
    t_mkv.remux_to_mp4(path, out)
    with open(ref, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()


def _bad_inputs(d, clip):
    """{case: (path, encode args)} of inputs that both executors fail."""
    au = clip.avi_chunks()
    cases = {}
    p = str(d / "bad.mkv")
    with open(p, "wb") as fh:
        fh.write(b"\x1a\x45\xdf\xa3\x84junk" + bytes(range(40)))
    cases["bad-mkv"] = (p, NVENC)
    p = str(d / "laced.mkv")
    write_mkv(p, clip.mkv_video(), lacing=True)
    cases["laced-block"] = (p, NVENC)
    p = str(d / "xvid.avi")
    write_avi(p, au, W, H, fourcc=b"XVID")
    cases["bad-fourcc"] = (p, NVENC)
    p = str(d / "vp9.webm")
    write_mkv(p, (b"", W, H, [(b"\x00" * 16, 0, True)]),
              video_codec="V_VP9")
    cases["webm-vp9"] = (p, NVENC)
    p = str(d / "copy.avi")
    write_avi(p, au, W, H, clip.pcm)
    cases["copy-avi"] = (p, BUILTIN_PRESETS["copy"])
    p = str(d / "silent.mkv")
    write_mkv(p, clip.mkv_video())
    cases["vn-without-audio"] = (p, "-vn -c:a aac -b:a 128k")
    # an avcC record cut after its fifth byte: the SPS count is missing
    p = str(d / "avcc.mkv")
    write_mkv(p, (avcc(clip.sps, clip.pps)[:5],) + clip.mkv_video()[1:])
    cases["truncated-avcc"] = (p, NVENC)
    cases["copy-truncated-avcc"] = (p, BUILTIN_PRESETS["copy"])
    # DefaultDuration sets the frame rate to 1e9 / duration, and the MP4
    # timescale (fps_num * 1000) then overflows mdhd's 32 bits
    p = str(d / "duration.mkv")
    write_mkv(p, clip.mkv_video(), default_duration_ns=33_333_333)
    cases["mkv-default-duration"] = (p, NVENC)
    return cases


@pytest.mark.parametrize("case", [
    "bad-mkv", "laced-block", "bad-fourcc", "webm-vp9", "copy-avi",
    "vn-without-audio", "truncated-avcc", "copy-truncated-avcc",
    "mkv-default-duration"])
def test_errors_match(clip, tmp_path, case):
    """Each of these fails in vcp_tpu; the port raises the same
    EncodeError text, chained to a cause of the same type."""
    path, args = _bad_inputs(tmp_path, clip)[case]
    out = str(tmp_path / "o.mp4")
    with pytest.raises(j_executor.EncodeError) as want:
        j_executor.execute(path, out, args)
    with pytest.raises(t_executor.EncodeError) as got:
        t_executor.execute(path, out, args, device="cpu")
    assert str(got.value) == str(want.value)
    assert type(got.value.__cause__).__name__ == \
        type(want.value.__cause__).__name__
