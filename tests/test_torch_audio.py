"""Audio of vcp_tpu_torch against vcp_tpu on the CPU, tolerance 0: the
AAC-LC encoder's access units (mono and stereo, 44.1 and 48 kHz, 96-192
kb/s, a short tail frame), the AAC decoder's PCM, the MP4 audio track
(with video, alone, with and without faststart), the WAV reader,
``audio_track_for`` on MP4 / MKV / WAV / AVI-PCM inputs under ``-c:a
copy`` and ``-c:a aac -b:a N``, and the ``-vn`` MP4."""

import dataclasses
import wave

import numpy as np
import pytest

from vcp_tpu.codec import aac as j_aac
from vcp_tpu.codec import aac_decode as j_dec
from vcp_tpu.codec import audio as j_audio
from vcp_tpu.codec import mp4 as j_mp4
from vcp_tpu.codec import wav as j_wav
from vcp_tpu.codec.args import parse_encode_args
from vcp_tpu.pipeline import executor as j_executor
from vcp_tpu_torch.codec import aac as t_aac
from vcp_tpu_torch.codec import aac_decode as t_dec
from vcp_tpu_torch.codec import aac_tables as t_tables
from vcp_tpu_torch.codec import audio as t_audio
from vcp_tpu_torch.codec import mp4 as t_mp4
from vcp_tpu_torch.codec import wav as t_wav
from vcp_tpu_torch.pipeline import executor as t_executor

from test_torch_containers import (RATE, avcc, two_tone, write_avi,
                                   write_mkv)

TAIL = 3 * 1024 + 300          # three whole frames and a short tail


def test_tables_equal():
    from vcp_tpu.codec import aac_tables as j_tables
    for name in ("SF_BITS", "SF_CODES", "SPECTRAL", "SWB_GROUP",
                 "SWB_OFFSET_1024", "RATE_TABLE"):
        assert getattr(t_tables, name) == getattr(j_tables, name), name


@pytest.mark.parametrize("bitrate", [96000, 128000, 192000])
@pytest.mark.parametrize("rate", [44100, 48000])
@pytest.mark.parametrize("channels", [1, 2])
def test_aac_encoder_identical(channels, rate, bitrate):
    """The same AUs, AudioSpecificConfig and ADTS stream as vcp_tpu's
    encoder; the tail frame is zero-padded in both."""
    pcm = two_tone(TAIL, channels, rate, seed=channels + rate)
    je = j_aac.AacEncoder(rate=rate, channels=channels, bitrate=bitrate)
    t = t_aac.AacEncoder(rate=rate, channels=channels, bitrate=bitrate)
    want = je.encode(pcm)
    got = t.encode(pcm)
    assert len(got) == 4 and got == want
    assert t.audio_specific_config() == je.audio_specific_config()
    assert t.adts_frame(got[0]) == je.adts_frame(want[0])
    np.testing.assert_array_equal(t_aac.mdct_basis(), j_aac.mdct_basis())
    spec = np.random.default_rng(rate).normal(0, 3000, 1024)
    for sf in (60, 100, 140):
        np.testing.assert_array_equal(t_aac.quantize(spec, sf),
                                      j_aac.quantize(spec, sf))


@pytest.mark.parametrize("channels", [1, 2])
def test_aac_decoder_identical(channels):
    """vcp_tpu's AUs decode to the same float PCM frame by frame, and its
    ADTS stream to the same int16 PCM and rate."""
    pcm = two_tone(6 * 1024, channels, 44100, seed=7)
    enc = j_aac.AacEncoder(rate=44100, channels=channels, bitrate=128000)
    aus = enc.encode(pcm)
    jd = j_dec.AacDecoder(rate=44100, channels=channels)
    td = t_dec.AacDecoder(rate=44100, channels=channels)
    for au in aus:
        np.testing.assert_array_equal(td.decode_frame(au),
                                      jd.decode_frame(au))
    adts = b"".join(enc.adts_frame(au) for au in aus)
    got, want = t_dec.decode_adts(adts), j_dec.decode_adts(adts)
    assert got[1] == want[1] == 44100
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (6 * 1024, channels)


def _video_track(mod):
    """Three fake video samples (only the muxer reads them)."""
    tr = mod.VideoTrack(codec="h264", width=64, height=48, timescale=30000,
                        sps=[b"\x67\x42\xc0\x1e\xab"], pps=[b"\x68\xce"])
    tr.samples = [mod.Sample(data=bytes([0, 0, 0, 2, 0x65, k]),
                             duration=1000, is_sync=k == 0)
                  for k in range(3)]
    return tr


def _audio_track(mod, aus, bitrate):
    tr = mod.AudioTrack(codec="aac", sample_rate=RATE, channels=2,
                        timescale=RATE, decoder_config=b"\x11\x90",
                        avg_bitrate=bitrate)
    tr.samples = [mod.Sample(data=a, duration=1024) for a in aus]
    return tr


@pytest.mark.parametrize("faststart", [True, False])
@pytest.mark.parametrize("layout", ["video+audio", "audio", "audio+video"])
def test_mux_audio_track_identical(tmp_path, layout, faststart):
    """The port's writer gives vcp_tpu's bytes for a video and an AAC
    track (esds with and without a bitrate, the movie duration taken
    over both tracks, per-track stco offsets), and for the AAC track
    alone."""
    aus = [bytes([0x21, k, 0x40] * (k + 1)) for k in range(50)]
    out = {}
    for mod in (j_mp4, t_mp4):
        w = mod.Mp4Writer()
        for kind in layout.split("+"):
            w.add_track(_video_track(mod) if kind == "video" else
                        _audio_track(mod, aus, 0 if faststart else 192000))
        out[mod] = str(tmp_path / f"{mod.__name__}.mp4")
        w.write(out[mod], faststart=faststart)
    with open(out[j_mp4], "rb") as a, open(out[t_mp4], "rb") as b:
        assert a.read() == b.read()
    d = t_mp4.Mp4Demuxer(out[t_mp4])
    assert [d.sample(d.audio, i) for i in range(50)] == aus
    assert d.audio.decoder_config == b"\x11\x90"


def _write_wav(path, pcm, rate=RATE, width=2):
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm.astype("<i2").tobytes() if width == 2 else
                      (pcm >> 8).astype(np.int8).tobytes())


def test_wav_reader_identical(tmp_path):
    pcm = two_tone(5000, 2)
    path = str(tmp_path / "a.wav")
    _write_wav(path, pcm)
    got, want = t_wav.read_wav(path), j_wav.read_wav(path)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], pcm)
    assert got[1] == want[1] == RATE
    assert t_wav.is_wav(path) and not t_wav.is_wav(str(tmp_path / "no.wav"))
    _write_wav(path, pcm, width=1)
    with pytest.raises(t_wav.WavError) as e:
        t_wav.read_wav(path)
    with pytest.raises(j_wav.WavError) as f:
        j_wav.read_wav(path)
    assert str(e.value) == str(f.value) == \
        "only 16-bit PCM supported (fmt=1, bits=8)"


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """{kind: path} of audio sources: an MP4 and an MKV each carrying a
    stereo AAC track of vcp_tpu's AUs (next to a video track), a WAV and
    an AVI of s16 stereo PCM."""
    d = tmp_path_factory.mktemp("audio")
    pcm = two_tone(5 * 1024 + 100, 2, seed=3)
    enc = j_aac.AacEncoder(rate=RATE, channels=2, bitrate=160000)
    aus = enc.encode(pcm)
    asc = enc.audio_specific_config()
    out = {k: str(d / f"in.{k}") for k in ("mp4", "mkv", "wav", "avi")}
    w = t_mp4.Mp4Writer()
    w.add_track(_video_track(t_mp4))
    tr = _audio_track(t_mp4, aus, 160000)
    tr.decoder_config = asc
    w.add_track(tr)
    w.write(out["mp4"])
    v = _video_track(t_mp4)
    write_mkv(out["mkv"], (avcc(v.sps[0], v.pps[0]), 64, 48,
                           [(s.data, 33 * k, s.is_sync)
                            for k, s in enumerate(v.samples)]),
              (asc, RATE, 2, [(a, 21 * k) for k, a in enumerate(aus)]))
    _write_wav(out["wav"], pcm)
    write_avi(out["avi"], [b"\x00\x00\x00\x01\x65\x00"] * 3, 64, 48, pcm)
    return out


def _track_fields(track):
    return None if track is None else dataclasses.asdict(track)


@pytest.mark.parametrize("args", ["-c:a copy", "-c:a aac", "-c:a aac -b:a 96k",
                                  "-c:a aac -b:a 192k"])
@pytest.mark.parametrize("kind", ["mp4", "mkv", "wav", "avi"])
def test_audio_track_for_identical(sources, kind, args):
    """Every field and AU of the track equals vcp_tpu's: AAC passed
    through (``copy``, or no bitrate), AAC decoded and encoded again at
    the bitrate, PCM encoded at the bitrate or 128 kb/s."""
    params = parse_encode_args("-c:v libx264 " + args)
    got = t_audio.audio_track_for(sources[kind], params)
    want = j_audio.audio_track_for(sources[kind], params)
    assert _track_fields(got) == _track_fields(want)
    assert got.samples and got.sample_rate == RATE and got.channels == 2
    assert got.avg_bitrate == (params.audio_bitrate if "-b:a" in args else
                               128000 if kind in ("wav", "avi") else 0)


def test_reencode_failure_passes_through(tmp_path):
    """An AAC track that the decoder rejects (a coupling channel
    element) is passed through unchanged by both packages, as vcp_tpu
    defines."""
    aus = [b"\x40\x00" for _ in range(3)]
    with pytest.raises(t_dec.AacDecodeError, match="coupling"):
        t_dec.AacDecoder(RATE, 2).decode_frame(aus[0])
    path = str(tmp_path / "bad.mp4")
    w = t_mp4.Mp4Writer()
    w.add_track(_audio_track(t_mp4, aus, 64000))
    w.write(path)
    params = parse_encode_args("-vn -c:a aac -b:a 128k")
    got = t_audio.audio_track_for(path, params)
    assert _track_fields(got) == \
        _track_fields(j_audio.audio_track_for(path, params))
    assert [s.data for s in got.samples] == aus


@pytest.mark.parametrize("kind", ["mp4", "mkv", "wav", "avi"])
def test_extract_audio_identical(sources, tmp_path, kind):
    """``-vn -c:a aac -b:a 128k`` through both executors: the same
    audio-only MP4, one ``soun`` track."""
    args = "-vn -c:a aac -b:a 128k"
    ref, out = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    n = t_executor.execute(sources[kind], out, args, device="cpu")
    assert n == j_executor.execute(sources[kind], ref, args)
    with open(ref, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
    assert [t.handler for t in t_mp4.Mp4Demuxer(out).tracks] == ["soun"]
    assert t_audio.extract_audio(sources[kind], ref,
                                 parse_encode_args(args)) == n
    with open(ref, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
