"""Matroska / WebM (EBML) demuxer, and the remux of an H.264 track into
MP4.

Copy of ``vcp_tpu/codec/mkv.py``. :class:`MkvDemuxer` walks the EBML
tree (Segment -> Info / Tracks / Cluster -> SimpleBlock / BlockGroup)
and collects the first video and the first audio track: codec id, codec
private data (avcC for V_MPEG4/ISO/AVC, the AudioSpecificConfig for
A_AAC), and per-block payloads with timestamps and keyframe flags.
Laced blocks raise. :func:`remux_to_mp4` is ``-c copy`` for Matroska
inputs: the H.264 blocks and the AAC frames, unchanged, into an MP4.
Both sort a track's blocks by block timestamp, as ``vcp_tpu`` does.
"""

from __future__ import annotations

import dataclasses
import struct


class MkvError(ValueError):
    pass


# EBML element IDs (with leading length-descriptor bits, as read)
EBML_HEADER = 0x1A45DFA3
SEGMENT = 0x18538067
INFO = 0x1549A966
TIMESTAMP_SCALE = 0x2AD7B1
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
TRACK_TYPE = 0x83
CODEC_ID = 0x86
CODEC_PRIVATE = 0x63A2
VIDEO = 0xE0
AUDIO = 0xE1
SAMPLING_FREQUENCY = 0xB5
CHANNELS = 0x9F
PIXEL_WIDTH = 0xB0
PIXEL_HEIGHT = 0xBA
DEFAULT_DURATION = 0x23E383
CLUSTER = 0x1F43B675
CLUSTER_TIMESTAMP = 0xE7
SIMPLE_BLOCK = 0xA3
BLOCK_GROUP = 0xA0
BLOCK = 0xA1


def _read_vint(buf: bytes, pos: int, keep_marker: bool) -> tuple[int, int]:
    """EBML variable-size integer → (value, new_pos)."""
    if pos >= len(buf):
        raise MkvError("truncated vint")
    first = buf[pos]
    if first == 0:
        raise MkvError("invalid vint")
    length = 9 - first.bit_length()
    if pos + length > len(buf):
        raise MkvError("truncated vint body")
    value = first if keep_marker else first & ((1 << (8 - length)) - 1)
    for i in range(1, length):
        value = (value << 8) | buf[pos + i]
    return value, pos + length


def _read_uint(data: bytes) -> int:
    v = 0
    for b in data:
        v = (v << 8) | b
    return v


def iter_elements(buf: bytes, pos: int, end: int):
    """Yield (element_id, payload_start, payload_end)."""
    while pos < end:
        eid, pos = _read_vint(buf, pos, keep_marker=True)
        size, pos = _read_vint(buf, pos, keep_marker=False)
        if size == (1 << 56) - 1:       # unknown size: scan to container end
            yield eid, pos, end
            return
        yield eid, pos, min(pos + size, end)
        pos += size


@dataclasses.dataclass
class MkvSample:
    data: bytes            # length-prefixed NALs (as stored for AVC)
    timestamp_ns: int
    keyframe: bool


@dataclasses.dataclass
class MkvVideoTrack:
    number: int = 0
    codec_id: str = ""
    codec_private: bytes = b""    # avcC for V_MPEG4/ISO/AVC
    width: int = 0
    height: int = 0
    default_duration_ns: int = 0
    samples: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MkvAudioTrack:
    number: int = 0
    codec_id: str = ""
    codec_private: bytes = b""    # AudioSpecificConfig for A_AAC
    sample_rate: int = 0
    channels: int = 0
    samples: list = dataclasses.field(default_factory=list)


class MkvDemuxer:
    def __init__(self, path: str):
        with open(path, "rb") as fh:
            self.buf = fh.read()
        self.timestamp_scale = 1_000_000   # ns per cluster tick (default)
        self.video: MkvVideoTrack | None = None
        self.audio: MkvAudioTrack | None = None
        self._parse()

    def _parse(self) -> None:
        buf = self.buf
        top = list(iter_elements(buf, 0, len(buf)))
        if not top or top[0][0] != EBML_HEADER:
            raise MkvError("not an EBML/Matroska file")
        seg = next(((s, e) for i, s, e in top if i == SEGMENT), None)
        if seg is None:
            raise MkvError("no Segment")
        for eid, ps, pe in iter_elements(buf, seg[0], seg[1]):
            if eid == INFO:
                for i2, s2, e2 in iter_elements(buf, ps, pe):
                    if i2 == TIMESTAMP_SCALE:
                        self.timestamp_scale = _read_uint(buf[s2:e2])
            elif eid == TRACKS:
                self._parse_tracks(ps, pe)
            elif eid == CLUSTER:
                self._parse_cluster(ps, pe)

    def _parse_tracks(self, ps: int, pe: int) -> None:
        buf = self.buf
        for eid, s, e in iter_elements(buf, ps, pe):
            if eid != TRACK_ENTRY:
                continue
            t = MkvVideoTrack()
            a = MkvAudioTrack()
            track_type = 0
            for i2, s2, e2 in iter_elements(buf, s, e):
                if i2 == TRACK_NUMBER:
                    t.number = a.number = _read_uint(buf[s2:e2])
                elif i2 == TRACK_TYPE:
                    track_type = _read_uint(buf[s2:e2])
                elif i2 == CODEC_ID:
                    t.codec_id = a.codec_id = \
                        buf[s2:e2].decode("latin1").rstrip("\x00")
                elif i2 == CODEC_PRIVATE:
                    t.codec_private = a.codec_private = buf[s2:e2]
                elif i2 == DEFAULT_DURATION:
                    t.default_duration_ns = _read_uint(buf[s2:e2])
                elif i2 == VIDEO:
                    for i3, s3, e3 in iter_elements(buf, s2, e2):
                        if i3 == PIXEL_WIDTH:
                            t.width = _read_uint(buf[s3:e3])
                        elif i3 == PIXEL_HEIGHT:
                            t.height = _read_uint(buf[s3:e3])
                elif i2 == AUDIO:
                    for i3, s3, e3 in iter_elements(buf, s2, e2):
                        if i3 == SAMPLING_FREQUENCY:
                            raw = buf[s3:e3]
                            fmt = ">f" if len(raw) == 4 else ">d"
                            a.sample_rate = int(struct.unpack(fmt, raw)[0])
                        elif i3 == CHANNELS:
                            a.channels = _read_uint(buf[s3:e3])
            if track_type == 1 and self.video is None:
                self.video = t
            elif track_type == 2 and self.audio is None:
                self.audio = a

    def _parse_cluster(self, ps: int, pe: int) -> None:
        if self.video is None and self.audio is None:
            return
        buf = self.buf
        cluster_ts = 0
        for eid, s, e in iter_elements(buf, ps, pe):
            if eid == CLUSTER_TIMESTAMP:
                cluster_ts = _read_uint(buf[s:e])
            elif eid == SIMPLE_BLOCK:
                self._parse_block(s, e, cluster_ts, simple=True)
            elif eid == BLOCK_GROUP:
                for i2, s2, e2 in iter_elements(buf, s, e):
                    if i2 == BLOCK:
                        self._parse_block(s2, e2, cluster_ts, simple=False)

    def _parse_block(self, s: int, e: int, cluster_ts: int,
                     simple: bool) -> None:
        buf = self.buf
        track, pos = _read_vint(buf, s, keep_marker=False)
        dest = None
        if self.video is not None and track == self.video.number:
            dest = self.video
        elif self.audio is not None and track == self.audio.number:
            dest = self.audio
        if dest is None:
            return
        if pos + 3 > e:
            raise MkvError("truncated block header")
        rel_ts = struct.unpack_from(">h", buf, pos)[0]
        flags = buf[pos + 2]
        pos += 3
        lacing = (flags >> 1) & 3
        if lacing != 0:
            raise MkvError("laced blocks unsupported")
        keyframe = bool(flags & 0x80) if simple else True
        ts_ns = (cluster_ts + rel_ts) * self.timestamp_scale
        dest.samples.append(
            MkvSample(data=buf[pos:e], timestamp_ns=ts_ns,
                      keyframe=keyframe))


def remux_to_mp4(input_path: str, output_path: str,
                 faststart: bool = True) -> int:
    """Stream-copy an MKV's H.264 track into MP4 (``-c copy`` semantics
    for non-BMFF inputs). Returns output size."""
    import os

    from . import mp4 as m

    demux = MkvDemuxer(input_path)
    t = demux.video
    if t is None:
        raise MkvError("no video track")
    if t.codec_id != "V_MPEG4/ISO/AVC":
        raise MkvError(f"unsupported codec for remux: {t.codec_id!r}")
    if not t.codec_private or t.codec_private[0] != 1:
        raise MkvError("missing/invalid avcC codec private data")

    _, sps, pps = m.parse_avcc(t.codec_private)

    timescale = 90_000
    track = m.VideoTrack(codec="h264", width=t.width, height=t.height,
                         timescale=timescale, sps=sps, pps=pps)
    samples = sorted(t.samples, key=lambda x: x.timestamp_ns)
    for i, smp in enumerate(samples):
        if i + 1 < len(samples):
            dur_ns = samples[i + 1].timestamp_ns - smp.timestamp_ns
        else:
            dur_ns = t.default_duration_ns or (
                samples[1].timestamp_ns - samples[0].timestamp_ns
                if len(samples) > 1 else 33_333_333)
        dur = max(1, int(round(dur_ns * timescale / 1e9)))
        track.samples.append(m.Sample(data=smp.data, duration=dur,
                                      is_sync=smp.keyframe))
    w = m.Mp4Writer()
    w.add_track(track)

    # AAC audio passthrough (byte-exact; -c copy covers all tracks)
    a = demux.audio
    if a is not None and a.codec_id.startswith("A_AAC") and a.samples:
        rate = a.sample_rate or 48000
        atr = m.AudioTrack(codec="aac", sample_rate=rate,
                           channels=a.channels or 2, timescale=rate,
                           decoder_config=a.codec_private)
        for smp in sorted(a.samples, key=lambda x: x.timestamp_ns):
            atr.samples.append(m.Sample(data=smp.data, duration=1024,
                                        is_sync=True))
        w.add_track(atr)

    w.write(output_path, faststart=faststart)
    return os.path.getsize(output_path)
