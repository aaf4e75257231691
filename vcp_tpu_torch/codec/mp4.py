"""MP4 (ISO BMFF) muxing of an H.264 or HEVC video track and an AAC-LC
audio track, and demuxing.

Copy of the writer half of ``vcp_tpu/codec/mp4.py``: :class:`Mp4Writer`
writes moov before mdat for ``-movflags +faststart``, one chunk per track,
with length-prefixed NAL samples, an avcC (``avc1``) or hvcC (``hvc1``)
sample entry and, for streams with B pictures, a ctts box of
composition-time offsets; an
:class:`AudioTrack` gets an mp4a sample entry with its esds descriptor
(AudioSpecificConfig, average bitrate), an smhd header and unit volume.
``iter_boxes`` / ``find_box`` walk a file's box tree; ``probe`` /
``probe_bytes`` read a file's tracks and ``verify_video_file`` is the
consumer's output check (the avc1 SPS against the container's
dimensions). And a copy of its
demuxer, :class:`Mp4Demuxer`, which the ingest of MP4 inputs and the
audio path read: every track's sample tables (stsc / stco / co64 / stsz /
stts / stss), the avcC / hvcC parameter sets and the AAC
AudioSpecificConfig of an mp4a track.
"""

from __future__ import annotations

import dataclasses
import io
import struct


class Mp4Error(ValueError):
    pass


def iter_boxes(buf: bytes, start: int = 0, end: int | None = None):
    """Yield (type, payload_start, payload_end) for each box in range."""
    end = len(buf) if end is None else end
    pos = start
    while pos + 8 <= end:
        size, = struct.unpack_from(">I", buf, pos)
        btype = buf[pos + 4:pos + 8]
        hdr = 8
        if size == 1:
            if pos + 16 > end:
                break
            size, = struct.unpack_from(">Q", buf, pos + 8)
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            break
        yield btype, pos + hdr, pos + size
        pos += size


def find_box(buf: bytes, path: list[bytes], start: int = 0,
             end: int | None = None) -> tuple[int, int] | None:
    """Find first box at a nested path; returns (payload_start, payload_end)."""
    end = len(buf) if end is None else end
    for btype, ps, pe in iter_boxes(buf, start, end):
        if btype == path[0]:
            if len(path) == 1:
                return ps, pe
            return find_box(buf, path[1:], ps, pe)
    return None


def box(btype: bytes, *payloads: bytes) -> bytes:
    body = b"".join(payloads)
    return struct.pack(">I", 8 + len(body)) + btype + body


def full_box(btype: bytes, version: int, flags: int, *payloads: bytes) -> bytes:
    return box(btype, struct.pack(">I", (version << 24) | flags), *payloads)


_MATRIX_IDENTITY = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                               0x40000000)


@dataclasses.dataclass
class TrackInfo:
    handler: str = ""        # "vide" | "soun" | ...
    codec: str = ""          # "avc1" | "hvc1" | "hev1" | "mp4a" | ...
    width: int = 0
    height: int = 0
    timescale: int = 0
    duration: int = 0
    sample_count: int = 0


def _parse_trak(buf: bytes, ps: int, pe: int) -> TrackInfo:
    t = TrackInfo()
    tkhd = find_box(buf, [b"tkhd"], ps, pe)
    if tkhd:
        v = buf[tkhd[0]]
        base = tkhd[0] + (4 + 8 * 4 + 16 + 36 if v == 1 else 4 + 5 * 4 + 16 + 36)
        if base + 8 <= tkhd[1]:
            w, h = struct.unpack_from(">II", buf, base)
            t.width, t.height = w >> 16, h >> 16
    mdia = find_box(buf, [b"mdia"], ps, pe)
    if not mdia:
        return t
    mdhd = find_box(buf, [b"mdhd"], mdia[0], mdia[1])
    if mdhd:
        v = buf[mdhd[0]]
        if v == 1:
            t.timescale, t.duration = struct.unpack_from(">IQ", buf, mdhd[0] + 20)
        else:
            t.timescale, t.duration = struct.unpack_from(">II", buf, mdhd[0] + 12)
    hdlr = find_box(buf, [b"hdlr"], mdia[0], mdia[1])
    if hdlr:
        t.handler = buf[hdlr[0] + 8:hdlr[0] + 12].decode("latin1")
    stbl = find_box(buf, [b"minf", b"stbl"], mdia[0], mdia[1])
    if stbl:
        stsd = find_box(buf, [b"stsd"], stbl[0], stbl[1])
        if stsd:
            for btype, _eps, _epe in iter_boxes(buf, stsd[0] + 8, stsd[1]):
                t.codec = btype.decode("latin1")
                break
        stsz = find_box(buf, [b"stsz"], stbl[0], stbl[1])
        if stsz:
            t.sample_count, = struct.unpack_from(">I", buf, stsz[0] + 8)
    return t


@dataclasses.dataclass
class ProbeResult:
    valid: bool = False
    brand: str = ""
    duration_sec: float = 0.0
    tracks: list[TrackInfo] = dataclasses.field(default_factory=list)
    faststart: bool = False   # moov precedes mdat

    @property
    def has_video(self) -> bool:
        return any(t.handler == "vide" for t in self.tracks)

    @property
    def video(self) -> TrackInfo | None:
        for t in self.tracks:
            if t.handler == "vide":
                return t
        return None


def probe_bytes(buf: bytes) -> ProbeResult:
    r = ProbeResult()
    moov_pos = mdat_pos = None
    for btype, ps, pe in iter_boxes(buf):
        if btype == b"ftyp":
            r.brand = buf[ps:ps + 4].decode("latin1", "replace")
        elif btype == b"moov":
            moov_pos = ps
            mvhd = find_box(buf, [b"mvhd"], ps, pe)
            if mvhd:
                v = buf[mvhd[0]]
                if v == 1:
                    ts, dur = struct.unpack_from(">IQ", buf, mvhd[0] + 20)
                else:
                    ts, dur = struct.unpack_from(">II", buf, mvhd[0] + 12)
                if ts:
                    r.duration_sec = dur / ts
            for btype2, tps, tpe in iter_boxes(buf, ps, pe):
                if btype2 == b"trak":
                    r.tracks.append(_parse_trak(buf, tps, tpe))
        elif btype == b"mdat":
            mdat_pos = ps
    r.valid = moov_pos is not None and bool(r.tracks)
    if moov_pos is not None and mdat_pos is not None:
        r.faststart = moov_pos < mdat_pos
    return r


def probe(path: str) -> ProbeResult:
    with open(path, "rb") as fh:
        return probe_bytes(fh.read())


def verify_video_file(path: str) -> tuple[bool, str]:
    """The consumer's output verification (in place of an ffprobe run):
    the file is non-empty and holds a video stream; for an H.264 track
    the codec config (avcC + SPS) must parse and agree with the container
    dimensions, and the track must have samples. Returns (ok, reason)."""
    import os
    try:
        if os.path.getsize(path) == 0:
            return False, "output file is empty"
    except OSError as e:
        return False, f"stat failed: {e}"
    try:
        r = probe(path)
    except Exception as e:  # malformed container
        return False, f"probe failed: {e}"
    if not r.valid:
        return False, "no moov/tracks found"
    if not r.has_video:
        return False, "no video stream"
    v = r.video
    if v.codec == "avc1":
        try:
            demux = Mp4Demuxer(path)
            t = demux.video
            if not t.sps or not t.pps:
                return False, "avc1 track missing SPS/PPS"
            from .h264 import headers as _h
            from ..utils.bitstream import emulation_remove
            sp = _h.parse_sps(emulation_remove(t.sps[0][1:]))
            if (sp.width, sp.height) != (t.width, t.height) and t.width:
                return False, (f"SPS dims {sp.width}x{sp.height} != "
                               f"container {t.width}x{t.height}")
            if t.sample_count == 0:
                return False, "video track has no samples"
        except Exception as e:
            return False, f"codec config invalid: {e}"
    return True, ""


@dataclasses.dataclass
class Sample:
    data: bytes              # length-prefixed NALs (video) or one AAC AU
    duration: int            # in track timescale units
    is_sync: bool = True
    cts_offset: int = 0      # composition-time offset (B pictures)


@dataclasses.dataclass
class VideoTrack:
    codec: str               # "h264" | "h265"
    width: int
    height: int
    timescale: int           # e.g. 90000 or fps*1000
    sps: list[bytes] = dataclasses.field(default_factory=list)
    pps: list[bytes] = dataclasses.field(default_factory=list)
    vps: list[bytes] = dataclasses.field(default_factory=list)  # h265
    samples: list[Sample] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class AudioTrack:
    codec: str               # "aac"
    sample_rate: int
    channels: int
    timescale: int           # == sample_rate
    decoder_config: bytes = b""   # AudioSpecificConfig
    avg_bitrate: int = 0
    samples: list[Sample] = dataclasses.field(default_factory=list)


def _avcc_box(tr: VideoTrack) -> bytes:
    if not tr.sps or not tr.pps:
        raise Mp4Error("h264 track requires SPS and PPS")
    sps0 = tr.sps[0]
    cfg = io.BytesIO()
    cfg.write(struct.pack(">BBBBB", 1, sps0[1], sps0[2], sps0[3], 0xFF))
    cfg.write(struct.pack(">B", 0xE0 | len(tr.sps)))
    for sps in tr.sps:
        cfg.write(struct.pack(">H", len(sps)) + sps)
    cfg.write(struct.pack(">B", len(tr.pps)))
    for pps in tr.pps:
        cfg.write(struct.pack(">H", len(pps)) + pps)
    return box(b"avcC", cfg.getvalue())


def _esds_box(tr: AudioTrack) -> bytes:
    dcfg = tr.decoder_config

    def desc(tag: int, payload: bytes) -> bytes:
        # 4-byte expandable length encoding
        n = len(payload)
        size = bytes([(n >> 21) & 0x7F | 0x80, (n >> 14) & 0x7F | 0x80,
                      (n >> 7) & 0x7F | 0x80, n & 0x7F])
        return bytes([tag]) + size + payload

    dec_specific = desc(0x05, dcfg)
    dec_config = desc(0x04, struct.pack(">BBBHII", 0x40, 0x15, 0, 0,
                                        tr.avg_bitrate or 128000,
                                        tr.avg_bitrate or 128000)
                      + dec_specific)
    sl_config = desc(0x06, b"\x02")
    es = desc(0x03, struct.pack(">HB", 1, 0) + dec_config + sl_config)
    return full_box(b"esds", 0, 0, es)


def _hvcc_box(tr: VideoTrack) -> bytes:
    """Minimal hvcC: general fields lifted from the SPS by the caller are
    not re-parsed here; conservative defaults are used."""
    cfg = io.BytesIO()
    cfg.write(bytes([
        1,                  # configurationVersion
        0x01,               # profile_space/tier/profile_idc (Main)
        0x60, 0x00, 0x00, 0x00,  # profile_compatibility_flags
        0x90, 0x00, 0x00, 0x00, 0x00, 0x00,  # constraint flags
        0x5D,               # level_idc (93 = L3.1)
        0xF0, 0x00,         # min_spatial_segmentation
        0xFC,               # parallelismType
        0xFD,               # chromaFormat 4:2:0
        0xF8,               # bitDepthLuma - 8
        0xF8,               # bitDepthChroma - 8
        0x00, 0x00,         # avgFrameRate
        0x0F,               # constantFrameRate/numTemporalLayers/lengthSize=4
    ]))
    arrays = [(32, tr.vps), (33, tr.sps), (34, tr.pps)]
    arrays = [(t, lst) for t, lst in arrays if lst]
    cfg.write(struct.pack(">B", len(arrays)))
    for nal_type, lst in arrays:
        cfg.write(struct.pack(">BH", 0x80 | nal_type, len(lst)))
        for nal in lst:
            cfg.write(struct.pack(">H", len(nal)) + nal)
    return box(b"hvcC", cfg.getvalue())


def _sample_entry(tr) -> bytes:
    if isinstance(tr, VideoTrack):
        fourcc = b"avc1" if tr.codec == "h264" else b"hvc1"
        cfg = _avcc_box(tr) if tr.codec == "h264" else _hvcc_box(tr)
        body = (b"\x00" * 6 + struct.pack(">H", 1)      # reserved + dref idx
                + b"\x00" * 16
                + struct.pack(">HH", tr.width, tr.height)
                + struct.pack(">II", 0x480000, 0x480000)  # 72 dpi
                + b"\x00" * 4
                + struct.pack(">H", 1)                   # frame count
                + b"\x00" * 32                           # compressor name
                + struct.pack(">Hh", 0x18, -1))          # depth, color table
        return box(fourcc, body + cfg)
    body = (b"\x00" * 6 + struct.pack(">H", 1)
            + b"\x00" * 8
            + struct.pack(">HH", tr.channels, 16)
            + b"\x00" * 4
            + struct.pack(">I", tr.sample_rate << 16))
    return box(b"mp4a", body + _esds_box(tr))


def _stts(samples: list[Sample]) -> bytes:
    runs: list[tuple[int, int]] = []
    for s in samples:
        if runs and runs[-1][1] == s.duration:
            runs[-1] = (runs[-1][0] + 1, s.duration)
        else:
            runs.append((1, s.duration))
    body = struct.pack(">I", len(runs)) + b"".join(
        struct.pack(">II", c, d) for c, d in runs)
    return full_box(b"stts", 0, 0, body)


def _stbl(tr, chunk_offsets: list[int]) -> bytes:
    samples = tr.samples
    stsd = full_box(b"stsd", 0, 0, struct.pack(">I", 1), _sample_entry(tr))
    stts = _stts(samples)
    parts = [stsd, stts]
    syncs = [i + 1 for i, s in enumerate(samples) if s.is_sync]
    if len(syncs) != len(samples):
        parts.append(full_box(b"stss", 0, 0,
                              struct.pack(">I", len(syncs))
                              + b"".join(struct.pack(">I", i) for i in syncs)))
    if any(s.cts_offset for s in samples):
        runs: list[tuple[int, int]] = []
        for s in samples:
            if runs and runs[-1][1] == s.cts_offset:
                runs[-1] = (runs[-1][0] + 1, s.cts_offset)
            else:
                runs.append((1, s.cts_offset))
        parts.append(full_box(b"ctts", 0, 0,
                              struct.pack(">I", len(runs))
                              + b"".join(struct.pack(">II", c, o)
                                         for c, o in runs)))
    # one chunk holding all samples of this track
    parts.append(full_box(b"stsc", 0, 0,
                          struct.pack(">IIII", 1, 1, len(samples), 1)))
    parts.append(full_box(b"stsz", 0, 0,
                          struct.pack(">II", 0, len(samples))
                          + b"".join(struct.pack(">I", len(s.data))
                                     for s in samples)))
    parts.append(full_box(b"stco", 0, 0,
                          struct.pack(">I", len(chunk_offsets))
                          + b"".join(struct.pack(">I", o)
                                     for o in chunk_offsets)))
    return box(b"stbl", *parts)


def _trak(tr, track_id: int, movie_timescale: int,
          chunk_offsets: list[int]) -> bytes:
    dur_ts = sum(s.duration for s in tr.samples)
    dur_movie = int(round(dur_ts * movie_timescale / max(1, tr.timescale)))
    is_video = isinstance(tr, VideoTrack)
    w = (tr.width << 16) if is_video else 0
    h = (tr.height << 16) if is_video else 0
    volume = 0 if is_video else 0x0100
    tkhd = full_box(b"tkhd", 0, 7,
                    struct.pack(">IIIII", 0, 0, track_id, 0, dur_movie),
                    b"\x00" * 8,
                    struct.pack(">HHHH", 0, 0, volume, 0),
                    _MATRIX_IDENTITY,
                    struct.pack(">II", w, h))
    mdhd = full_box(b"mdhd", 0, 0,
                    struct.pack(">IIII", 0, 0, tr.timescale, dur_ts),
                    struct.pack(">HH", 0x55C4, 0))  # 'und'
    handler = b"vide" if is_video else b"soun"
    name = b"VideoHandler\x00" if is_video else b"SoundHandler\x00"
    hdlr = full_box(b"hdlr", 0, 0, b"\x00" * 4, handler, b"\x00" * 12, name)
    mhd = (full_box(b"vmhd", 0, 1, b"\x00" * 8) if is_video
           else full_box(b"smhd", 0, 0, b"\x00" * 4))
    dinf = box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                 full_box(b"url ", 0, 1)))
    minf = box(b"minf", mhd, dinf, _stbl(tr, chunk_offsets))
    mdia = box(b"mdia", mdhd, hdlr, minf)
    return box(b"trak", tkhd, mdia)


class Mp4Writer:
    """Collects tracks + samples, then writes a complete MP4.

    ``faststart=True`` places moov before mdat (the semantic of
    ``-movflags +faststart``, present in every reference preset,
    ref config.go:44-51); chunk offsets are computed by sizing moov with
    placeholder offsets first (stco entries are fixed-width, so the size
    is stable).
    """

    MOVIE_TIMESCALE = 1000

    def __init__(self):
        self.tracks: list = []

    def add_track(self, track) -> None:
        self.tracks.append(track)

    def _moov(self, chunk_offsets_per_track: list[list[int]]) -> bytes:
        if not self.tracks:
            raise Mp4Error("no tracks")
        dur = 0
        for tr in self.tracks:
            ts = sum(s.duration for s in tr.samples)
            dur = max(dur, int(round(ts * self.MOVIE_TIMESCALE
                                     / max(1, tr.timescale))))
        mvhd = full_box(b"mvhd", 0, 0,
                        struct.pack(">IIII", 0, 0, self.MOVIE_TIMESCALE, dur),
                        struct.pack(">IHH", 0x00010000, 0x0100, 0),
                        b"\x00" * 8,
                        _MATRIX_IDENTITY,
                        b"\x00" * 24,
                        struct.pack(">I", len(self.tracks) + 1))
        traks = [_trak(tr, i + 1, self.MOVIE_TIMESCALE, offs)
                 for i, (tr, offs) in
                 enumerate(zip(self.tracks, chunk_offsets_per_track))]
        return box(b"moov", mvhd, *traks)

    def write(self, path: str, faststart: bool = True) -> None:
        ftyp = box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                   b"isomiso2avc1mp41")
        track_blobs = [b"".join(s.data for s in tr.samples)
                       for tr in self.tracks]
        mdat_payload = b"".join(track_blobs)
        placeholder = [[0] for _ in self.tracks]
        moov_size = len(self._moov(placeholder))

        if faststart:
            mdat_start = len(ftyp) + moov_size + 8
        else:
            mdat_start = len(ftyp) + 8

        offsets: list[list[int]] = []
        pos = mdat_start
        for blob in track_blobs:
            offsets.append([pos])
            pos += len(blob)
        moov = self._moov(offsets)
        assert len(moov) == moov_size, "moov size must be offset-independent"
        mdat = box(b"mdat", mdat_payload)

        with open(path, "wb") as fh:
            if faststart:
                fh.write(ftyp + moov + mdat)
            else:
                fh.write(ftyp + mdat + moov)


# ---------------------------------------------------------------------------
# Demuxing (full sample tables)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DemuxedTrack:
    handler: str
    codec: str
    timescale: int
    width: int = 0
    height: int = 0
    sps: list[bytes] = dataclasses.field(default_factory=list)
    pps: list[bytes] = dataclasses.field(default_factory=list)
    vps: list[bytes] = dataclasses.field(default_factory=list)  # hevc
    nal_length_size: int = 4
    # audio (mp4a)
    sample_rate: int = 0
    channels: int = 0
    decoder_config: bytes = b""     # AudioSpecificConfig from esds
    sample_offsets: list[int] = dataclasses.field(default_factory=list)
    sample_sizes: list[int] = dataclasses.field(default_factory=list)
    sample_durations: list[int] = dataclasses.field(default_factory=list)
    sync_samples: set[int] = dataclasses.field(default_factory=set)  # 0-based

    @property
    def sample_count(self) -> int:
        return len(self.sample_sizes)


def parse_avcc(avcc: bytes) -> tuple[int, list[bytes], list[bytes]]:
    """(NAL length size, SPS list, PPS list) of an avcC record, the H.264
    decoder configuration of MP4 and Matroska tracks."""
    nal_length_size = (avcc[4] & 3) + 1
    sps, pps = [], []
    off = 6
    for _ in range(avcc[5] & 0x1F):
        ln, = struct.unpack_from(">H", avcc, off)
        sps.append(avcc[off + 2:off + 2 + ln])
        off += 2 + ln
    n_pps = avcc[off]
    off += 1
    for _ in range(n_pps):
        ln, = struct.unpack_from(">H", avcc, off)
        pps.append(avcc[off + 2:off + 2 + ln])
        off += 2 + ln
    return nal_length_size, sps, pps


def _parse_esds_asc(es: bytes) -> bytes:
    """Walk the ES descriptor tree and return the AudioSpecificConfig
    (DecSpecificInfo, tag 0x05)."""
    def read_len(pos):
        n = 0
        for _ in range(4):
            b = es[pos]
            pos += 1
            n = (n << 7) | (b & 0x7F)
            if not b & 0x80:
                break
        return n, pos

    pos = 0
    while pos < len(es):
        tag = es[pos]
        ln, body = read_len(pos + 1)
        if tag == 0x05:
            return es[body:body + ln]
        if tag == 0x03:           # ES_Descriptor: skip ES_ID + flags
            pos = body + 3
        elif tag == 0x04:         # DecoderConfig: skip 13 fixed bytes
            pos = body + 13
        else:
            pos = body + ln
    return b""


class Mp4Demuxer:
    """Parses moov sample tables; yields per-sample payloads.
    stsc/stco/stsz/stts/stss are walked natively. H.264 samples are
    length-prefixed NALs (avcC layout)."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            self.buf = fh.read()
        self.tracks: list[DemuxedTrack] = []
        moov = find_box(self.buf, [b"moov"])
        if moov is None:
            raise Mp4Error("no moov box")
        for btype, ps, pe in iter_boxes(self.buf, moov[0], moov[1]):
            if btype == b"trak":
                t = self._parse_track(ps, pe)
                if t is not None:
                    self.tracks.append(t)

    @property
    def video(self) -> DemuxedTrack | None:
        for t in self.tracks:
            if t.handler == "vide":
                return t
        return None

    @property
    def audio(self) -> DemuxedTrack | None:
        for t in self.tracks:
            if t.handler == "soun":
                return t
        return None

    def _parse_track(self, ps: int, pe: int) -> DemuxedTrack | None:
        buf = self.buf
        info = _parse_trak(buf, ps, pe)
        mdia = find_box(buf, [b"mdia"], ps, pe)
        if not mdia:
            return None
        stbl = find_box(buf, [b"minf", b"stbl"], mdia[0], mdia[1])
        if not stbl:
            return None
        t = DemuxedTrack(handler=info.handler, codec=info.codec,
                         timescale=info.timescale, width=info.width,
                         height=info.height)

        stsd = find_box(buf, [b"stsd"], stbl[0], stbl[1])
        if stsd and info.codec == "avc1":
            for btype, eps, epe in iter_boxes(buf, stsd[0] + 8, stsd[1]):
                if btype == b"avc1":
                    avcc = find_box(buf, [b"avcC"], eps + 78, epe)
                    if avcc:
                        (t.nal_length_size, t.sps,
                         t.pps) = parse_avcc(buf[avcc[0]:avcc[1]])
        elif stsd and info.codec in ("hvc1", "hev1"):
            for btype, eps, epe in iter_boxes(buf, stsd[0] + 8, stsd[1]):
                if btype in (b"hvc1", b"hev1"):
                    hvcc = find_box(buf, [b"hvcC"], eps + 78, epe)
                    if hvcc:
                        self._parse_hvcc(buf[hvcc[0]:hvcc[1]], t)
        elif stsd and info.codec == "mp4a":
            for btype, eps, epe in iter_boxes(buf, stsd[0] + 8, stsd[1]):
                if btype == b"mp4a":
                    t.channels, = struct.unpack_from(">H", buf, eps + 16)
                    t.sample_rate = struct.unpack_from(
                        ">I", buf, eps + 24)[0] >> 16
                    esds = find_box(buf, [b"esds"], eps + 28, epe)
                    if esds:
                        t.decoder_config = _parse_esds_asc(
                            buf[esds[0] + 4:esds[1]])

        # sample sizes
        stsz = find_box(buf, [b"stsz"], stbl[0], stbl[1])
        if not stsz:
            return None
        fixed, count = struct.unpack_from(">II", buf, stsz[0] + 4)
        if fixed:
            t.sample_sizes = [fixed] * count
        else:
            t.sample_sizes = list(struct.unpack_from(
                f">{count}I", buf, stsz[0] + 12))

        # chunk offsets
        stco = find_box(buf, [b"stco"], stbl[0], stbl[1])
        co64 = find_box(buf, [b"co64"], stbl[0], stbl[1])
        if stco:
            n, = struct.unpack_from(">I", buf, stco[0] + 4)
            chunk_offsets = list(struct.unpack_from(
                f">{n}I", buf, stco[0] + 8))
        elif co64:
            n, = struct.unpack_from(">I", buf, co64[0] + 4)
            chunk_offsets = list(struct.unpack_from(
                f">{n}Q", buf, co64[0] + 8))
        else:
            return None

        # sample-to-chunk
        stsc = find_box(buf, [b"stsc"], stbl[0], stbl[1])
        n, = struct.unpack_from(">I", buf, stsc[0] + 4)
        runs = [struct.unpack_from(">III", buf, stsc[0] + 8 + 12 * i)
                for i in range(n)]
        # expand to per-sample offsets
        sample = 0
        for ri, (first_chunk, per_chunk, _desc) in enumerate(runs):
            last_chunk = (runs[ri + 1][0] - 1 if ri + 1 < len(runs)
                          else len(chunk_offsets))
            for chunk in range(first_chunk, last_chunk + 1):
                pos = chunk_offsets[chunk - 1]
                for _ in range(per_chunk):
                    if sample >= count:
                        break
                    t.sample_offsets.append(pos)
                    pos += t.sample_sizes[sample]
                    sample += 1

        # durations
        stts = find_box(buf, [b"stts"], stbl[0], stbl[1])
        if stts:
            n, = struct.unpack_from(">I", buf, stts[0] + 4)
            for i in range(n):
                cnt, dur = struct.unpack_from(">II", buf, stts[0] + 8 + 8 * i)
                t.sample_durations += [dur] * cnt

        # sync table (absent = all sync)
        stss = find_box(buf, [b"stss"], stbl[0], stbl[1])
        if stss:
            n, = struct.unpack_from(">I", buf, stss[0] + 4)
            t.sync_samples = {
                struct.unpack_from(">I", buf, stss[0] + 8 + 4 * i)[0] - 1
                for i in range(n)}
        else:
            t.sync_samples = set(range(count))
        return t

    @staticmethod
    def _parse_hvcc(hvcc: bytes, t: DemuxedTrack) -> None:
        """hvcC (ISO 14496-15 8.3.3.1): 22 fixed bytes, then NAL arrays
        keyed by type (32=VPS, 33=SPS, 34=PPS)."""
        t.nal_length_size = (hvcc[21] & 3) + 1
        n_arrays = hvcc[22]
        off = 23
        dest = {32: t.vps, 33: t.sps, 34: t.pps}
        for _ in range(n_arrays):
            nal_type = hvcc[off] & 0x3F
            n_nalus, = struct.unpack_from(">H", hvcc, off + 1)
            off += 3
            for _ in range(n_nalus):
                ln, = struct.unpack_from(">H", hvcc, off)
                nal = hvcc[off + 2:off + 2 + ln]
                if nal_type in dest:
                    dest[nal_type].append(nal)
                off += 2 + ln

    def sample(self, track: DemuxedTrack, i: int) -> bytes:
        off = track.sample_offsets[i]
        return self.buf[off:off + track.sample_sizes[i]]

    def sample_nals(self, track: DemuxedTrack, i: int) -> list[bytes]:
        """Split a length-prefixed H.264 sample into raw NAL units."""
        data = self.sample(track, i)
        ls = track.nal_length_size
        nals = []
        pos = 0
        while pos + ls <= len(data):
            n = int.from_bytes(data[pos:pos + ls], "big")
            nals.append(data[pos + ls:pos + ls + n])
            pos += ls + n
        return nals


def annexb_to_length_prefixed(annexb: bytes) -> bytes:
    """Convert an Annex-B access unit (00 00 01 start codes) to 4-byte
    length-prefixed NALs for MP4 samples."""
    nals = split_annexb(annexb)
    return b"".join(struct.pack(">I", len(n)) + n for n in nals)


def split_annexb(annexb: bytes) -> list[bytes]:
    """Split an Annex-B stream into raw NAL units (start codes stripped)."""
    nals = []
    i = 0
    n = len(annexb)
    # find first start code
    starts = []
    while i < n - 2:
        if annexb[i] == 0 and annexb[i + 1] == 0:
            if annexb[i + 2] == 1:
                starts.append((i, i + 3))
                i += 3
                continue
            if i < n - 3 and annexb[i + 2] == 0 and annexb[i + 3] == 1:
                starts.append((i, i + 4))
                i += 4
                continue
        i += 1
    for k, (sc_pos, payload_start) in enumerate(starts):
        end = starts[k + 1][0] if k + 1 < len(starts) else n
        nal = annexb[payload_start:end]
        # Strip trailing zero padding preceding the next start code. A NAL's
        # last byte is never 0x00 (rbsp stop bit) absent cabac_zero_words,
        # which this codebase never emits.
        nal = nal.rstrip(b"\x00")
        if nal:
            nals.append(nal)
    return nals
