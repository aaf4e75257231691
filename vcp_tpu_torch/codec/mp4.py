"""MP4 (ISO BMFF) muxing of one H.264 video track, plus the box reader.

Copy of the writer half of ``vcp_tpu/codec/mp4.py`` (video only):
:class:`Mp4Writer` writes moov before mdat for ``-movflags +faststart``,
with length-prefixed NAL samples, an avcC sample entry and, for streams
with B pictures, a ctts box of composition-time offsets. ``iter_boxes``
/ ``find_box`` walk a written file's box tree.
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
class Sample:
    data: bytes              # length-prefixed NALs
    duration: int            # in track timescale units
    is_sync: bool = True
    cts_offset: int = 0      # composition-time offset (B pictures)


@dataclasses.dataclass
class VideoTrack:
    codec: str               # "h264"
    width: int
    height: int
    timescale: int           # e.g. 90000 or fps*1000
    sps: list[bytes] = dataclasses.field(default_factory=list)
    pps: list[bytes] = dataclasses.field(default_factory=list)
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


def _sample_entry(tr: VideoTrack) -> bytes:
    body = (b"\x00" * 6 + struct.pack(">H", 1)      # reserved + dref idx
            + b"\x00" * 16
            + struct.pack(">HH", tr.width, tr.height)
            + struct.pack(">II", 0x480000, 0x480000)  # 72 dpi
            + b"\x00" * 4
            + struct.pack(">H", 1)                   # frame count
            + b"\x00" * 32                           # compressor name
            + struct.pack(">Hh", 0x18, -1))          # depth, color table
    return box(b"avc1", body + _avcc_box(tr))


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


def _stbl(tr: VideoTrack, chunk_offsets: list[int]) -> bytes:
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


def _trak(tr: VideoTrack, track_id: int, movie_timescale: int,
          chunk_offsets: list[int]) -> bytes:
    dur_ts = sum(s.duration for s in tr.samples)
    dur_movie = int(round(dur_ts * movie_timescale / max(1, tr.timescale)))
    w, h, volume = tr.width << 16, tr.height << 16, 0
    tkhd = full_box(b"tkhd", 0, 7,
                    struct.pack(">IIIII", 0, 0, track_id, 0, dur_movie),
                    b"\x00" * 8,
                    struct.pack(">HHHH", 0, 0, volume, 0),
                    _MATRIX_IDENTITY,
                    struct.pack(">II", w, h))
    mdhd = full_box(b"mdhd", 0, 0,
                    struct.pack(">IIII", 0, 0, tr.timescale, dur_ts),
                    struct.pack(">HH", 0x55C4, 0))  # 'und'
    hdlr = full_box(b"hdlr", 0, 0, b"\x00" * 4, b"vide", b"\x00" * 12,
                    b"VideoHandler\x00")
    mhd = full_box(b"vmhd", 0, 1, b"\x00" * 8)
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
