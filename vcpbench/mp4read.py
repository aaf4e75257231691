"""A small ISO BMFF (MP4) reader of the benchmark's own.

It reads what the comparison and ``kbps`` need from an encoder's output:
the box layout, each track's handler, codec, size, timescale, sample
sizes, offsets and durations, sync samples and ``avcC`` parameter sets.
It shares no code with the port's muxer or demuxer.
"""

from __future__ import annotations

import dataclasses
import struct

_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts",
               b"dinf"}


class Mp4Error(ValueError):
    pass


@dataclasses.dataclass
class Track:
    handler: str = ""
    codec: str = ""
    width: int = 0
    height: int = 0
    timescale: int = 0
    sizes: list = dataclasses.field(default_factory=list)
    offsets: list = dataclasses.field(default_factory=list)
    durations: list = dataclasses.field(default_factory=list)
    sync: list | None = None          # 0-based sync samples (None: all)
    cts_offsets: list | None = None
    nal_length_size: int = 0
    sps: list = dataclasses.field(default_factory=list)
    pps: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Movie:
    top: list                           # [(type, offset, size)] top level
    tracks: list


def _boxes(data: bytes, start: int, end: int):
    pos = start
    while pos < end:
        if end - pos < 8:
            raise Mp4Error(f"truncated box header at {pos}")
        size, typ = struct.unpack_from(">I4s", data, pos)
        hdr = 8
        if size == 1:
            if end - pos < 16:
                raise Mp4Error(f"truncated large box header at {pos}")
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            raise Mp4Error(f"box {typ!r} at {pos} of size {size} overruns "
                           f"its parent (end {end})")
        yield typ, pos + hdr, pos + size
        pos += size


def _full(data: bytes, p: int) -> tuple[int, int]:
    """(version, payload start) of a full box."""
    return data[p], p + 4


def _parse_avcc(tr: Track, data: bytes, p: int, end: int) -> None:
    if end - p < 7:
        raise Mp4Error("avcC too short")
    tr.nal_length_size = (data[p + 4] & 3) + 1
    n_sps = data[p + 5] & 31
    q = p + 6
    for _ in range(n_sps):
        n = struct.unpack_from(">H", data, q)[0]
        tr.sps.append(bytes(data[q + 2:q + 2 + n]))
        q += 2 + n
    n_pps = data[q]
    q += 1
    for _ in range(n_pps):
        n = struct.unpack_from(">H", data, q)[0]
        tr.pps.append(bytes(data[q + 2:q + 2 + n]))
        q += 2 + n
    if q > end:
        raise Mp4Error("avcC parameter sets overrun the box")


def _parse_stsd(tr: Track, data: bytes, p: int, end: int) -> None:
    _, q = _full(data, p)
    n = struct.unpack_from(">I", data, q)[0]
    for i, (typ, s, e) in enumerate(_boxes(data, q + 4, end)):
        if i >= n:
            break
        tr.codec = typ.decode("latin-1")
        if typ in (b"avc1", b"avc3"):
            # VisualSampleEntry: 8 bytes SampleEntry, 16 predefined, then
            # width and height, then 50 bytes up to the child boxes
            tr.width, tr.height = struct.unpack_from(">HH", data, s + 24)
            for ctyp, cs, ce in _boxes(data, s + 78, e):
                if ctyp == b"avcC":
                    _parse_avcc(tr, data, cs, ce)


def _table(data: bytes, p: int, fields: int) -> list:
    _, q = _full(data, p)
    n = struct.unpack_from(">I", data, q)[0]
    return [struct.unpack_from(">" + "I" * fields, data, q + 4 + 4 * fields * i)
            for i in range(n)]


def _parse_stbl(tr: Track, data: bytes, p: int, end: int) -> None:
    chunks, stsc, stts = [], [], []
    for typ, s, e in _boxes(data, p, end):
        if typ == b"stsd":
            _parse_stsd(tr, data, s, e)
        elif typ == b"stsz":
            _, q = _full(data, s)
            fixed, n = struct.unpack_from(">II", data, q)
            tr.sizes = ([fixed] * n if fixed else
                        list(struct.unpack_from(">%dI" % n, data, q + 8)))
        elif typ == b"stco":
            chunks = [c[0] for c in _table(data, s, 1)]
        elif typ == b"co64":
            _, q = _full(data, s)
            n = struct.unpack_from(">I", data, q)[0]
            chunks = list(struct.unpack_from(">%dQ" % n, data, q + 4))
        elif typ == b"stsc":
            stsc = _table(data, s, 3)
        elif typ == b"stts":
            stts = _table(data, s, 2)
        elif typ == b"stss":
            tr.sync = [c[0] - 1 for c in _table(data, s, 1)]
        elif typ == b"ctts":
            tr.cts_offsets = [o for n, o in _table(data, s, 2)
                              for _ in range(n)]
    tr.durations = [d for n, d in stts for _ in range(n)]
    # sample offsets from the chunk offsets and the sample-to-chunk runs
    k = 0
    for i, off in enumerate(chunks):
        per = 0
        for first, n, _ in stsc:
            if first - 1 <= i:
                per = n
        for _ in range(per):
            if k >= len(tr.sizes):
                break
            tr.offsets.append(off)
            off += tr.sizes[k]
            k += 1
    if len(tr.offsets) != len(tr.sizes):
        raise Mp4Error(f"chunk tables place {len(tr.offsets)} of "
                       f"{len(tr.sizes)} samples")


def _parse_trak(data: bytes, p: int, end: int) -> Track:
    tr = Track()
    for typ, s, e in _boxes(data, p, end):
        if typ != b"mdia":
            continue
        for t2, s2, e2 in _boxes(data, s, e):
            if t2 == b"mdhd":
                v, q = _full(data, s2)
                tr.timescale = struct.unpack_from(
                    ">I", data, q + (16 if v == 1 else 8))[0]
            elif t2 == b"hdlr":
                _, q = _full(data, s2)
                tr.handler = data[q + 4:q + 8].decode("latin-1")
            elif t2 == b"minf":
                for t3, s3, e3 in _boxes(data, s2, e2):
                    if t3 == b"stbl":
                        _parse_stbl(tr, data, s3, e3)
    return tr


def read(path: str) -> tuple[Movie, bytes]:
    """Parse the file: (movie, its bytes)."""
    with open(path, "rb") as fh:
        data = fh.read()
    top, tracks = [], []
    for typ, s, e in _boxes(data, 0, len(data)):
        top.append((typ.decode("latin-1"), s, e - s))
        if typ == b"moov":
            for t2, s2, e2 in _boxes(data, s, e):
                if t2 == b"trak":
                    tracks.append(_parse_trak(data, s2, e2))
    return Movie(top, tracks), data


def sample_nals(tr: Track, data: bytes, i: int) -> list[bytes]:
    """The NAL units of sample ``i`` (length-prefixed in the sample)."""
    p, end = tr.offsets[i], tr.offsets[i] + tr.sizes[i]
    if end > len(data):
        raise Mp4Error(f"sample {i} ends past the file")
    out, n = [], tr.nal_length_size
    while p < end:
        if end - p < n:
            raise Mp4Error(f"sample {i}: truncated NAL length")
        ln = int.from_bytes(data[p:p + n], "big")
        p += n
        if ln == 0 or p + ln > end:
            raise Mp4Error(f"sample {i}: NAL of {ln} bytes overruns the "
                           f"sample")
        out.append(bytes(data[p:p + ln]))
        p += ln
    return out


def video_kbps(tr: Track) -> float:
    """Bits of the track's samples over its seconds of content, in kb/s."""
    seconds = sum(tr.durations) / tr.timescale
    return sum(tr.sizes) * 8 / seconds / 1000.0
