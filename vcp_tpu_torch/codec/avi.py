"""RIFF / AVI demuxer (read side only).

Copy of ``vcp_tpu/codec/avi.py``. It reads the AVI shape that modern
muxers write for H.264 video: RIFF('AVI ') -> LIST('hdrl') with one
LIST('strl') per stream (``strh`` + ``strf`` BITMAPINFOHEADER /
WAVEFORMATEX), then LIST('movi') with ``##dc`` / ``##db`` video and
``##wb`` audio chunks, optionally nested in LIST('rec ') groups, and
OpenDML ``AVIX`` extension RIFFs. The ``idx1`` index is not needed for a
sequential scan and is ignored. H.264 in AVI carries Annex-B NAL units,
which ``codec.ingest._open_avi`` feeds to the host decoder.
"""

from __future__ import annotations

import dataclasses
import struct


class AviError(ValueError):
    pass


H264_FOURCCS = {b"H264", b"h264", b"X264", b"x264", b"AVC1", b"avc1",
                b"DAVC", b"VSSH"}


@dataclasses.dataclass
class AviVideoTrack:
    stream_index: int
    fourcc: bytes          # BITMAPINFOHEADER biCompression
    width: int
    height: int
    rate: int              # strh dwRate
    scale: int             # strh dwScale (fps = rate/scale)
    length: int            # strh dwLength (frames)
    chunks: list           # list[bytes], coded frames in file order


@dataclasses.dataclass
class AviAudioTrack:
    stream_index: int
    format_tag: int        # WAVEFORMATEX wFormatTag (1 = PCM s16le)
    channels: int
    sample_rate: int
    bits_per_sample: int
    chunks: list


class AviDemuxer:
    def __init__(self, path: str):
        self.video: AviVideoTrack | None = None
        self.audio: AviAudioTrack | None = None
        self._tracks: dict[int, object] = {}
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < 12 or data[:4] != b"RIFF":
            raise AviError("not a RIFF file")
        pos = 0
        # One or more top-level RIFF chunks: 'AVI ' then OpenDML 'AVIX'.
        while pos + 12 <= len(data):
            if data[pos:pos + 4] != b"RIFF":
                break
            size = struct.unpack_from("<I", data, pos + 4)[0]
            form = data[pos + 8:pos + 12]
            if pos == 0 and form != b"AVI ":
                raise AviError(f"not an AVI file (form {form!r})")
            end = min(len(data), pos + 8 + size)
            self._scan(data, pos + 12, end)
            pos += 8 + size + (size & 1)
        if self.video is None and self.audio is None:
            raise AviError("no decodable streams found")

    # -- container walk ------------------------------------------------
    def _scan(self, data: bytes, pos: int, end: int) -> None:
        while pos + 8 <= end:
            ckid = data[pos:pos + 4]
            size = struct.unpack_from("<I", data, pos + 4)[0]
            body = pos + 8
            if ckid == b"LIST":
                ltype = data[body:body + 4]
                if ltype in (b"hdrl", b"movi", b"rec "):
                    if ltype == b"hdrl":
                        self._parse_hdrl(data, body + 4, body + size)
                    else:
                        self._scan(data, body + 4, min(end, body + size))
            elif len(ckid) == 4 and ckid[:2].isdigit():
                self._stream_chunk(int(ckid[:2]), ckid[2:4],
                                   data[body:body + size])
            pos = body + size + (size & 1)

    def _parse_hdrl(self, data: bytes, pos: int, end: int) -> None:
        stream_index = 0
        while pos + 8 <= end:
            ckid = data[pos:pos + 4]
            size = struct.unpack_from("<I", data, pos + 4)[0]
            body = pos + 8
            if ckid == b"LIST" and data[body:body + 4] == b"strl":
                self._parse_strl(data, body + 4, body + size, stream_index)
                stream_index += 1
            pos = body + size + (size & 1)

    def _parse_strl(self, data: bytes, pos: int, end: int,
                    index: int) -> None:
        strh = strf = None
        while pos + 8 <= end:
            ckid = data[pos:pos + 4]
            size = struct.unpack_from("<I", data, pos + 4)[0]
            body = pos + 8
            if ckid == b"strh":
                strh = data[body:body + size]
            elif ckid == b"strf":
                strf = data[body:body + size]
            pos = body + size + (size & 1)
        if strh is None or strf is None or len(strh) < 40:
            return
        fcc_type = strh[:4]
        scale, rate, _start, length = struct.unpack_from("<IIII", strh, 20)
        if fcc_type == b"vids" and len(strf) >= 40:
            # BITMAPINFOHEADER
            w, h = struct.unpack_from("<ii", strf, 4)
            fourcc = strf[16:20]
            self._tracks[index] = AviVideoTrack(
                stream_index=index, fourcc=fourcc, width=w, height=abs(h),
                rate=rate or 30, scale=scale or 1, length=length, chunks=[])
            if self.video is None:
                self.video = self._tracks[index]
        elif fcc_type == b"auds" and len(strf) >= 16:
            tag, ch, srate = struct.unpack_from("<HHI", strf, 0)
            bits = struct.unpack_from("<H", strf, 14)[0]
            self._tracks[index] = AviAudioTrack(
                stream_index=index, format_tag=tag, channels=ch,
                sample_rate=srate, bits_per_sample=bits, chunks=[])
            if self.audio is None:
                self.audio = self._tracks[index]

    def _stream_chunk(self, index: int, kind: bytes, payload: bytes) -> None:
        track = self._tracks.get(index)
        if track is None or not payload:
            return
        if kind in (b"dc", b"db") and isinstance(track, AviVideoTrack):
            track.chunks.append(payload)
        elif kind == b"wb" and isinstance(track, AviAudioTrack):
            track.chunks.append(payload)
