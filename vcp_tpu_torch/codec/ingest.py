"""Input ingestion: raw Y4M, H.264 or HEVC in MP4, or H.264 in Matroska
/ WebM or AVI -> YUV 4:2:0 frames.

Copy of ``vcp_tpu/codec/ingest.py``. Containers are
demuxed by ``codec.mp4.Mp4Demuxer``, ``codec.mkv.MkvDemuxer`` and
``codec.avi.AviDemuxer`` and decoded on the host by
``codec.h264.decoder.H264Decoder``, which covers streams up to libx264's
default output (High profile, CABAC, multi-ref, partitions, weighted
prediction, B-pyramid). Matroska blocks are decoded in block-timestamp
order, as in ``vcp_tpu``. HEVC in MP4 is decoded on the host by
``codec.h265.foreign.ForeignHevcDecoder`` (intra pictures only, as in
``vcp_tpu``). An input outside what ``vcp_tpu`` reads raises
:class:`IngestError`, as there.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator


@dataclasses.dataclass
class VideoInput:
    width: int
    height: int
    fps_num: int
    fps_den: int
    num_frames: int
    frames: Iterator  # yields (y, u, v) uint8 planes


class IngestError(ValueError):
    pass


def open_video(path: str) -> VideoInput:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".y4m":
        return _open_y4m(path)
    if ext in (".mp4", ".mov", ".m4v"):
        return _open_mp4(path)
    if ext in (".mkv", ".webm"):
        return _open_mkv(path)
    if ext == ".avi":
        return _open_avi(path)
    raise IngestError(f"unsupported input container: {ext} "
                      "(supported: .y4m raw, .mp4/.mov/.mkv/.webm/.avi)")


def _open_y4m(path: str) -> VideoInput:
    from .y4m import read_y4m
    vid = read_y4m(path)

    def gen():
        for i in range(vid.num_frames):
            yield vid.planes(i)

    return VideoInput(vid.width, vid.height, vid.fps_num, vid.fps_den,
                      vid.num_frames, gen())


def _open_mp4(path: str) -> VideoInput:
    from .h264.decoder import H264Decoder
    from .mp4 import Mp4Demuxer

    demux = Mp4Demuxer(path)
    track = demux.video
    if track is None:
        raise IngestError("no video track in input")
    if track.codec in ("hvc1", "hev1"):
        return _open_mp4_hevc(demux, track)
    if track.codec != "avc1":
        raise IngestError(f"unsupported input codec {track.codec!r} "
                          "(h264/avc1 or hevc/hvc1 only)")
    n = track.sample_count
    if track.sample_durations:
        avg = max(1, sum(track.sample_durations[:n]) // max(1, n))
        fps_num, fps_den = track.timescale, avg
    else:
        fps_num, fps_den = 30, 1

    def gen():
        dec = H264Decoder()
        for sps in track.sps:
            dec._decode_nal(sps)
        for pps in track.pps:
            dec._decode_nal(pps)
        for i in range(n):
            for nal in demux.sample_nals(track, i):
                dec._decode_nal(nal)
            for f in dec.drain():
                yield f.y, f.u, f.v
        for f in dec.drain(flush=True):
            yield f.y, f.u, f.v

    return VideoInput(track.width, track.height, fps_num, fps_den, n, gen())


def _open_mp4_hevc(demux, track) -> VideoInput:
    """HEVC in MP4 through the foreign HEVC decoder (libx265
    medium-defaults intra surface on the host); an inter picture fails
    with ``IngestError("hevc: ...")``, as in ``vcp_tpu``."""
    from .h265.foreign import ForeignHevcDecoder, ForeignHevcError

    n = track.sample_count
    if track.sample_durations:
        avg = max(1, sum(track.sample_durations[:n]) // max(1, n))
        fps_num, fps_den = track.timescale, avg
    else:
        fps_num, fps_den = 30, 1

    def gen():
        dec = ForeignHevcDecoder()
        try:
            for nal in track.vps + track.sps + track.pps:
                dec.decode_nal(nal)
            for i in range(n):
                for nal in demux.sample_nals(track, i):
                    out = dec.decode_nal(nal)
                    if out is not None:
                        yield out
        except ForeignHevcError as e:
            raise IngestError(f"hevc: {e}") from e

    return VideoInput(track.width, track.height, fps_num, fps_den, n,
                      gen())


def _open_avi(path: str) -> VideoInput:
    """H.264 in AVI carries Annex-B NAL units per video chunk; each chunk
    feeds the host decoder directly."""
    from .avi import H264_FOURCCS, AviDemuxer, AviError
    from .h264.decoder import H264Decoder
    from .mp4 import split_annexb

    try:
        demux = AviDemuxer(path)
    except AviError as e:
        raise IngestError(str(e)) from e
    t = demux.video
    if t is None:
        raise IngestError("avi: no video stream")
    if t.fourcc not in H264_FOURCCS:
        raise IngestError(f"avi: unsupported video fourcc {t.fourcc!r} "
                          "(h264 only)")
    n = len(t.chunks)

    def gen():
        dec = H264Decoder()
        for i in range(n):
            for nal in split_annexb(t.chunks[i]):
                dec._decode_nal(nal)
            for f in dec.drain():
                yield f.y, f.u, f.v
        for f in dec.drain(flush=True):
            yield f.y, f.u, f.v

    return VideoInput(t.width, t.height, t.rate, t.scale, n, gen())


def _open_mkv(path: str) -> VideoInput:
    from .h264.decoder import H264Decoder
    from .mkv import MkvDemuxer, MkvError
    from .mp4 import parse_avcc

    try:
        demux = MkvDemuxer(path)
    except MkvError as e:
        raise IngestError(str(e)) from e
    t = demux.video
    if t is None or t.codec_id != "V_MPEG4/ISO/AVC":
        raise IngestError("mkv: no h264 video track")
    nal_len, sps, pps = parse_avcc(t.codec_private)

    samples = sorted(t.samples, key=lambda s: s.timestamp_ns)
    n = len(samples)
    if t.default_duration_ns:
        fps_num, fps_den = 1_000_000_000, t.default_duration_ns
    else:
        fps_num, fps_den = 30, 1

    def gen():
        dec = H264Decoder()
        for nal in sps + pps:
            dec._decode_nal(nal)
        for i in range(n):
            data = samples[i].data
            pos = 0
            while pos + nal_len <= len(data):
                ln = int.from_bytes(data[pos:pos + nal_len], "big")
                dec._decode_nal(data[pos + nal_len:pos + nal_len + ln])
                pos += nal_len + ln
            for f in dec.drain():
                yield f.y, f.u, f.v
        for f in dec.drain(flush=True):
            yield f.y, f.u, f.v

    return VideoInput(t.width, t.height, fps_num, fps_den, n, gen())
