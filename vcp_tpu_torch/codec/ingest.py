"""Input ingestion: raw Y4M or MP4 (H.264) -> YUV 4:2:0 frames.

Copy of ``open_video``, ``_open_y4m`` and ``_open_mp4`` of
``vcp_tpu/codec/ingest.py``. MP4 inputs are demuxed by
``codec.mp4.Mp4Demuxer`` and decoded on the host by
``codec.h264.decoder.H264Decoder``, which covers streams up to libx264's
default output (High profile, CABAC, multi-ref, partitions, weighted
prediction, B-pyramid). Containers and codecs that are not ported yet
raise ``NotImplementedError`` naming their ROADMAP item: MKV / WebM / AVI
(A5b) and HEVC in MP4 (A9). An input outside what ``vcp_tpu`` reads
raises :class:`IngestError`, as there.
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
    audio: object = None  # an MP4 input's audio track (mp4.DemuxedTrack)


class IngestError(ValueError):
    pass


def open_video(path: str) -> VideoInput:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".y4m":
        return _open_y4m(path)
    if ext in (".mp4", ".mov", ".m4v"):
        return _open_mp4(path)
    if ext in (".mkv", ".webm", ".avi"):
        raise NotImplementedError(f"{ext} input is not ported yet (ROADMAP "
                                  "A5b)")
    raise IngestError(f"unsupported input container: {ext} "
                      "(supported: .y4m raw, .mp4/.mov/.m4v)")


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
        raise NotImplementedError("HEVC input is not ported yet (ROADMAP "
                                  "A9)")
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

    return VideoInput(track.width, track.height, fps_num, fps_den, n, gen(),
                      demux.audio)
