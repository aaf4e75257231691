"""Publish-time codec probe: a cheap header-only support check.

Copy of ``vcp_tpu/codec/probe.py``. The consumer decodes in-process, so
a payload that no decoder of the package handles (VP9 inside a .webm,
say) is refused by the producer at publish time with a precise reason,
before the file moves to shared storage. ``None`` means "publishable",
not a decode guarantee: an H.264 stream beyond the decoder's envelope
still fails at the consumer with its own reason.
"""

from __future__ import annotations

import os

# Matroska codec ids with a decode path (see codec.ingest).
_MKV_SUPPORTED = ("V_MPEG4/ISO/AVC",)
# ISO-BMFF sample entries with a decode path.
_MP4_SUPPORTED = ("avc1", "hvc1", "hev1")


def probe_reject_reason(path: str) -> str | None:
    """Header-only support probe. Returns a precise human-readable
    rejection reason, or None when the payload looks consumable.

    Unreadable/corrupt headers return a reason too — the file would
    fail at the consumer anyway, and failing at publish keeps it out of
    shared storage.
    """
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext in (".mkv", ".webm"):
            from .mkv import MkvDemuxer, MkvError
            try:
                t = MkvDemuxer(path).video
            except MkvError as e:
                return f"{ext[1:]}: unreadable container: {e}"
            if t is None:
                return f"{ext[1:]}: no video track"
            if t.codec_id not in _MKV_SUPPORTED:
                return (f"{ext[1:]}: unsupported video codec "
                        f"{t.codec_id!r} (supported: h264/AVC; VP8/VP9/"
                        "AV1 have no in-repo decoder)")
            return None
        if ext in (".mp4", ".mov", ".m4v"):
            from .mp4 import Mp4Demuxer
            try:
                t = Mp4Demuxer(path).video
            except Exception as e:
                return f"mp4: unreadable container: {e}"
            if t is None:
                return "mp4: no video track"
            if t.codec not in _MP4_SUPPORTED:
                return (f"mp4: unsupported video codec {t.codec!r} "
                        "(supported: avc1/hvc1/hev1)")
            return None
        if ext == ".avi":
            from .avi import AviDemuxer, AviError, H264_FOURCCS
            try:
                t = AviDemuxer(path).video
            except AviError as e:
                return f"avi: unreadable container: {e}"
            if t is None:
                return "avi: no video stream"
            if t.fourcc not in H264_FOURCCS:
                return (f"avi: unsupported video fourcc {t.fourcc!r} "
                        "(h264 only)")
            return None
    except Exception as e:          # never let the probe kill the producer
        return f"probe failed: {e}"
    return None                     # .y4m and anything else: publish as-is
