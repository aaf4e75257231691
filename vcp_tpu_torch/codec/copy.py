"""The ``copy`` preset (``-c copy``).

Copy of ``vcp_tpu/codec/copy.py``. An ISO-BMFF input (.mp4 / .mov /
.m4v) is copied byte for byte in 4 MiB chunks and fsynced; a Matroska /
WebM input is remuxed into MP4 (``codec.mkv.remux_to_mp4``); any other
container raises :class:`UnsupportedContainer`. The deadline is checked
between chunks.
"""

from __future__ import annotations

import os
import time

CHUNK = 4 * 1024 * 1024  # match producer copy buffer (ref producer.go:469)

BMFF_EXTS = (".mp4", ".mov", ".m4v")


class CopyError(RuntimeError):
    pass


class UnsupportedContainer(CopyError):
    pass


class DeadlineExceeded(CopyError):
    pass


def stream_copy(input_path: str, output_path: str,
                deadline: float | None = None) -> int:
    """``-c copy``: byte-identical copy for ISO-BMFF inputs, native remux
    into MP4 for Matroska/WebM (the reference's ffmpeg remuxed these too).

    Returns bytes written. The deadline plays the role of the reference's
    60-min ffmpeg timeout (ref consumer.go:262, 370-394) for this path.
    """
    ext = os.path.splitext(input_path)[1].lower()
    if ext in (".mkv", ".webm"):
        from .mkv import MkvError, remux_to_mp4
        try:
            return remux_to_mp4(input_path, output_path)
        except MkvError as e:
            raise UnsupportedContainer(f"mkv remux failed: {e}") from e
    if ext not in BMFF_EXTS:
        raise UnsupportedContainer(
            f"copy preset requires an ISO-BMFF or Matroska input; got {ext}")
    written = 0
    with open(input_path, "rb") as fin, open(output_path, "wb") as fout:
        while True:
            if deadline is not None and time.monotonic() > deadline:
                raise DeadlineExceeded("copy exceeded task deadline")
            chunk = fin.read(CHUNK)
            if not chunk:
                break
            fout.write(chunk)
            written += len(chunk)
        fout.flush()
        os.fsync(fout.fileno())
    return written
