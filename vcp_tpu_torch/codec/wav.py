"""RIFF / WAVE reader of 16-bit PCM (raw audio sources for ``-c:a aac``).

Copy of ``vcp_tpu/codec/wav.py``.
"""

from __future__ import annotations

import struct

import numpy as np


class WavError(RuntimeError):
    pass


def read_wav(path: str):
    """Return (pcm (N, channels) int16, sample_rate)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        ln = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + ln]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif cid == b"data":
            pcm = body
        pos += 8 + ln + (ln & 1)
    if fmt is None or pcm is None:
        raise WavError("missing fmt/data chunk")
    audio_fmt, channels, rate, _, _, bits = fmt
    if audio_fmt not in (1, 0xFFFE) or bits != 16:
        raise WavError(f"only 16-bit PCM supported (fmt={audio_fmt}, "
                       f"bits={bits})")
    samples = np.frombuffer(pcm[:len(pcm) // (2 * channels) * 2 * channels],
                            "<i2").reshape(-1, channels)
    return samples.copy(), rate


def is_wav(path: str) -> bool:
    try:
        with open(path, "rb") as fh:
            head = fh.read(12)
        return head[:4] == b"RIFF" and head[8:12] == b"WAVE"
    except OSError:
        return False
