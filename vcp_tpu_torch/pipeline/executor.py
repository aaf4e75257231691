"""Task executor: parse a task's ffmpeg-style argument string and run
the matching engine. Port of ``vcp_tpu/pipeline/executor.py``:

* ``-c copy``      -> byte-identical stream copy, or an MKV remux
  (``codec.copy``);
* ``-vn -c:a aac`` -> an audio-only MP4 (``codec.audio``);
* ``-c:v h264_*``  -> the H.264 encoder on ``device``;
* ``-c:v hevc_*``  -> the HEVC encoder on ``device``.

A setting not ported yet raises ``NotImplementedError`` naming its ROADMAP
item.

Every other failure becomes :class:`EncodeError`, chained to its cause,
as in vcp_tpu (a consumer acks and drops the task); a ``CopyError``
keeps its own text. The deadline is cooperative (checked between GOPs
and between copied chunks)."""

from __future__ import annotations

import time

from ..codec import copy as copycodec
from ..codec.args import ArgsError, EncodeParams, parse_encode_args


class EncodeError(RuntimeError):
    pass


def execute(input_path: str, output_path: str, ffmpeg_args: str,
            timeout: float = 3600.0, device: str = "cuda") -> int:
    """Run one task's encode on ``device``; returns the output size in
    bytes. Raises :class:`EncodeError` on any failure (bad arguments, a
    missing or undecodable input, a failed kernel build or launch), and
    ``NotImplementedError`` unchanged for a setting not ported yet."""
    deadline = time.monotonic() + timeout
    try:
        params = parse_encode_args(ffmpeg_args)
    except ArgsError as e:
        raise EncodeError(f"bad encode args: {e}") from e
    try:
        return _dispatch(input_path, output_path, params, deadline, device)
    except (EncodeError, NotImplementedError):
        raise
    except copycodec.CopyError as e:
        raise EncodeError(str(e)) from e
    except Exception as e:
        raise EncodeError(f"{type(e).__name__}: {e}") from e


def _dispatch(input_path: str, output_path: str, params: EncodeParams,
              deadline: float, device: str) -> int:
    if params.is_copy:
        return copycodec.stream_copy(input_path, output_path, deadline)
    if params.video_disabled:
        from ..codec import audio
        return audio.extract_audio(input_path, output_path, params, deadline)
    if params.video_codec == "h264":
        from ..codec.h264 import encoder as h264
        return h264.encode_file(input_path, output_path, params, deadline,
                                device=device)
    if params.video_codec == "h265":
        from ..codec.h265 import encoder as h265
        return h265.encode_file(input_path, output_path, params, deadline,
                                device=device)
    raise EncodeError(f"no engine for video codec {params.video_codec!r}")
