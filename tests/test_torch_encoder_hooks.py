"""The encoder's small hooks against vcp_tpu's on the CPU:
``headers_annexb``, ``_last_p_data`` of ``encode_frame``, the
``VCP_TIMING`` "gop timing" line and the ``VCP_TRACE_DIR`` trace."""

import io
import json
import os
import re

import numpy as np
import pytest

from vcp_tpu.codec.h264 import encoder as je
from vcp_tpu_torch import logging as tlog
from vcp_tpu_torch.codec.h264 import encoder as te

from video_util import synth_video

W, H = 64, 48


@pytest.fixture(scope="module")
def frames():
    return synth_video(W, H, 5)


@pytest.mark.parametrize("kw", [
    {},
    {"transform8": True},
    {"bframes": 2},
    {"cabac": False, "effort": 5},
])
def test_headers_annexb_matches_vcp_tpu(kw):
    cfg = dict(width=W, height=H, **kw)
    want = je.H264Encoder(je.EncoderConfig(**cfg)).headers_annexb()
    got = te.H264Encoder(te.EncoderConfig(**cfg),
                         device="cpu").headers_annexb()
    assert got == want and got.startswith(b"\0\0\0\1")


@pytest.mark.parametrize("kw", [{}, {"effort": 5}])
def test_last_p_data_matches_vcp_tpu(frames, kw):
    """``_last_p_data`` holds the entropy input of ``encode_frame``'s last
    P picture, the same arrays as vcp_tpu's."""
    cfg = dict(width=W, height=H, qp=26, gop_size=8, **kw)
    j = je.H264Encoder(je.EncoderConfig(**cfg))
    t = te.H264Encoder(te.EncoderConfig(**cfg), device="cpu")
    assert t._last_p_data is None
    for f in frames[:2]:
        assert t.encode_frame(*f) == j.encode_frame(*f)
    assert sorted(t._last_p_data) == sorted(j._last_p_data)
    for k, v in j._last_p_data.items():
        np.testing.assert_array_equal(t._last_p_data[k], np.asarray(v),
                                      err_msg=k)


@pytest.fixture()
def log_lines():
    buf, old = io.StringIO(), tlog._sink
    tlog.set_sink(buf)
    yield lambda: buf.getvalue().splitlines()
    tlog.set_sink(old)


@pytest.mark.parametrize("kw", [{}, {"bframes": 2}])
def test_vcp_timing_logs_each_gop(frames, monkeypatch, log_lines, kw):
    monkeypatch.setenv("VCP_TIMING", "1")
    cfg = te.EncoderConfig(width=W, height=H, qp=26, gop_size=3, **kw)
    te.encode_stream(frames, cfg, device="cpu")
    lines = [ln for ln in log_lines() if "gop timing" in ln]
    assert [int(re.search(r"frames=(\d+)", ln).group(1))
            for ln in lines] == [3, 2]
    for ln in lines:
        fields = dict(re.findall(r"(\w+)=([\d.]+)", ln))
        assert {"frames", "total_ms", "pack_ms", "dispatch_ms", "fetch_ms",
                "entropy_ms"} <= set(fields)
        assert float(fields["total_ms"]) >= float(fields["entropy_ms"])


def test_no_timing_line_without_vcp_timing(frames, monkeypatch, log_lines):
    monkeypatch.delenv("VCP_TIMING", raising=False)
    te.encode_stream(frames[:2], te.EncoderConfig(width=W, height=H),
                     device="cpu")
    assert not any("gop timing" in ln for ln in log_lines())


def test_vcp_trace_dir_writes_trace(frames, monkeypatch, tmp_path):
    """``encode_stream`` under ``VCP_TRACE_DIR`` writes one Kineto JSON
    trace with events into the directory, and encodes as without it."""
    cfg = te.EncoderConfig(width=W, height=H, qp=26)
    plain = te.encode_stream(frames[:3], cfg, device="cpu")
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("VCP_TRACE_DIR", str(trace_dir))
    assert te.encode_stream(frames[:3], cfg, device="cpu") == plain
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(trace_dir / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
