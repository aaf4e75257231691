"""Reading a device trace: the window between the sentinel copies, busy
time as a union, host-to-device bytes, idle gaps labelled by host span."""

import json

import pytest

from vcpbench import trace


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": args}


def _write(tmp_path, events):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return str(p)


def _events():
    s0, s1 = trace.SENTINEL_BYTES
    return [
        _ev("kernel", "preroll", 10.0, 1.0),          # before the window
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1000.0, 10.0,
            bytes=s0),
        _ev("kernel", "void motion_search_strip<true, 20>", 1100.0, 100.0),
        _ev("kernel", "void deblock_wave<0>", 1150.0, 100.0),   # overlaps
        _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1400.0, 50.0,
            bytes=3000),
        _ev("gpu_memset", "Memset (Device)", 1800.0, 10.0),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 2010.0, 10.0,
            bytes=s1),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1099.0, "dur": 2.0},
    ]


def test_window_busy_bytes(tmp_path):
    # host time 1.0 s <-> device 1000 us (the first sentinel's start)
    spans = [("task", 0.9, 2.1)]
    r = trace.reduce(_write(tmp_path, _events()), 1.0, spans)
    assert r["window_s"] == pytest.approx((2010.0 - 1010.0) * 1e-6)
    # union: [1100, 1250] + [1400, 1450] + [1800, 1810]
    assert r["busy_s"] == pytest.approx((150 + 50 + 10) * 1e-6)
    assert r["h2d_bytes"] == 3000
    assert r["events"] == 4
    assert trace.kernel_seconds(r["kernel_s"], "motion_search") == \
        pytest.approx(100e-6)
    assert r["device_ops"][0][1] == pytest.approx(100e-6)
    # the longest gap is 1450..1800 (350 us)
    name, secs = r["idle_gaps"][0]
    assert secs == pytest.approx(350e-6)
    assert len(r["idle_gaps"]) == 4


def test_gap_labelled_by_innermost_span(tmp_path):
    # offset: device us = host s * 1e6 + (1000 - 1e6); gap 1450..1800 has
    # its middle at device 1625 us, host 1.000625 s
    spans = [("task", 0.9, 2.1),
             ("encode_gop", 1.0006, 1.00065)]
    r = trace.reduce(_write(tmp_path, _events()), 1.0, spans)
    assert r["idle_gaps"][0][0] == "encode_gop"
    spans = [("task", 0.9, 2.1)]
    r = trace.reduce(_write(tmp_path, _events()), 1.0, spans)
    assert r["idle_gaps"][0][0] == "task"


def test_lost_sentinel_raises(tmp_path):
    ev = [e for e in _events()
          if e.get("args", {}).get("bytes") != trace.SENTINEL_BYTES[1]]
    with pytest.raises(trace.TraceLost):
        trace.reduce(_write(tmp_path, ev), 1.0, [])
