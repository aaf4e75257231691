"""The harness as a whole: BENCHMARK.json against its contract and its
files, the refusal without a card, a CPU rehearsal of every cell, and
``correct`` coming out false for the control, for each fault a cell can
have and for faults planted in the device steps, with the timed path
broken underneath."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from vcpbench import bench, check, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
REHEARSAL = (192, 128)


def _bench():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vcpbench/")
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        spec.load_cell(w["name"])            # every file is there
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        spec.reader(m["name"])               # every metric has a reader
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in b["workloads"]:
        limits = spec.load_cell(w["name"]).limits
        assert set(check.COUNTS) <= set(limits) <= set(check.NUMBERS)
        assert len(set(limits) & set(check.PICTURES)) == 1


def test_refuses_without_a_card(tmp_path):
    """No card here: exit non-zero and print no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run(
        [sys.executable, os.path.join(spec.ROOT, "vcpbench", "run.py"),
         "--workload", "nvenc-pan", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=120)
    assert r.returncode != 0 and r.stdout == ""


def test_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "vcpbench"),
                    tmp_path / "vcpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run(
        [sys.executable, "vcpbench/run.py", "--workload", "nvenc-pan",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0 and r.stdout == ""


def _run(workload, trace=0, args=None, seed=5):
    return bench.run_cell(workload, seed, 0.1, bool(trace), device="cpu",
                          size=REHEARSAL, program_args=args)


CELLS = [w["name"] for w in _bench()["workloads"]]


def _picture_over_limit(r) -> bool:
    """The cell's compared picture number reads above its limit."""
    return any(c["value"] > c["limit"] for k, c in r["checks"].items()
               if k in check.PICTURES)


@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal_is_correct(workload):
    r = _run(workload, trace=1)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    want = {m["name"] for m in _bench()["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["source"] != "device_trace"}
    assert want <= set(r["metrics"])
    assert r["frames_decoded"] == 12


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The configuration's control (its quantiser one bit coarser) fails
    the comparison."""
    args = spec.load_cell(workload).config["control_args"]
    r = _run(workload, args=args)
    assert not r["correct"]
    assert _picture_over_limit(r)


def _frozen(real):
    """A step that returns its state unchanged: every frame of a GOP coded
    as its first."""
    def encode_gop(self, frames):
        return real(self, [frames[0]] * len(frames))
    return encode_gop


def _half(real):
    """Half of the batch left out: every second frame replaced by the one
    before it."""
    def encode_gop(self, frames):
        return real(self, [frames[i - (i % 2)] for i in range(len(frames))])
    return encode_gop


def _flipped(real):
    """A token altered where it is produced: one byte of the fourth
    access unit's slice data."""
    def encode_gop(self, frames):
        out = real(self, frames)
        if len(out) > 3:
            au = bytearray(out[3][0])
            au[len(au) * 2 // 3] ^= 0x24
            out[3] = (bytes(au),) + tuple(out[3][1:])
        return out
    return encode_gop


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_frozen, _half, _flipped])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    from vcp_tpu_torch.codec.h264.encoder import H264Encoder
    monkeypatch.setattr(H264Encoder, "encode_gop",
                        fault(H264Encoder.encode_gop))
    r = _run(workload)
    assert not r["correct"], r["checks"]


def _mv_shifted(monkeypatch):
    """Motion vectors written one pixel to the right of the ones whose
    prediction the encoder coded the residual against."""
    from vcp_tpu_torch.codec.h264 import gop_ops
    real = gop_ops._search_mc_luma

    def search(*a, **kw):
        mv, pred, mc = real(*a, **kw)
        mv = mv.clone()
        mv[..., 1] += 4                   # quarter-pel units
        return mv, pred, mc
    monkeypatch.setattr(gop_ops, "_search_mc_luma", search)


def _bilinear_half_pel(monkeypatch):
    """Half-pel planes by a bilinear average instead of the 6-tap filter
    that the decoder applies."""
    import torch
    from vcp_tpu_torch.ops import motion

    def half_planes(ref_pad):
        a = ref_pad.to(torch.int32)
        b = (a[:, :-1] + a[:, 1:] + 1) >> 1
        h = (a[:-1] + a[1:] + 1) >> 1
        j = (a[:-1, :-1] + a[1:, 1:] + a[:-1, 1:] + a[1:, :-1] + 2) >> 2
        return a[3:-3, 3:-3], b[3:-3, 3:-2], h[3:-2, 3:-3], j[3:-2, 3:-2]
    monkeypatch.setattr(motion, "half_planes", half_planes)


KERNEL_FAULTS = [(w, _mv_shifted) for w in CELLS] + [
    (w, _bilinear_half_pel) for w in CELLS
    if spec.load_cell(w).config["preset"] == "h264-cpu"]


@pytest.mark.parametrize("workload,fault", KERNEL_FAULTS)
def test_device_step_fault_is_not_correct(workload, fault, monkeypatch):
    """A fault in what the device computes: the decoder follows the
    stream, the encoder's references do not, and the pictures drift."""
    fault(monkeypatch)
    r = _run(workload)
    assert not r["correct"], r["checks"]
    assert _picture_over_limit(r)
