"""The shipped preset ``-p h264-nvenc-hq`` of vcp_tpu_torch (``-c:v
h264_nvenc -preset p7 -tune hq -b:v 15M -maxrate 20M -bufsize 30M``:
effort 7, quarter-pel ME at +-16, 2 B pictures, partitioned P anchors
with intra MBs, 8x8 transform, RD intra IDR, VBV rate control) against
vcp_tpu on the CPU: byte-identical NAL units and MP4 files. Also
``-preset p7 -bf 0`` (the chunked quarter-pel P path) and an MP4 input
through both executors. The other quarter-pel shapes are in
``test_torch_encoder_hq_shapes.py``."""

import numpy as np
import pytest

from test_torch_encoder_bgop import _ctts, _gop_cts, _runs
from vcp_tpu.codec.h264 import encoder as je
from vcp_tpu.codec.y4m import write_y4m
from vcp_tpu.pipeline import executor as j_executor
from vcp_tpu_torch.codec.h264 import bframe as t_bframe
from vcp_tpu_torch.codec.h264 import encoder as te
from vcp_tpu_torch.codec.h264 import entropy as t_entropy
from vcp_tpu_torch.config import BUILTIN_PRESETS
from vcp_tpu_torch.pipeline import executor as t_executor

W, H = 96, 64
HQ = BUILTIN_PRESETS["h264-nvenc-hq"]


def qframes(n, w=W, cut=None, seed=3):
    """A gradient half and a texture half that move by a quarter-pel
    amount per frame (1.25 px across, 0.75 px down), plus noise, so
    vectors with odd quarter phases win; inverted from frame ``cut``
    on."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:w].astype(np.float64)
    cy, cx = np.mgrid[0:H // 2, 0:w // 2].astype(np.float64)
    out = []
    for t in range(n):
        x, yv = xx + 1.25 * t, yy + 0.75 * t
        grad = 60 + 0.8 * x + 0.5 * yv + 20 * np.sin(x / 17.0)
        tex = 128 + 60 * np.sin(x / 2.9) * np.cos(yv / 3.7)
        y = np.where(xx < w // 2, grad, tex) + rng.integers(-3, 4, (H, w))
        u = 128 + 30 * np.sin((cx + 0.625 * t) / 9.0)
        v = 128 + 30 * np.cos((cy + 0.375 * t) / 7.0)
        f = tuple(np.clip(p, 0, 255).astype(np.uint8) for p in (y, u, v))
        out.append(tuple(255 - p for p in f)
                   if cut is not None and t >= cut else f)
    return out


def _execute_pair(tmp_path, name, src, ffargs, monkeypatch=None, env=()):
    """``src`` through both executors on the CPU; returns (port MP4 bytes,
    vcp_tpu MP4 bytes, port MP4 path)."""
    for k, v in env:
        monkeypatch.setenv(k, v)
    ref = str(tmp_path / f"{name}.ref.mp4")
    out = str(tmp_path / f"{name}.port.mp4")
    j_executor.execute(src, ref, ffargs)
    t_executor.execute(src, out, ffargs, device="cpu")
    with open(ref, "rb") as a, open(out, "rb") as b:
        return b.read(), a.read(), out


@pytest.fixture(scope="module")
def hq_y4m(tmp_path_factory):
    """13 frames at 6 fps with a cut at frame 9: GOPs of 6, 3 and 4."""
    path = str(tmp_path_factory.mktemp("hq") / "in.y4m")
    write_y4m(path, qframes(13, cut=9), fps_num=6)
    return path


@pytest.fixture(scope="module")
def hq_mp4s(hq_y4m, tmp_path_factory):
    return _execute_pair(tmp_path_factory.mktemp("hq_out"), "hq", hq_y4m,
                         HQ)


def test_preset_h264_nvenc_hq_mp4_identical(hq_mp4s):
    """``-p h264-nvenc-hq`` through both executors: the same MP4 bytes,
    with the B pictures' composition offsets."""
    port, ref, path = hq_mp4s
    assert port == ref
    assert _ctts(path) == _runs(
        _gop_cts(6, 2) + _gop_cts(3, 2) + _gop_cts(4, 2), 1000)


def test_hq_nal_units_identical():
    """The hq GOP coder's NAL units, one B GOP of 7 frames, through both
    ``encode_stream``s (the VBV rate control moves the QP per GOP)."""
    fr = qframes(7)
    from vcp_tpu.codec.args import parse_encode_args as j_parse
    from vcp_tpu_torch.codec.args import parse_encode_args as t_parse
    cj = je.EncoderConfig.from_params(j_parse(HQ), W, H, 30, 1)
    ct = te.EncoderConfig.from_params(t_parse(HQ), W, H, 30, 1)
    assert (ct.effort, ct.bframes, ct.parts, ct.transform8) == \
        (cj.effort, cj.bframes, cj.parts, cj.transform8) == (7, 2, True,
                                                             True)
    sps_j, pps_j, sam_j = je.encode_stream(fr, cj)
    sps_t, pps_t, sam_t = te.encode_stream(fr, ct, device="cpu")
    assert (sps_t, pps_t) == (sps_j, pps_j)
    assert [tuple(s) for s in sam_t] == [tuple(s) for s in sam_j]


def test_hq_uses_quarter_pel(monkeypatch):
    """The hq GOP really codes quarter-pel vectors: odd phases in P
    anchors (on the partition grid) and in B pictures."""
    seen = {"p": 0, "b": 0}
    real_p, real_b = t_entropy.write_pslice, t_bframe.write_bslice

    def spy_p(*a, **kw):
        seen["p"] += int(((kw["data"]["mv8"] & 1) == 1).any(-1).sum())
        return real_p(*a, **kw)

    def spy_b(*a, **kw):
        d = kw["data"]
        seen["b"] += int(((d["mv0"] & 1) == 1).any(-1).sum()
                         + ((d["mv1"] & 1) == 1).any(-1).sum())
        return real_b(*a, **kw)

    monkeypatch.setattr(t_entropy, "write_pslice", spy_p)
    monkeypatch.setattr(t_bframe, "write_bslice", spy_b)
    from vcp_tpu_torch.codec.args import parse_encode_args
    cfg = te.EncoderConfig.from_params(parse_encode_args(HQ), W, H, 30, 1)
    te.encode_stream(qframes(7), cfg, device="cpu")
    assert seen["p"] > 0 and seen["b"] > 0, seen


def test_p7_bf0_mp4_identical(tmp_path):
    """``-preset p7 -bf 0``: the chunked quarter-pel P path (8/4/2/1-frame
    chunks, no partitions)."""
    src = str(tmp_path / "in.y4m")
    write_y4m(src, qframes(10, cut=7), fps_num=6)
    port, ref, _ = _execute_pair(tmp_path, "p7-bf0", src,
                                 "-c:v h264_nvenc -preset p7 -bf 0 -b:v 15M")
    assert port == ref


def test_mp4_input_hq_identical(hq_mp4s, tmp_path):
    """An MP4 input (the hq output above: High profile, CABAC, B
    pictures, partitions) decoded on the host and encoded again with
    ``-p h264-nvenc-hq`` by both executors: the same MP4 bytes."""
    _, _, src = hq_mp4s
    port, ref, _ = _execute_pair(tmp_path, "again", src, HQ)
    assert port == ref
