"""The shipped quality preset of vcp_tpu_torch, ``-p h264-cpu``
(``-c:v libx264 -preset medium -crf 23``: 2 B pictures, partitioned P
anchors with intra MBs, half-pel ME, adaptive 8x8 transform, RD intra
IDR), and the speed shape with B pictures (``-c:v h264_nvenc -preset p4
-bf 2``) against vcp_tpu on the CPU: byte-identical NAL units and MP4
files, composition offsets (ctts) included.

vcp_tpu reads VCP_HIER_ME while it traces and caches the trace by frame
size and static arguments, so the case with VCP_HIER_ME=0 uses a frame
width (W0) that no other test encodes."""

import struct

import numpy as np
import pytest

from test_torch_encoder_quality import moving_frames
from vcp_tpu.cli import resolve_encode_args as j_resolve
from vcp_tpu.codec.h264 import encoder as je
from vcp_tpu.codec.y4m import write_y4m
from vcp_tpu.config import load_config as j_load_config
from vcp_tpu.pipeline import executor as j_executor
from vcp_tpu_torch import cli as t_cli
from vcp_tpu_torch.codec import mp4 as t_mp4
from vcp_tpu_torch.codec.h264 import bframe as t_bframe
from vcp_tpu_torch.codec.h264 import encoder as te
from vcp_tpu_torch.codec.h264 import entropy as t_entropy
from vcp_tpu_torch.ops import motion as t_motion

W, H = 96, 64
W0 = 224                     # frame width of the VCP_HIER_ME=0 case


def _config(bframes, w=W, **kw):
    return dict(width=w, height=H, qp=25, gop_size=30, effort=5,
                transform8=True, parts=True, bframes=bframes, **kw)


def _assert_streams_equal(fr, kw):
    sps_j, pps_j, sam_j = je.encode_stream(fr, je.EncoderConfig(**kw))
    sps_t, pps_t, sam_t = te.encode_stream(fr, te.EncoderConfig(**kw),
                                           device="cpu")
    assert (sps_t, pps_t) == (sps_j, pps_j)
    assert len(sam_t) == len(sam_j)
    for k, (a, b) in enumerate(zip(sam_t, sam_j)):
        assert tuple(a) == tuple(b), f"access unit {k} differs"
    return sam_t


@pytest.mark.parametrize("bframes,cts", [
    (1, [1, 2, 0, 2, 0, 2, 0]),
    (2, [1, 3, 0, 0, 3, 0, 0]),
    (3, [1, 4, 0, 0, 0, 2, 0]),
])
def test_encode_stream_b_gop(bframes, cts):
    """One 7-frame GOP: IDR, P anchors every bframes+1 frames (and on the
    last frame), B pictures between them, in decode order."""
    sam = _assert_streams_equal(moving_frames(7), _config(bframes))
    assert [s[2] for s in sam] == cts == _gop_cts(7, bframes)
    assert [s[1] for s in sam] == [True] + [False] * 6


def test_encode_stream_scene_cut():
    """A cut at frame 5 starts a second GOP; its two frames take the
    non-B path (2-tuples), as in vcp_tpu."""
    sam = _assert_streams_equal(moving_frames(7, cut=5), _config(2))
    assert [len(s) for s in sam] == [3] * 5 + [2] * 2
    assert [s[1] for s in sam] == [True] + [False] * 4 + [True, False]


def _ctts(path):
    """The (count, offset) runs of the file's ctts box, or None."""
    with open(path, "rb") as fh:
        buf = fh.read()
    box = t_mp4.find_box(buf, [b"moov", b"trak", b"mdia", b"minf", b"stbl",
                               b"ctts"])
    if box is None:
        return None
    n, = struct.unpack_from(">I", buf, box[0] + 4)
    return [struct.unpack_from(">II", buf, box[0] + 8 + 8 * i)
            for i in range(n)]


def _gop_cts(n: int, b: int) -> list[int]:
    """Composition offsets (frames) of one GOP of n frames in decode
    order: anchors every b+1 display frames and on the last one."""
    if b == 0 or n <= 2:
        return [0] * n
    anchors = list(range(0, n, b + 1))
    if anchors[-1] != n - 1:
        anchors.append(n - 1)
    order = [0]
    for prev, a in zip(anchors, anchors[1:]):
        order += [a, *range(prev + 1, a)]
    return [disp - dec + 1 for dec, disp in enumerate(order)]


def _runs(offsets: list[int], dur: int):
    runs = []
    for o in offsets:
        if runs and runs[-1][1] == o * dur:
            runs[-1] = (runs[-1][0] + 1, o * dur)
        else:
            runs.append((1, o * dur))
    return runs


def _mp4_pair(tmp_path, frames, j_args, t_argv):
    src = str(tmp_path / "in.y4m")
    write_y4m(src, frames, fps_num=6)
    ref, out = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    j_executor.execute(src, ref, j_args)
    assert t_cli.main(["encode", src, out, *t_argv, "--device", "cpu"]) == 0
    with open(ref, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
    return out


def test_cli_preset_h264_cpu(tmp_path):
    """``-p h264-cpu`` through the port's CLI equals what vcp_tpu's CLI
    resolves the preset to and encodes; the 6-fps Y4M with a cut at frame
    9 makes GOPs of 6, 3 and 4 frames, and the ctts box carries the B
    pictures' composition offsets."""
    j_args, _ = j_resolve(j_load_config(None), "", "h264-cpu")
    assert "-preset medium" in j_args and "-bf" not in j_args
    out = _mp4_pair(tmp_path, moving_frames(13, cut=9), j_args,
                    ["-p", "h264-cpu"])
    # GOPs of 6, 3 (cut at 9) and 4 frames; frame duration 1000 ticks
    assert _ctts(out) == _runs(
        _gop_cts(6, 2) + _gop_cts(3, 2) + _gop_cts(4, 2), 1000)


@pytest.mark.parametrize("ffargs,w,env", [
    # constant quality, then ABR: a bitrate this small makes the rate
    # controller move the QP (and with it lambda2) per GOP
    ("-c:v libx264 -preset medium -bf 3 -crf 27 -movflags +faststart", W,
     {}),
    ("-c:v libx264 -preset medium -b:v 3k -movflags +faststart", W, {}),
    ("-c:v libx264 -preset medium -b:v 10M", W0, {"VCP_HIER_ME": "0"}),
    # effort 6: the same tools, B pictures searched over +-16
    ("-c:v libx264 -preset slow -bf 1 -crf 26", W, {}),
    # the speed shape with B pictures: full-pel ME, the fused search +
    # prediction kernel's plain version at +-8 (B) and +-24 (anchors)
    ("-c:v h264_nvenc -preset p4 -bf 2 -b:v 10M", W, {}),
])
def test_encode_file_mp4_identical(tmp_path, monkeypatch, ffargs, w, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = _mp4_pair(tmp_path, moving_frames(13, w=w, cut=9), ffargs,
                    [f"--ffmpeg-args={ffargs}"])
    assert _ctts(out) is not None


def test_h264_cpu_uses_its_tools(monkeypatch):
    """The preset really runs what this path adds: P slices with intra
    and with partitioned MBs, B slices with all three modes and with MBs
    coded without residual, and the pyramid search with partitions."""
    seen = {"intra": 0, "parts": 0, "modes": set(), "no_res": 0,
            "hier_parts": 0}
    real_p, real_b = t_entropy.write_pslice, t_bframe.write_bslice
    real_hp = t_motion.hier_search_parts

    def spy_p(*a, **kw):
        d = kw["data"]
        seen["intra"] += int(d["intra"].sum())
        seen["parts"] += int((d["parts"] > 0).sum())
        return real_p(*a, **kw)

    def spy_b(*a, **kw):
        d = kw["data"]
        seen["modes"] |= set(np.unique(d["mode"]).tolist())
        seen["no_res"] += int((d["luma"] == 0).all(axis=(-1, -2)).sum())
        return real_b(*a, **kw)

    def spy_hp(*a, **kw):
        seen["hier_parts"] += 1
        return real_hp(*a, **kw)

    monkeypatch.setattr(t_entropy, "write_pslice", spy_p)
    monkeypatch.setattr(t_bframe, "write_bslice", spy_b)
    monkeypatch.setattr(t_motion, "hier_search_parts", spy_hp)
    enc = te.H264Encoder(te.EncoderConfig(**_config(2)), device="cpu")
    sam = enc.encode_gop(moving_frames(7))
    assert len(sam) == 7 and seen["hier_parts"] == 2
    assert seen["intra"] > 0 and seen["parts"] > 0, seen
    assert seen["modes"] == {0, 1, 2} and seen["no_res"] > 0, seen
    assert enc.stage_s["b"] > 0 and enc.stage_s["p"] > 0
