"""The port's CLI against vcp_tpu's: the parser's subcommands and flags,
the text of ``--list-presets``, ``stats`` and ``clean`` on the same
server state, ``quality``, the config loader, and the producer's probe
and the consumer's output verification on good and bad files.
Tolerance 0 on every printed byte and value."""

import dataclasses
import io
import os
import struct
import time

import numpy as np
import pytest

from vcp_tpu import cli as j_cli
from vcp_tpu import config as j_config
from vcp_tpu.codec import mp4 as j_mp4
from vcp_tpu.codec.probe import probe_reject_reason as j_probe
from vcp_tpu.queue import miniredis as j_miniredis
from vcp_tpu_torch import cli as t_cli
from vcp_tpu_torch import config as t_config
from vcp_tpu_torch.codec import mp4 as t_mp4
from vcp_tpu_torch.codec.probe import probe_reject_reason as t_probe
from vcp_tpu_torch.codec.y4m import write_y4m
from vcp_tpu_torch.queue import history as t_history
from vcp_tpu_torch.queue import miniredis as t_miniredis
from vcp_tpu_torch.queue.history import HistoryManager
from vcp_tpu_torch.queue.stream import DEFAULT_GROUP, Stream, Task

from test_mkv import write_test_mkv
from test_mp4 import make_test_mp4, real_sps_pps
from test_probe import _write_vp9_webm
from video_util import synth_video

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW_MS = 1_700_000_000_000


def _subcommands(parser):
    [sub] = [a for a in parser._actions if a.choices and a.dest == "command"]
    return sub.choices


def _flags(parser):
    return sorted((tuple(a.option_strings), a.dest, repr(a.default),
                   repr(a.choices), a.nargs, a.type and a.type.__name__)
                  for a in parser._actions)


def test_parser_matches_vcp_tpu():
    j, t = _subcommands(j_cli.build_parser()), _subcommands(
        t_cli.build_parser())
    assert sorted(t) == sorted(j) == sorted(
        ["producer", "consumer", "stats", "clean", "redis-serve",
         "quality", "encode"])
    for name in j:
        extra = [f for f in _flags(t[name]) if f not in _flags(j[name])]
        missing = [f for f in _flags(j[name]) if f not in _flags(t[name])]
        assert missing == []
        assert extra == ([(("--device",), "device", "'cuda'", "None", None,
                           None)] if name in ("consumer", "encode") else [])
    args = t_cli.build_parser().parse_args(["consumer", "-j", "2"])
    assert (args.device, args.concurrency) == ("cuda", 2)


@pytest.mark.parametrize("config", ["", "config.example.yaml"])
def test_list_presets_equal(capsys, config):
    argv = ["producer", "--list-presets"] + (
        ["-c", os.path.join(REPO, config)] if config else [])
    assert j_cli.main(argv) == 0
    j = capsys.readouterr().out
    assert t_cli.main(argv) == 0
    assert capsys.readouterr().out == j
    assert "h264-nvenc" in j and "-c copy" in j


@pytest.mark.parametrize("path", [None, "config.example.yaml"])
def test_load_config_equal(path):
    p = os.path.join(REPO, path) if path else None
    j, t = j_config.load_config(p), t_config.load_config(p)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.get_all_presets() == j.get_all_presets()
    for cli_args, preset in (("", ""), ("", "copy"), ("-c copy", "h264-cpu"),
                             ("", "low-bitrate")):
        if preset == "low-bitrate" and not path:
            continue
        assert t_config.resolve_encode_args(t, cli_args, preset) \
            == j_config.resolve_encode_args(j, cli_args, preset)


@pytest.fixture(scope="module")
def t_server():
    srv = t_miniredis.MiniRedisServer(port=0)
    srv.start()
    yield srv
    srv.stop()


class _Clock:
    """time.time for the history writers, fixed at ``t``."""
    def __init__(self, t: float):
        self.t = t

    def time(self):
        return self.t


def _seed(address, monkeypatch, clock):
    s = Stream(address)
    s.create_consumer_group()
    for i in range(5):
        s.publish(Task(id=f"seed{i}", input_path=f"/s/{i}.mp4",
                       original_name=f"clip {i}.mp4", output_dir="/o",
                       output_name=f"{i}.mp4", ffmpeg_args="-c copy",
                       published_at=clock.t))
    s.read_group(DEFAULT_GROUP, "workerZ", count=2, block=0.1)
    s.read_group(DEFAULT_GROUP, "consumer_with_a_long_name_0123456789",
                 count=1, block=0.1)
    h = HistoryManager(s.client)
    with monkeypatch.context() as m:
        m.setattr(t_history, "time", clock)
        h.record_task_start("seed0", "clip 0.mp4", "/s/0.mp4", "cX",
                            "10.0.0.9", dispatch_sec=0.125)
        clock.t += 2.5
        h.record_task_complete("seed0", "/o/0.mp4", 42)
        h.record_task_start("seed1", "a" * 40 + ".mkv", "/s/1.mkv",
                            "consumer_with_a_long_name_0123456789",
                            dispatch_sec=0.375)
        clock.t += 1.0
        h.record_task_failed("seed1", "encode failed: boom")
        h.record_task_start("seed2", "c.y4m", "/s/2.y4m", "cX")
    s.close()


@pytest.fixture()
def servers(miniredis, t_server, monkeypatch):
    """Both packages' servers, flushed, on one frozen clock, seeded alike:
    5 tasks, 3 of them pending, history of one completed, one failed and
    one processing task."""
    for mod in (j_miniredis, t_miniredis):
        monkeypatch.setattr(mod, "_now_ms", lambda: NOW_MS)
    out = []
    t0 = float(int(time.time()) - 3600)     # an hour ago, on both servers
    for srv in (miniredis, t_server):
        srv.engine.dbs.clear()
        _seed(srv.address, monkeypatch, _Clock(t0))
        out.append(srv.address)
    return out


@pytest.mark.parametrize("view", [[], ["--pending"], ["--consumer"],
                                  ["--task", "seed0"], ["--task", "seed1"],
                                  ["--task", "nope"], ["--days", "0"]],
                         ids=["default", "pending", "consumer", "task",
                              "task-failed", "task-missing", "days-0"])
def test_stats_text_equal(servers, capsys, view):
    """The port's ``stats`` prints what vcp_tpu's ``run_stats`` prints on
    the same server state (vcp_tpu's reads the port's server too)."""
    j_addr, t_addr = servers
    rcs, outs = [], []
    for main, addr in ((j_cli.main, j_addr), (t_cli.main, t_addr),
                       (j_cli.main, t_addr)):
        rcs.append(main(["stats", "--redis", addr, *view]))
        outs.append(capsys.readouterr().out)
    assert rcs[1] == rcs[0] == rcs[2]
    assert outs[1] == outs[0] == outs[2]
    if not view:
        assert "stream length : 5" in outs[0]
        assert "completed : 1" in outs[0] and "failed    : 1" in outs[0]


@pytest.mark.parametrize("flags,answer", [
    (["--all", "-f"], None), (["--pending", "-f"], None),
    (["--consumed", "-f"], None), (["--all", "--pending"], "yes\n"),
    (["--all"], "no\n"), (["--consumed"], ""), ([], None),
], ids=["all", "pending", "consumed", "prompt-yes", "prompt-no",
        "prompt-eof", "no-target"])
def test_clean_text_equal(servers, capsys, monkeypatch, flags, answer):
    """``clean`` prints the same text, asks the same question and leaves
    the same state on the port's server as vcp_tpu's on its own."""
    import vcp_tpu.pipeline.clean as j_clean
    import vcp_tpu_torch.pipeline.clean as t_clean
    monkeypatch.setattr(j_clean, "TRIM_KEEP", 2)
    monkeypatch.setattr(t_clean, "TRIM_KEEP", 2)
    results = []
    for main, addr in zip((j_cli.main, t_cli.main), servers):
        if answer is not None:
            monkeypatch.setattr("sys.stdin", io.StringIO(answer))
        rc = main(["clean", "--redis", addr, *flags])
        s = Stream(addr)
        results.append((rc, capsys.readouterr().out,
                        dataclasses.asdict(s.get_queue_info()),
                        sorted(s.client.execute("KEYS", "*"))))
        s.close()
    assert results[1] == results[0]
    if flags == ["--all", "-f"]:
        assert results[0][3] == []
        assert "deleted stream and 3 history records" in results[0][1]


def _frames(seed, n, noise):
    rng = np.random.default_rng(seed)
    out = []
    for y, u, v in synth_video(64, 48, n):
        y = np.clip(y.astype(int) + rng.integers(-noise, noise + 1, y.shape),
                    0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("quality")
    paths = {}
    for name, seed, n, noise in (("ref", 0, 4, 0), ("test", 1, 4, 6),
                                 ("short", 2, 3, 3)):
        paths[name] = str(d / f"{name}.y4m")
        write_y4m(paths[name], _frames(seed, n, noise))
    return paths


@pytest.mark.parametrize("which,extra", [
    (("ref", "test"), []), (("ref", "test"), ["--frames", "2"]),
    (("ref", "short"), []), (("ref", "ref"), [])])
def test_quality_equal(videos, capsys, which, extra):
    argv = ["quality", videos[which[0]], videos[which[1]], *extra]
    assert j_cli.main(argv) == 0
    j = capsys.readouterr().out
    assert t_cli.main(argv) == 0
    assert capsys.readouterr().out == j
    assert j.startswith("frames=")


def _mp4_with_sps_of(path, w, h, sps_w, sps_h):
    """An avc1 MP4 whose SPS says one size and whose track another."""
    sps, pps = real_sps_pps(sps_w, sps_h)
    wr = j_mp4.Mp4Writer()
    tr = j_mp4.VideoTrack(codec="h264", width=w, height=h, timescale=30000,
                          sps=[sps], pps=[pps])
    nal = bytes([0x65]) + bytes(20)
    tr.samples.append(j_mp4.Sample(data=struct.pack(">I", len(nal)) + nal,
                                   duration=1000, is_sync=True))
    wr.add_track(tr)
    wr.write(str(path))
    return str(path)


@pytest.fixture(scope="module")
def probe_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("probe")
    files = {"good.mp4": make_test_mp4(d / "good.mp4"),
             "slow.mp4": make_test_mp4(d / "slow.mp4", faststart=False),
             "dims.mp4": _mp4_with_sps_of(d / "dims.mp4", 64, 48, 32, 32)}
    good = open(files["good.mp4"], "rb").read()
    for name, data in (("empty.mp4", b""), ("empty.mkv", b""),
                       ("trunc.mp4", good[:40]),
                       ("half.mp4", good[:len(good) // 2]),
                       ("text.mp4", b"not a video at all\n" * 4),
                       ("text.mkv", b"not a video at all\n"),
                       ("text.avi", b"RIFF\x04\x00\x00\x00WAVE"),
                       ("raw.y4m", b"YUV4MPEG2 W64 H48 F30:1\n")):
        files[name] = str(d / name)
        with open(files[name], "wb") as fh:
            fh.write(data)
    files["vp9.webm"] = str(d / "vp9.webm")
    _write_vp9_webm(files["vp9.webm"])
    sps, pps = real_sps_pps(64, 48)
    nal = bytes([0x65]) + bytes(20)
    files["h264.mkv"] = str(d / "h264.mkv")
    write_test_mkv(files["h264.mkv"], sps, pps,
                   [(struct.pack(">I", len(nal)) + nal, True)], 64, 48)
    files["missing.mp4"] = str(d / "missing.mp4")
    return files


def test_probe_and_verify_equal(probe_files):
    seen = {}
    for name, path in probe_files.items():
        j = (j_probe(path), j_mp4.verify_video_file(path))
        t = (t_probe(path), t_mp4.verify_video_file(path))
        assert t == j, name
        seen[name] = t
        if name.endswith(".mp4") and name not in ("empty.mp4",
                                                  "missing.mp4"):
            jr, tr = j_mp4.probe(path), t_mp4.probe(path)
            assert dataclasses.asdict(tr) == dataclasses.asdict(jr), name
    assert seen["good.mp4"] == (None, (True, ""))
    assert seen["vp9.webm"][0] is not None and "V_VP9" in seen["vp9.webm"][0]
    assert seen["empty.mp4"][1] == (False, "output file is empty")
    assert not seen["dims.mp4"][1][0] and "SPS dims" in seen["dims.mp4"][1][1]
    assert seen["h264.mkv"][0] is None
