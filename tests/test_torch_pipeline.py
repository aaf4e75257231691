"""The port's control plane end to end on the CPU: producer -> the port's
mini-redis -> consumer (``device="cpu"``), its failure semantics (ack and
drop), the publish-time probe, two consumers on one stream, both
directions across the packages (a vcp_tpu producer feeding a port
consumer and the reverse, on one server), an H.264 task through the
consumer against the port's own ``execute``, a setting not ported yet,
a consumer without its device, and the host library's first use from
several threads at once. Tolerance 0 on every byte."""

import dataclasses
import os
import threading
import time

import pytest
import torch

from vcp_tpu.config import Config as JConfig
from vcp_tpu.pipeline.consumer import Consumer as JConsumer
from vcp_tpu.pipeline.producer import Producer as JProducer
from vcp_tpu_torch import native
from vcp_tpu_torch.codec.y4m import write_y4m
from vcp_tpu_torch.config import BUILTIN_PRESETS, Config
from vcp_tpu_torch.native import build as native_build
from vcp_tpu_torch.pipeline import executor
from vcp_tpu_torch.pipeline.consumer import Consumer
from vcp_tpu_torch.pipeline.producer import Producer
from vcp_tpu_torch.queue.history import HistoryManager
from vcp_tpu_torch.queue.miniredis import MiniRedisServer
from vcp_tpu_torch.queue.stream import DEFAULT_GROUP, Stream, Task

from test_mp4 import make_test_mp4
from test_probe import _write_vp9_webm
from video_util import synth_video


@pytest.fixture(scope="module")
def t_server():
    srv = MiniRedisServer(port=0)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture()
def address(t_server):
    t_server.engine.dbs.clear()
    return t_server.address


def make_cfg(address, tmp_path, cls=Config):
    cfg = cls()
    cfg.redis.address = address
    cfg.producer.watch_directory = str(tmp_path / "raw")
    cfg.producer.shared_directory = str(tmp_path / "shared")
    cfg.producer.output_directory = str(tmp_path / "encoded")
    cfg.producer.ffmpeg_preset = "copy"
    cfg.consumer.file_wait_timeout = 5.0
    cfg.consumer.ffmpeg_timeout = 60.0
    return cfg


def wait_until(pred, timeout=15.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def fast_producer(cls, cfg):
    return cls(cfg, poll_interval=0.05, stability_checks=2,
               stability_interval=0.02)


def test_copy_end_to_end_bit_identical(address, tmp_path):
    cfg = make_cfg(address, tmp_path)
    os.makedirs(cfg.producer.watch_directory)
    producer = fast_producer(Producer, cfg)
    consumer = Consumer(cfg, name="c_test", concurrency=2, device="cpu")
    producer.start()
    consumer.start()
    try:
        src = make_test_mp4(tmp_path / "stage.mp4", n_samples=30)
        original = open(src, "rb").read()
        os.rename(src, os.path.join(cfg.producer.watch_directory,
                                    "movie.mp4"))
        assert wait_until(lambda: consumer.counters.succeeded >= 1), \
            consumer.counters.snapshot()
        out = os.path.join(cfg.producer.output_directory, "movie.mp4")
        assert open(out, "rb").read() == original
        assert os.listdir(cfg.producer.shared_directory) == []
        s = Stream(address)
        info = s.get_queue_info()
        assert (info.length, info.pending) == (0, 0)
        stats = HistoryManager(s.client).get_stats()
        assert stats["completed"] == 1
        rec = stats["records"][0]
        assert (rec.consumer, rec.output_size) == ("c_test", len(original))
    finally:
        consumer.stop()
        producer.stop()


def test_producer_mode_all_and_dedup(address, tmp_path):
    cfg = make_cfg(address, tmp_path)
    cfg.producer.watch_mode = "all"
    os.makedirs(cfg.producer.watch_directory)
    os.makedirs(cfg.producer.shared_directory)
    make_test_mp4(os.path.join(cfg.producer.watch_directory, "pre.mp4"))
    make_test_mp4(os.path.join(cfg.producer.shared_directory, "pre.mp4"))
    producer = Producer(cfg, poll_interval=0.05)
    producer.start()
    try:
        assert producer.published == 1
        shared = os.listdir(cfg.producer.shared_directory)
        deduped = [f for f in shared if f != "pre.mp4"]
        assert len(shared) == 2 and len(deduped) == 1
        assert deduped[0].startswith("pre_") and deduped[0].endswith(".mp4")
        s = Stream(address)
        s.create_consumer_group()
        [task] = s.read_group(DEFAULT_GROUP, "x", block=0.2)
        assert task.original_name == "pre.mp4"
        assert task.output_name == deduped[0]
        assert task.ffmpeg_args == "-c copy" and task.verify_output
    finally:
        producer.stop()


def test_non_video_files_ignored(address, tmp_path):
    cfg = make_cfg(address, tmp_path)
    producer = fast_producer(Producer, cfg)
    producer.start()
    try:
        for name in ("notes.txt", "clip.mp4.part"):
            with open(os.path.join(cfg.producer.watch_directory, name),
                      "w") as f:
                f.write("hello")
        time.sleep(0.3)
        assert (producer.published, producer.failed) == (0, 0)
        assert Stream(address).get_queue_info().length == 0
    finally:
        producer.stop()


def _missing(tmp_path):
    return Task(id="ghost", input_path=str(tmp_path / "missing.mp4"),
                original_name="missing.mp4",
                output_dir=str(tmp_path / "enc"), output_name="missing.mp4",
                ffmpeg_args="-c copy", verify_output=True), "not visible"


def _invalid(tmp_path):
    return Task(id="", input_path="", original_name="", output_dir="",
                output_name="", ffmpeg_args="-c copy"), None


def _weird_mkv(tmp_path):
    bad = tmp_path / "weird.mkv"
    bad.write_bytes(b"\x1a\x45\xdf\xa3 fake matroska")
    return Task(id="mkvtask", input_path=str(bad), original_name="weird.mkv",
                output_dir=str(tmp_path / "enc"), output_name="weird.mp4",
                ffmpeg_args="-c copy", verify_output=True), "encode failed"


@pytest.mark.parametrize("make", [_missing, _invalid, _weird_mkv],
                         ids=["missing-input", "invalid-task",
                              "unsupported-container"])
def test_failure_ack_and_drop(address, tmp_path, make):
    """Any failure: the partial output goes, the failure is recorded, the
    task is acked, deleted from the stream and not retried."""
    cfg = make_cfg(address, tmp_path)
    task, reason = make(tmp_path)
    if make is _missing:
        cfg.consumer.file_wait_timeout = 0.3
    s = Stream(address)
    s.create_consumer_group()
    s.publish(task)
    consumer = Consumer(cfg, name="c_fail", concurrency=1, device="cpu")
    consumer.start()
    try:
        assert wait_until(lambda: consumer.counters.failed >= 1)
        assert consumer.counters.snapshot() == {
            "processed": 1, "succeeded": 0, "failed": 1}
        info = s.get_queue_info()
        assert (info.length, info.pending) == (0, 0)
        if task.output_name:
            assert not os.path.exists(tmp_path / "enc" / task.output_name)
        if reason:
            rec = HistoryManager(s.client).get_task_history(task.id)
            assert rec.status == "failed" and reason in rec.error
            assert rec.consumer == "c_fail"
    finally:
        consumer.stop()


def test_vp9_webm_rejected_at_publish(address, tmp_path):
    cfg = make_cfg(address, tmp_path)
    os.makedirs(cfg.producer.watch_directory)
    path = os.path.join(cfg.producer.watch_directory, "clip.webm")
    _write_vp9_webm(path)
    producer = fast_producer(Producer, cfg)
    try:
        assert producer.handle_new_file(path) is None
        assert (producer.published, producer.failed) == (0, 1)
        assert os.path.exists(path)                 # never moved
        shared = cfg.producer.shared_directory
        assert not os.path.isdir(shared) or os.listdir(shared) == []
        assert Stream(address).get_queue_info().length == 0
    finally:
        producer.stream.close()


def test_two_consumers_share_the_tasks(address, tmp_path):
    cfg = make_cfg(address, tmp_path)
    shared = tmp_path / "shared"
    os.makedirs(shared)
    outdir = tmp_path / "encoded"
    s = Stream(address)
    s.create_consumer_group()
    n = 6
    for i in range(n):
        src = make_test_mp4(shared / f"in_{i}.mp4", n_samples=3 + i)
        s.publish(Task(id=f"t{i}", input_path=src,
                       original_name=f"in_{i}.mp4", output_dir=str(outdir),
                       output_name=f"out_{i}.mp4", ffmpeg_args="-c copy",
                       verify_output=True))
    # one worker each: a consumer holds at most 4 of the 6 tasks (one
    # encoding, two queued, one in its reader's hand), so the other one
    # gets work too
    consumers = [Consumer(cfg, name=f"multi_{k}", concurrency=1,
                          device="cpu") for k in range(2)]
    for c in consumers:
        c.start()
    try:
        assert wait_until(lambda: sum(c.counters.succeeded
                                      for c in consumers) >= n, timeout=30)
        assert s.get_queue_info().pending == 0
        assert sorted(os.listdir(outdir)) == [f"out_{i}.mp4"
                                              for i in range(n)]
        assert all(c.counters.succeeded > 0 for c in consumers)
        recs = HistoryManager(s.client).get_all_history()
        assert sorted(r.consumer for r in recs) == sorted(
            c.name for c in consumers for _ in range(c.counters.succeeded))
    finally:
        stops = [threading.Thread(target=c.stop) for c in consumers]
        for t in stops:
            t.start()
        for t in stops:
            t.join(timeout=30)


def _masked_history(address, root):
    """History records with the run's times, IDs and paths taken out."""
    out = []
    for r in HistoryManager(Stream(address).client).get_all_history():
        d = dataclasses.asdict(r)
        for k in ("task_id", "start_time", "end_time", "duration_sec",
                  "dispatch_sec"):
            d[k] = bool(d[k])
        for k in ("input_path", "output_path"):
            d[k] = os.path.relpath(d[k], root)
        out.append(d)
    return out


def _run_pair(server, root, pcls, ccls, cfgcls):
    """One file through a producer and a consumer of the given classes on
    ``server``; returns what the run left behind."""
    server.engine.dbs.clear()
    cfg = make_cfg(server.address, root, cfgcls)
    os.makedirs(cfg.producer.watch_directory)
    producer = fast_producer(pcls, cfg)
    kw = {"device": "cpu"} if ccls is Consumer else {}
    consumer = ccls(cfg, name="x", concurrency=1, **kw)
    producer.start()
    consumer.start()
    try:
        src = make_test_mp4(root / "stage.mp4", n_samples=12)
        original = open(src, "rb").read()
        os.rename(src, os.path.join(cfg.producer.watch_directory,
                                    "movie.mp4"))
        assert wait_until(lambda: consumer.counters.succeeded >= 1), \
            consumer.counters.snapshot()
    finally:
        consumer.stop()
        producer.stop()
    out = open(os.path.join(cfg.producer.output_directory, "movie.mp4"),
               "rb").read()
    s = Stream(server.address)
    groups = [{k: v for k, v in g.items() if k != "last-delivered-id"}
              for g in s.get_consumer_groups()]
    return (out == original, dataclasses.asdict(s.get_queue_info()), groups,
            os.listdir(cfg.producer.shared_directory),
            _masked_history(server.address, root),
            consumer.counters.snapshot())


@pytest.fixture(scope="module")
def torch_pair(t_server, tmp_path_factory):
    """The port's own producer and consumer, the state to match."""
    state = _run_pair(t_server, tmp_path_factory.mktemp("pair"), Producer,
                      Consumer, Config)
    assert state[0] and state[1] == {"length": 0, "pending": 0, "groups": 1}
    assert [r["status"] for r in state[4]] == ["completed"]
    return state


@pytest.mark.parametrize("pair", ["tpu->torch", "torch->tpu"])
def test_cross_package_round_trip(t_server, torch_pair, tmp_path, pair):
    """One server; a producer of one package and a consumer of the other
    give the output, queue state and history of the port's own pair."""
    classes = ((JProducer, Consumer, JConfig) if pair == "tpu->torch"
               else (Producer, JConsumer, Config))
    assert _run_pair(t_server, tmp_path, *classes) == torch_pair


def _small_y4m(path, n=3):
    write_y4m(str(path), synth_video(64, 48, n))
    return str(path)


def test_h264_task_equals_execute(address, tmp_path):
    """A 64x48 ``-p h264-nvenc`` task through the consumer writes the
    bytes of the port's own ``execute`` on the same file (which
    test_torch_encoder.py holds to vcp_tpu)."""
    cfg = make_cfg(address, tmp_path)
    src = _small_y4m(tmp_path / "in.y4m")
    direct = str(tmp_path / "direct.mp4")
    executor.execute(src, direct, BUILTIN_PRESETS["h264-nvenc"],
                     device="cpu")
    s = Stream(address)
    s.create_consumer_group()
    s.publish(Task(id="h264", input_path=src, original_name="in.y4m",
                   output_dir=str(tmp_path / "enc"), output_name="in.mp4",
                   ffmpeg_args=BUILTIN_PRESETS["h264-nvenc"],
                   verify_output=True))
    consumer = Consumer(cfg, name="c_h264", concurrency=2, device="cpu")
    consumer.start()
    try:
        assert wait_until(lambda: consumer.counters.succeeded >= 1,
                          timeout=120), consumer.counters.snapshot()
    finally:
        consumer.stop()
    with open(direct, "rb") as a, open(tmp_path / "enc" / "in.mp4",
                                       "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(src)
    assert s.get_queue_info().length == 0


def test_not_ported_setting_acked_and_dropped(address, tmp_path,
                                              monkeypatch):
    """A setting the encoder does not take (its NotImplementedError; every
    H.264 setting runs now, so the encoder is made to raise) fails the
    task with the not-ported text; the task is acked and dropped and the
    same worker goes on to the next task."""
    from vcp_tpu_torch.codec.h264 import encoder

    def not_ported(*a, **kw):
        raise NotImplementedError("not ported yet: a setting (ROADMAP A10)")

    monkeypatch.setattr(encoder, "encode_stream", not_ported)
    cfg = make_cfg(address, tmp_path)
    src = _small_y4m(tmp_path / "in.y4m", n=2)
    mp4 = make_test_mp4(tmp_path / "next.mp4")
    s = Stream(address)
    s.create_consumer_group()
    for tid, path, args in (("cavlc", src, BUILTIN_PRESETS["h264-nvenc"]),
                            ("after", mp4, "-c copy")):
        s.publish(Task(id=tid, input_path=path,
                       original_name=os.path.basename(path),
                       output_dir=str(tmp_path / "enc"),
                       output_name=f"{tid}.mp4", ffmpeg_args=args,
                       verify_output=True))
    consumer = Consumer(cfg, name="c_cavlc", concurrency=1, device="cpu")
    consumer.start()
    try:
        assert wait_until(lambda: consumer.counters.processed >= 2
                          and consumer.counters.succeeded
                          + consumer.counters.failed >= 2, timeout=60)
        assert consumer.counters.snapshot() == {
            "processed": 2, "succeeded": 1, "failed": 1}
        [worker] = [t for t in consumer._threads
                    if t.name == "vcp-worker-0"]
        assert worker.is_alive()
    finally:
        consumer.stop()
    rec = HistoryManager(s.client).get_task_history("cavlc")
    assert rec.status == "failed" and "not ported" in rec.error \
        and "A10" in rec.error
    assert not os.path.exists(tmp_path / "enc" / "cavlc.mp4")
    assert os.path.exists(src)               # the source stays on failure
    info = s.get_queue_info()
    assert (info.length, info.pending) == (0, 0)


def test_cavlc_task_matches_vcp_tpu(address, tmp_path, monkeypatch):
    """A ``VCP_CABAC=0`` task (CAVLC) succeeds in the port's consumer, and
    its MP4 equals vcp_tpu's encode of the same task byte for byte."""
    from vcp_tpu.pipeline import executor as j_executor
    monkeypatch.setenv("VCP_CABAC", "0")
    cfg = make_cfg(address, tmp_path)
    src = _small_y4m(tmp_path / "in.y4m", n=2)
    ref = str(tmp_path / "ref.mp4")
    j_executor.execute(src, ref, BUILTIN_PRESETS["h264-nvenc"])
    s = Stream(address)
    s.create_consumer_group()
    s.publish(Task(id="cavlc", input_path=src, original_name="in.y4m",
                   output_dir=str(tmp_path / "enc"), output_name="in.mp4",
                   ffmpeg_args=BUILTIN_PRESETS["h264-nvenc"],
                   verify_output=True))
    consumer = Consumer(cfg, name="c_cavlc_ok", concurrency=1, device="cpu")
    consumer.start()
    try:
        assert wait_until(lambda: consumer.counters.succeeded >= 1,
                          timeout=120), consumer.counters.snapshot()
    finally:
        consumer.stop()
    with open(ref, "rb") as a, open(tmp_path / "enc" / "in.mp4",
                                    "rb") as b:
        assert a.read() == b.read()
    assert HistoryManager(s.client).get_task_history("cavlc").status \
        == "completed"


def test_consumer_without_card_acks_nothing(address, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_cfg(address, tmp_path)
    s = Stream(address)
    s.publish(Task(id="queued", input_path="/s/a.mp4", output_name="a.mp4",
                   ffmpeg_args="-c copy"))
    consumer = Consumer(cfg, name="c_nocard")       # device="cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        consumer.start()
    assert consumer._threads == []
    assert s.get_consumer_groups() == []
    info = s.get_queue_info()
    assert (info.length, info.pending, info.groups) == (1, 0, 0)
    assert HistoryManager(s.client).get_all_history() == []
    consumer.stream.close()


def test_host_library_first_use_from_threads(tmp_path, monkeypatch):
    """Four threads reach the host library at once on a cold cache: one
    g++ runs, all four get the same handle, no temporary file is left."""
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    real_run = native_build.subprocess.run
    calls = []

    def run(cmd, *a, **kw):
        calls.append(cmd[0])
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(native_build.subprocess, "run", run)
    native.get_lib.cache_clear()
    libs, errors = [], []
    barrier = threading.Barrier(4)

    def first_use():
        barrier.wait()
        try:
            libs.append(native.get_lib())
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert errors == [] and len(libs) == 4
        assert all(lib is libs[0] for lib in libs)
        assert calls == ["g++"]
        assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []
        assert [f for f in os.listdir(tmp_path) if f.endswith(".so")] \
            == [os.path.basename(libs[0]._name)]
    finally:
        native.get_lib.cache_clear()
