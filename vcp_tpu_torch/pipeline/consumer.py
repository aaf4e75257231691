"""Consumer: pull tasks from the stream, encode in-process on the card,
verify, ack.

Copy of ``vcp_tpu/pipeline/consumer.py``, with the same wire and the same
semantics, so consumers of either package can share one stream: one
blocking reader thread feeds a bounded queue drained by ``concurrency``
worker threads, shutdown drains for a bounded time, and **on any failure
the partial output is removed, the task is ACKed anyway and dropped, with
no retry.** Success ordering: delete the shared source -> record history
-> ACK last. History records the task's start and its completion or
failure.

What the port adds: a ``device`` argument (``"cuda"`` by default) that
every encode runs on. ``start()`` resolves it before it creates the
consumer group or starts a thread, so a consumer on a host without a
card raises there and acks nothing, where ack-and-drop would have turned
every queued task into a failure. A setting that is not ported yet
(``NotImplementedError`` from ``executor.execute``) is a failure like any
other: the task is acked and dropped with its text, and the worker lives
on.
"""

from __future__ import annotations

import os
import queue as queue_mod
import socket
import threading
import time

from ..codec.mp4 import verify_video_file
from ..config import Config
from ..device import resolve_device
from ..logging import new_logger
from ..queue.history import HistoryManager
from ..queue.stream import DEFAULT_GROUP, Stream, Task
from ..utils import fs
from . import executor


class Counters:
    def __init__(self):
        self._lock = threading.Lock()
        self.processed = 0
        self.succeeded = 0
        self.failed = 0

    def inc(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return {"processed": self.processed,
                    "succeeded": self.succeeded,
                    "failed": self.failed}


def auto_consumer_name() -> str:
    """``consumer_<host>_<pid>``."""
    return f"consumer_{socket.gethostname()}_{os.getpid()}"


class Consumer:
    def __init__(self, cfg: Config, name: str = "", concurrency: int = 0,
                 group: str = DEFAULT_GROUP, device: str = "cuda"):
        self.cfg = cfg
        self.device = device
        self.name = name or cfg.consumer.name or auto_consumer_name()
        self.concurrency = concurrency or cfg.consumer.concurrency
        self.group = group
        self.log = new_logger("consumer")
        self.stream = Stream(cfg.redis.address, cfg.redis.password,
                             cfg.redis.db)
        self.history = HistoryManager(self.stream.client)
        self.counters = Counters()
        # Bounded hand-off queue of 2x concurrency.
        self.task_q: queue_mod.Queue = queue_mod.Queue(
            maxsize=2 * self.concurrency)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------------
    def start(self) -> None:
        # Before anything touches the stream: without the device every
        # task would be acked as a failure.
        self.device = str(resolve_device(self.device))
        if not self.stream.ping():
            raise ConnectionError("redis unreachable")
        self.stream.create_consumer_group(group=self.group)
        self.log.info("consumer starting", name=self.name,
                      concurrency=self.concurrency, group=self.group,
                      device=self.device)
        for i in range(self.concurrency):
            t = threading.Thread(target=self._worker, args=(i,), daemon=True,
                                 name=f"vcp-worker-{i}")
            t.start()
            self._threads.append(t)
        reader = threading.Thread(target=self._reader, daemon=True,
                                  name="vcp-reader")
        reader.start()
        self._threads.append(reader)

    def stop(self, drain_timeout: float = 5.0) -> None:
        """Graceful shutdown with a bounded drain."""
        self._stop.set()
        deadline = time.monotonic() + drain_timeout
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        self.stream.close()
        snap = self.counters.snapshot()
        self.log.info("consumer stopped", **snap)

    def run_forever(self) -> None:
        self.start()
        try:
            while not self._stop.wait(0.5):
                pass
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    # ------------------------------------------------------------------
    def _reader(self) -> None:
        """Single blocking reader: XREADGROUP count=1 block=3s."""
        r_stream = Stream(self.cfg.redis.address, self.cfg.redis.password,
                          self.cfg.redis.db)
        while not self._stop.is_set():
            try:
                tasks = r_stream.read_group(self.group, self.name,
                                            count=1, block=3.0)
            except Exception as e:
                self.log.warn("read error", error=str(e))
                time.sleep(1.0)
                continue
            for task in tasks:
                while not self._stop.is_set():
                    try:
                        self.task_q.put(task, timeout=0.5)
                        break
                    except queue_mod.Full:
                        continue
        r_stream.close()

    def _worker(self, idx: int) -> None:
        while not self._stop.is_set():
            try:
                task = self.task_q.get(timeout=0.5)
            except queue_mod.Empty:
                continue
            try:
                self.process_task(task)
            finally:
                self.task_q.task_done()

    # ------------------------------------------------------------------
    def _fail(self, task: Task, reason: str, output_path: str | None = None
              ) -> None:
        """Uniform failure path: remove partial output, record history,
        ACK anyway, drop."""
        if output_path:
            try:
                os.remove(output_path)
            except OSError:
                pass
        try:
            self.history.record_task_failed(task.id, reason)
        except Exception:
            pass
        try:
            if task.message_id:
                self.stream.acknowledge(self.group, task.message_id)
        except Exception as e:
            self.log.warn("ack failed", task=task.id, error=str(e))
        self.counters.inc("failed")
        self.log.task_failed(task.id, reason)

    def process_task(self, task: Task) -> bool:
        """Full task lifecycle. Returns success."""
        self.counters.inc("processed")
        t_start = time.monotonic()
        self.log.task_start(task.id, input=task.input_path,
                            output=task.output_name, args=task.ffmpeg_args)

        # Invalid task → ack & drop.
        if not task.id or not task.input_path or not task.output_name:
            self._fail(task, "invalid task: missing fields")
            return False

        dispatch_sec = (max(0.0, time.time() - task.published_at)
                        if task.published_at else 0.0)
        if dispatch_sec:
            self.log.debug("dispatch latency", task=task.id,
                           dispatch=f"{dispatch_sec * 1000:.0f}ms")
        try:
            self.history.record_task_start(
                task.id, task.original_name, task.input_path,
                self.name, task.source_ip, dispatch_sec=dispatch_sec)
        except Exception:
            pass  # history is best-effort; never blocks the encode

        # Shared-storage visibility wait.
        wait_t0 = time.monotonic()
        if not fs.wait_for_file(task.input_path,
                                timeout=self.cfg.consumer.file_wait_timeout,
                                cancelled=self._stop.is_set):
            self._fail(task, f"input not visible within "
                             f"{self.cfg.consumer.file_wait_timeout:.0f}s: "
                             f"{task.input_path}")
            return False
        self.log.debug("input ready", task=task.id,
                       wait=f"{time.monotonic() - wait_t0:.2f}s")

        output_dir = task.output_dir or "."
        try:
            os.makedirs(output_dir, exist_ok=True)
        except OSError as e:
            self._fail(task, f"mkdir failed: {e}")
            return False
        output_path = os.path.join(output_dir, task.output_name)

        # The encode, in-process on the consumer's device.
        enc_t0 = time.monotonic()
        try:
            executor.execute(task.input_path, output_path, task.ffmpeg_args,
                             timeout=self.cfg.consumer.ffmpeg_timeout,
                             device=self.device)
        except (executor.EncodeError, NotImplementedError) as e:
            self._fail(task, f"encode failed: {e}", output_path)
            return False
        encode_secs = time.monotonic() - enc_t0

        # Verify.
        if task.verify_output and self.cfg.consumer.verify_output:
            ok, reason = verify_video_file(output_path)
            if not ok:
                self._fail(task, f"verify failed: {reason}", output_path)
                return False

        # Success ordering: delete source → history → ACK.
        try:
            os.remove(task.input_path)
        except OSError as e:
            self.log.warn("source delete failed", task=task.id, error=str(e))
        try:
            out_size = os.path.getsize(output_path)
        except OSError:
            out_size = 0
        try:
            self.history.record_task_complete(task.id, output_path, out_size)
        except Exception:
            pass
        try:
            self.stream.acknowledge(self.group, task.message_id)
        except Exception as e:
            # An un-ACKed success is a failure: the PEL entry will be
            # reclaimed after the source is gone, so don't count it done
            # twice.
            self.log.task_failed(task.id, f"ack failed after success: {e}")
            self.counters.inc("failed")
            return False
        self.counters.inc("succeeded")
        self.log.task_success(
            task.id, time.monotonic() - t_start,
            encode=f"{encode_secs:.2f}s",
            size=fs.format_file_size(out_size))
        return True
