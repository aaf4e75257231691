"""Producer: watch a directory, move videos to shared storage, publish tasks.

Copy of ``vcp_tpu/pipeline/producer.py``. The producer decides
everything (output directory and name, encode args, the verify flag) and
publishes a fully specified task; consumers only execute. Per-file flow:

  stability wait -> codec probe -> dedup rename (ns timestamp) ->
  move/copy to shared storage -> XADD publish -> on publish failure,
  roll back the shared copy.

``--mode all`` also enqueues the files already present at startup.
keep_local=True copies instead of moving.
"""

from __future__ import annotations

import os
import threading
import time
import uuid

from ..config import Config, resolve_encode_args
from ..logging import new_logger
from ..queue.stream import Stream, Task
from ..utils import fs
from .watcher import PollingWatcher


class Producer:
    def __init__(self, cfg: Config, cli_args: str = "", cli_preset: str = "",
                 poll_interval: float = 0.5,
                 stability_checks: int = 3, stability_interval: float = 0.5):
        self.cfg = cfg
        self.log = new_logger("producer")
        self.encode_args, self.args_source = resolve_encode_args(
            cfg, cli_args, cli_preset)
        self.stream = Stream(
            cfg.redis.address, cfg.redis.password, cfg.redis.db,
            max_stream_length=cfg.redis.stream_max_length,
            publish_rate_limit=cfg.redis.publish_rate_limit)
        self.source_ip = fs.get_local_ip()
        self.poll_interval = poll_interval
        self.stability_checks = stability_checks
        self.stability_interval = stability_interval
        self.published = 0
        self.failed = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._watcher: PollingWatcher | None = None
        self._inflight: list[threading.Thread] = []

    # ------------------------------------------------------------------
    def start(self) -> None:
        p = self.cfg.producer
        if not p.watch_directory or not p.shared_directory:
            raise ValueError("producer requires watch_directory and "
                             "shared_directory")
        os.makedirs(p.watch_directory, exist_ok=True)
        os.makedirs(p.shared_directory, exist_ok=True)
        if not self.stream.ping():
            raise ConnectionError("redis unreachable")
        self.log.info("producer starting",
                      watch=p.watch_directory, shared=p.shared_directory,
                      output=p.output_directory, mode=p.watch_mode,
                      args_source=self.args_source)
        if p.watch_mode == "all":
            self.process_existing_files()
        self._watcher = PollingWatcher(
            p.watch_directory, self._spawn_handle, self.poll_interval,
            file_filter=fs.is_video_file)
        self._watcher.start()

    def stop(self) -> None:
        self._stop.set()
        if self._watcher:
            self._watcher.stop()
        for t in list(self._inflight):
            t.join(timeout=10)
        self.stream.close()
        self.log.info("producer stopped", published=self.published,
                      failed=self.failed)

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
    def process_existing_files(self) -> int:
        """``--mode all``: enqueue files already in the watch dir."""
        count = 0
        try:
            entries = sorted(os.scandir(self.cfg.producer.watch_directory),
                             key=lambda e: e.name)
        except OSError:
            return 0
        for e in entries:
            if e.is_file() and fs.is_video_file(e.path):
                self.handle_new_file(e.path, wait_stable=False)
                count += 1
        return count

    def _spawn_handle(self, path: str) -> None:
        # Each create event is handled asynchronously.
        t = threading.Thread(target=self.handle_new_file, args=(path,),
                             daemon=True, name=f"handle-{os.path.basename(path)}")
        self._inflight.append(t)
        t.start()
        self._inflight = [x for x in self._inflight if x.is_alive()]

    # ------------------------------------------------------------------
    def handle_new_file(self, path: str, wait_stable: bool = True) -> str | None:
        """Full per-file flow. Returns the published message id, or None
        on failure."""
        name = os.path.basename(path)
        try:
            if wait_stable and not fs.wait_file_stable(
                    path, self.stability_checks, self.stability_interval):
                self.log.warn("file never stabilized", file=name)
                with self._lock:
                    self.failed += 1
                return None

            # Publish-time codec probe (header-only): reject payloads no
            # decoder of the package handles (e.g. VP9 in .webm) here,
            # with a precise reason, instead of letting the consumer fail
            # after the file moved to shared storage.
            from ..codec.probe import probe_reject_reason
            reason = probe_reject_reason(path)
            if reason is not None:
                self.log.warn("rejected at publish", file=name,
                              reason=reason)
                with self._lock:
                    self.failed += 1
                return None

            # Dedup-rename with a nanosecond timestamp when the shared
            # target already exists.
            shared_name = name
            shared_path = os.path.join(self.cfg.producer.shared_directory,
                                       shared_name)
            if os.path.exists(shared_path):
                stem, ext = os.path.splitext(name)
                shared_name = f"{stem}_{time.time_ns()}{ext}"
                shared_path = os.path.join(
                    self.cfg.producer.shared_directory, shared_name)

            if self.cfg.producer.keep_local:
                fs.copy_file(path, shared_path)
            else:
                fs.move_or_copy(path, shared_path)

            task = Task(
                id=f"{int(time.time())}_{uuid.uuid4().hex[:8]}",
                source_ip=self.source_ip,
                input_path=shared_path,
                original_name=name,
                output_dir=self.cfg.producer.output_directory,
                output_name=fs.generate_output_name(
                    shared_name, self.cfg.producer.output_prefix),
                ffmpeg_args=self.encode_args,
                verify_output=self.cfg.producer.verify_output,
            )
            try:
                msg_id = self.stream.publish(task)
            except Exception as e:
                # Roll back the shared-storage move on publish failure.
                try:
                    os.remove(shared_path)
                except OSError:
                    pass
                self.log.error("publish failed, rolled back shared copy",
                               file=name, error=str(e))
                with self._lock:
                    self.failed += 1
                return None

            with self._lock:
                self.published += 1
            self.log.task_start(task.id, file=name, shared=shared_path,
                                output=task.output_name, message_id=msg_id)
            return msg_id
        except Exception as e:
            self.log.error("handle file failed", file=name, error=str(e))
            with self._lock:
                self.failed += 1
            return None
