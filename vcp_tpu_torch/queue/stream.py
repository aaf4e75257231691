"""Redis Stream task queue wrapper.

Copy of ``vcp_tpu/queue/stream.py``, on the same wire: stream
``vcp:tasks``, consumer group ``gpu_encoders``, the XADD field schema of
:meth:`Task.to_fields`, XGROUP CREATE MKSTREAM from "0" tolerating
BUSYGROUP, XREADGROUP ">", acknowledge as XACK + XDEL, and the queue
introspection and cleanup APIs behind ``stats`` and ``clean``. So
consumers of either package can share one stream. The publish
token-bucket rate limiter is thread-safe, and ``read_pending_tasks`` /
``retry_task`` are usable.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from .resp import RedisClient, RedisError, decode, pairs_to_dict

DEFAULT_STREAM = "vcp:tasks"
DEFAULT_GROUP = "gpu_encoders"
MAX_RETRY_COUNT = 3
MAX_STREAM_LENGTH = 1000
PUBLISH_RATE_LIMIT = 100     # tasks/second


@dataclasses.dataclass
class Task:
    """Wire task, fully specified by the producer."""
    id: str = ""
    message_id: str = ""
    source_ip: str = ""
    retry: int = 0
    input_path: str = ""
    original_name: str = ""
    output_dir: str = ""
    output_name: str = ""
    ffmpeg_args: str = ""
    verify_output: bool = False
    published_at: float = 0.0   # unix seconds; extra field, schema-tolerated

    def to_fields(self) -> dict[str, str]:
        """Flat string map: the XADD field schema."""
        return {
            "task_id": self.id,
            "input_path": self.input_path,
            "original_name": self.original_name,
            "output_dir": self.output_dir,
            "output_name": self.output_name,
            "ffmpeg_args": self.ffmpeg_args,
            "verify_output": "true" if self.verify_output else "false",
            "source_ip": self.source_ip,
            "retry": str(self.retry),
            "published_at": repr(self.published_at) if self.published_at
            else "",
        }

    @classmethod
    def from_fields(cls, message_id: str, fields: dict[str, str]) -> "Task":
        """Tolerant field-by-field decode."""
        def get(k, default=""):
            return fields.get(k, default)
        try:
            retry = int(get("retry", "0") or 0)
        except ValueError:
            retry = 0
        try:
            published_at = float(get("published_at", "0") or 0.0)
        except ValueError:
            published_at = 0.0
        return cls(
            id=get("task_id"),
            message_id=message_id,
            source_ip=get("source_ip"),
            retry=retry,
            input_path=get("input_path"),
            original_name=get("original_name"),
            output_dir=get("output_dir"),
            output_name=get("output_name"),
            ffmpeg_args=get("ffmpeg_args"),
            verify_output=get("verify_output") == "true",
            published_at=published_at,
        )


@dataclasses.dataclass
class QueueInfo:
    length: int = 0
    pending: int = 0
    groups: int = 0


class RateLimiter:
    """Thread-safe token bucket."""

    def __init__(self, rate_per_sec: int):
        self.max_tokens = max(1, rate_per_sec)
        self.tokens = float(self.max_tokens)
        self.last = time.monotonic()
        self._lock = threading.Lock()

    def allow(self) -> bool:
        with self._lock:
            now = time.monotonic()
            self.tokens = min(
                float(self.max_tokens),
                self.tokens + (now - self.last) * self.max_tokens)
            self.last = now
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            return False


class Stream:
    """Task queue over Redis Streams."""

    def __init__(self, address: str, password: str = "", db: int = 0,
                 stream: str = DEFAULT_STREAM,
                 max_stream_length: int = MAX_STREAM_LENGTH,
                 publish_rate_limit: int = PUBLISH_RATE_LIMIT):
        self.client = RedisClient(address, password, db)
        self.stream = stream
        self.max_stream_length = max_stream_length
        self.publish_limiter = RateLimiter(publish_rate_limit)

    # -- lifecycle ----------------------------------------------------------
    def ping(self) -> bool:
        return self.client.ping()

    def close(self) -> None:
        self.client.close()

    # -- group management -----------------------------------------------
    def create_consumer_group(self, stream: str | None = None,
                              group: str = DEFAULT_GROUP) -> None:
        """XGROUP CREATE ... 0 MKSTREAM, tolerating BUSYGROUP."""
        stream = stream or self.stream
        try:
            self.client.execute("XGROUP", "CREATE", stream, group, "0",
                                "MKSTREAM")
        except RedisError as e:
            if not str(e).startswith("BUSYGROUP"):
                raise

    # -- publish ----------------------------------------------------------
    def publish(self, task: Task) -> str:
        """XADD with rate limit + one 10 ms-sleep retry.

        Trims to ``max_stream_length`` (approximate) on publish so the
        stream honors the configured retention.
        """
        if not self.publish_limiter.allow():
            time.sleep(0.01)
            if not self.publish_limiter.allow():
                raise RedisError("publish rate limited")
        if not task.published_at:
            task.published_at = time.time()
        args = ["XADD", self.stream, "MAXLEN", "~",
                str(self.max_stream_length), "*"]
        for k, v in task.to_fields().items():
            args += [k, v]
        msg_id = self.client.execute(*args)
        return decode(msg_id)

    # -- consume ----------------------------------------------------------
    def _parse_read_reply(self, reply) -> list[Task]:
        tasks: list[Task] = []
        if not reply:
            return tasks
        for _stream_key, entries in reply:
            for entry in entries:
                msg_id, flat = entry[0], entry[1]
                if flat is None:
                    continue
                fields = {k: decode(v) for k, v in pairs_to_dict(flat).items()}
                tasks.append(Task.from_fields(decode(msg_id), fields))
        return tasks

    def read_group(self, group: str, consumer: str, count: int = 1,
                   block: float = 3.0) -> list[Task]:
        """XREADGROUP ... >. ``block`` in seconds."""
        reply = self.client.execute(
            "XREADGROUP", "GROUP", group, consumer,
            "COUNT", str(count), "BLOCK", str(int(block * 1000)),
            "STREAMS", self.stream, ">",
            block_timeout=block)
        return self._parse_read_reply(reply)

    def read_pending_tasks(self, group: str, consumer: str,
                           count: int = 10) -> list[Task]:
        """Re-read this consumer's own PEL from "0"."""
        reply = self.client.execute(
            "XREADGROUP", "GROUP", group, consumer,
            "COUNT", str(count), "STREAMS", self.stream, "0")
        return self._parse_read_reply(reply)

    # -- acknowledge ----------------------------------------------------
    def acknowledge(self, group: str, message_id: str) -> None:
        """XACK then XDEL."""
        self.client.execute("XACK", self.stream, group, message_id)
        self.client.execute("XDEL", self.stream, message_id)

    def acknowledge_only(self, group: str, message_id: str) -> None:
        self.client.execute("XACK", self.stream, group, message_id)

    def retry_task(self, task: Task) -> str:
        """Republish with retry+1."""
        t = dataclasses.replace(task, retry=task.retry + 1)
        return self.publish(t)

    # -- introspection ----------------------------------------------------
    def get_queue_info(self) -> QueueInfo:
        """XLEN + XINFO GROUPS, summing pending."""
        info = QueueInfo()
        try:
            info.length = int(self.client.execute("XLEN", self.stream))
        except RedisError:
            return info
        try:
            groups = self.client.execute("XINFO", "GROUPS", self.stream)
        except RedisError:
            return info
        info.groups = len(groups or [])
        for g in groups or []:
            d = pairs_to_dict(g)
            info.pending += int(d.get("pending", 0))
        return info

    def get_pending_tasks(self, group: str, count: int = 100) -> list[dict]:
        """XPENDING extended form."""
        try:
            rows = self.client.execute(
                "XPENDING", self.stream, group, "-", "+", str(count))
        except RedisError:
            return []
        out = []
        for row in rows or []:
            out.append({
                "message_id": decode(row[0]),
                "consumer": decode(row[1]),
                "idle_ms": int(row[2]),
                "delivery_count": int(row[3]),
            })
        return out

    def get_stream_info(self) -> dict:
        try:
            return {k: decode(v) for k, v in pairs_to_dict(
                self.client.execute("XINFO", "STREAM", self.stream)).items()}
        except RedisError:
            return {}

    def get_consumer_groups(self) -> list[dict]:
        try:
            groups = self.client.execute("XINFO", "GROUPS", self.stream)
        except RedisError:
            return []
        return [{k: decode(v) for k, v in pairs_to_dict(g).items()}
                for g in groups or []]

    def get_consumers(self, group: str) -> list[dict]:
        try:
            consumers = self.client.execute(
                "XINFO", "CONSUMERS", self.stream, group)
        except RedisError:
            return []
        return [{k: decode(v) for k, v in pairs_to_dict(c).items()}
                for c in consumers or []]

    # -- cleanup ----------------------------------------------------------
    def trim_stream(self, maxlen: int) -> int:
        """XTRIM MAXLEN."""
        return int(self.client.execute("XTRIM", self.stream, "MAXLEN",
                                       str(maxlen)))

    def delete_stream(self) -> None:
        self.client.execute("DEL", self.stream)

    def delete_history(self) -> int:
        """DEL index + SCAN-delete vcp:history:*."""
        self.client.execute("DEL", "vcp:history_index")
        deleted = 0
        cursor = "0"
        while True:
            reply = self.client.execute("SCAN", cursor, "MATCH",
                                        "vcp:history:*", "COUNT", "100")
            cursor = decode(reply[0])
            keys = reply[1] or []
            if keys:
                deleted += int(self.client.execute("DEL", *keys))
            if cursor == "0":
                break
        return deleted

    def clean_pending_tasks(self, group: str) -> int:
        """XPENDING(-,+,10000) then ack+delete each."""
        rows = self.get_pending_tasks(group, count=10000)
        for row in rows:
            self.acknowledge(group, row["message_id"])
        return len(rows)
