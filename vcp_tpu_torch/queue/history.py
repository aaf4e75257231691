"""Task history persistence.

Copy of ``vcp_tpu/queue/history.py``: per-task JSON at
``vcp:history:<taskID>`` with a TTL of retention-days, indexed by the
ZSET ``vcp:history_index`` scored by start time in unix seconds, with
the statuses pending / processing / completed / failed. The consumer
records start and completion or failure; ``record_task_complete`` and
``record_task_failed`` create the record if it is missing.
"""

from __future__ import annotations

import dataclasses
import json
import time

from .resp import RedisClient, decode

HISTORY_KEY_PREFIX = "vcp:history:"
HISTORY_INDEX_KEY = "vcp:history_index"
DEFAULT_RETENTION_DAYS = 7

STATUS_PENDING = "pending"
STATUS_PROCESSING = "processing"
STATUS_COMPLETED = "completed"
STATUS_FAILED = "failed"


@dataclasses.dataclass
class HistoryRecord:
    task_id: str = ""
    original_name: str = ""
    input_path: str = ""
    output_path: str = ""
    consumer: str = ""
    source_ip: str = ""
    status: str = STATUS_PENDING
    error: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    duration_sec: float = 0.0
    output_size: int = 0
    dispatch_sec: float = 0.0   # publish -> consumer pickup latency

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), separators=(",", ":"))

    @classmethod
    def from_json(cls, data: str) -> "HistoryRecord":
        d = json.loads(data)
        rec = cls()
        for f in dataclasses.fields(cls):
            if f.name in d:
                setattr(rec, f.name, d[f.name])
        return rec


class HistoryManager:
    def __init__(self, client: RedisClient,
                 retention_days: int = DEFAULT_RETENTION_DAYS):
        self.client = client
        self.retention_days = retention_days

    def _key(self, task_id: str) -> str:
        return HISTORY_KEY_PREFIX + task_id

    def _save(self, rec: HistoryRecord) -> None:
        ttl = self.retention_days * 24 * 3600
        self.client.execute("SET", self._key(rec.task_id), rec.to_json(),
                            "EX", str(ttl))
        self.client.execute("ZADD", HISTORY_INDEX_KEY,
                            repr(rec.start_time), rec.task_id)

    # -- lifecycle -------------------------------------------------------
    def record_task_start(self, task_id: str, original_name: str,
                          input_path: str, consumer: str,
                          source_ip: str = "",
                          dispatch_sec: float = 0.0) -> None:
        rec = HistoryRecord(
            task_id=task_id, original_name=original_name,
            input_path=input_path, consumer=consumer, source_ip=source_ip,
            status=STATUS_PROCESSING, start_time=time.time(),
            dispatch_sec=dispatch_sec)
        self._save(rec)

    def record_task_complete(self, task_id: str, output_path: str = "",
                             output_size: int = 0) -> None:
        rec = self.get_task_history(task_id)
        if rec is None:
            # Create the record rather than silently dropping history.
            rec = HistoryRecord(task_id=task_id, start_time=time.time())
        rec.status = STATUS_COMPLETED
        rec.end_time = time.time()
        rec.duration_sec = max(0.0, rec.end_time - rec.start_time)
        rec.output_path = output_path
        rec.output_size = output_size
        self._save(rec)

    def record_task_failed(self, task_id: str, error: str) -> None:
        rec = self.get_task_history(task_id)
        if rec is None:
            rec = HistoryRecord(task_id=task_id, start_time=time.time())
        rec.status = STATUS_FAILED
        rec.error = error
        rec.end_time = time.time()
        rec.duration_sec = max(0.0, rec.end_time - rec.start_time)
        self._save(rec)

    # -- queries ---------------------------------------------------------
    def get_task_history(self, task_id: str) -> HistoryRecord | None:
        raw = self.client.execute("GET", self._key(task_id))
        if raw is None:
            return None
        try:
            return HistoryRecord.from_json(decode(raw))
        except (ValueError, KeyError):
            return None

    def get_all_history(self, days: int = 7) -> list[HistoryRecord]:
        """ZRANGEBYSCORE window then per-ID GET."""
        cutoff = time.time() - days * 24 * 3600
        ids = self.client.execute(
            "ZRANGEBYSCORE", HISTORY_INDEX_KEY, repr(cutoff), "+inf")
        out = []
        for tid in ids or []:
            rec = self.get_task_history(decode(tid))
            if rec is not None:
                out.append(rec)
        return out

    def get_stats(self, days: int = 7) -> dict:
        """Aggregate total/completed/failed/avg-duration."""
        records = self.get_all_history(days)
        completed = [r for r in records if r.status == STATUS_COMPLETED]
        failed = [r for r in records if r.status == STATUS_FAILED]
        durations = [r.duration_sec for r in completed if r.duration_sec > 0]
        dispatches = sorted(r.dispatch_sec for r in records
                            if r.dispatch_sec > 0)
        p50 = dispatches[len(dispatches) // 2] if dispatches else 0.0
        return {
            "total": len(records),
            "completed": len(completed),
            "failed": len(failed),
            "processing": sum(1 for r in records
                              if r.status == STATUS_PROCESSING),
            "avg_duration_sec": (sum(durations) / len(durations)
                                 if durations else 0.0),
            "p50_dispatch_sec": p50,
            "records": records,
        }
