"""``stats``: queue and history introspection.

Copy of ``vcp_tpu/pipeline/stats.py``, printing the same text. Default
view: the queue's status (XLEN + XINFO GROUPS + the pending sum), the
history's aggregates over ``--days`` and a table of up to 10 recent
tasks; ``--pending``, ``--consumer`` and ``--task <id>`` select the
other views.
"""

from __future__ import annotations

import time

from ..config import Config
from ..queue.history import HistoryManager
from ..queue.stream import DEFAULT_GROUP, Stream


def _trunc(s: str, n: int) -> str:
    return s if len(s) <= n else s[: n - 3] + "..."


def run_stats(cfg: Config, days: int = 7, pending: bool = False,
              consumer: bool = False, task: str = "", out=print) -> int:
    stream = Stream(cfg.redis.address, cfg.redis.password, cfg.redis.db)
    if not stream.ping():
        out("error: redis unreachable")
        return 1
    history = HistoryManager(stream.client)

    if pending:
        return _show_pending(stream, out)
    if consumer:
        return _show_consumers(stream, out)
    if task:
        return _show_task(history, task, out)

    info = stream.get_queue_info()
    out("=== Queue Status ===")
    out(f"stream length : {info.length}")
    out(f"pending tasks : {info.pending}")
    out(f"consumer groups: {info.groups}")
    out("")

    stats = history.get_stats(days)
    out(f"=== History (last {days}d) ===")
    out(f"total     : {stats['total']}")
    out(f"completed : {stats['completed']}")
    out(f"failed    : {stats['failed']}")
    out(f"processing: {stats['processing']}")
    out(f"avg encode: {stats['avg_duration_sec']:.1f}s")
    out(f"p50 dispatch: {stats.get('p50_dispatch_sec', 0.0) * 1000:.0f}ms")
    out("")

    records = sorted(stats["records"], key=lambda r: r.start_time,
                     reverse=True)[:10]
    if records:
        out("=== Recent Tasks (10) ===")
        out(f"{'TASK':<24} {'STATUS':<10} {'CONSUMER':<22} "
            f"{'DURATION':<9} NAME")
        for r in records:
            out(f"{_trunc(r.task_id, 24):<24} {r.status:<10} "
                f"{_trunc(r.consumer, 22):<22} "
                f"{r.duration_sec:>7.1f}s  {_trunc(r.original_name, 28)}")
    return 0


def _show_pending(stream: Stream, out) -> int:
    rows = stream.get_pending_tasks(DEFAULT_GROUP, count=50)
    out(f"=== Pending Tasks ({len(rows)}) ===")
    if not rows:
        out("(none)")
        return 0
    out(f"{'MESSAGE':<18} {'CONSUMER':<26} {'IDLE':<10} DELIVERIES")
    for r in rows:
        out(f"{r['message_id']:<18} {_trunc(r['consumer'], 26):<26} "
            f"{r['idle_ms'] / 1000:>7.1f}s  {r['delivery_count']}")
    return 0


def _show_consumers(stream: Stream, out) -> int:
    groups = stream.get_consumer_groups()
    out(f"=== Consumer Groups ({len(groups)}) ===")
    for g in groups:
        out(f"group={g.get('name')} consumers={g.get('consumers')} "
            f"pending={g.get('pending')} "
            f"last_delivered={g.get('last-delivered-id')}")
        for c in stream.get_consumers(str(g.get("name"))):
            idle = int(c.get("idle", 0)) / 1000
            out(f"  consumer={c.get('name')} pending={c.get('pending')} "
                f"idle={idle:.1f}s")
    return 0


def _show_task(history: HistoryManager, task_id: str, out) -> int:
    rec = history.get_task_history(task_id)
    if rec is None:
        out(f"task {task_id}: no history record")
        return 1
    out(f"=== Task {task_id} ===")
    out(f"status     : {rec.status}")
    out(f"original   : {rec.original_name}")
    out(f"input      : {rec.input_path}")
    out(f"output     : {rec.output_path}")
    out(f"consumer   : {rec.consumer}")
    out(f"source ip  : {rec.source_ip}")
    if rec.start_time:
        out(f"started    : {time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(rec.start_time))}")
    out(f"duration   : {rec.duration_sec:.1f}s")
    out(f"output size: {rec.output_size}")
    if rec.error:
        out(f"error      : {rec.error}")
    return 0
