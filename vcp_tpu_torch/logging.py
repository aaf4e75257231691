"""Leveled key=value logger.

Copy of ``vcp_tpu/logging.py``: a process-global level (default INFO,
overridable by the ``LOG_LEVEL`` environment variable at import time),
per-component loggers that write ``key=value`` lines with a date and
time prefix through one sink, task-lifecycle helpers and adaptive
duration formatting.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, TextIO

DEBUG, INFO, WARN, ERROR = 0, 1, 2, 3

_LEVEL_NAMES = {DEBUG: "DEBUG", INFO: "INFO", WARN: "WARN", ERROR: "ERROR"}
_NAME_LEVELS = {v: k for k, v in _LEVEL_NAMES.items()}

_lock = threading.Lock()
_global_level = INFO
_sink: TextIO = sys.stderr


def set_log_level(level: int | str) -> None:
    """Set the process-global log level ("debug"/"info"/"warn"/"error")."""
    global _global_level
    if isinstance(level, str):
        level = _NAME_LEVELS.get(level.strip().upper(), INFO)
    _global_level = int(level)


def get_log_level() -> int:
    return _global_level


def set_sink(stream: TextIO) -> None:
    """Redirect log output (tests, log files)."""
    global _sink
    _sink = stream


def format_duration(seconds: float) -> str:
    """Adaptive duration formatting: ms / s / m / h."""
    if seconds < 1.0:
        return f"{seconds * 1000:.0f}ms"
    if seconds < 60.0:
        return f"{seconds:.2f}s"
    if seconds < 3600.0:
        m, s = divmod(seconds, 60.0)
        return f"{int(m)}m{s:.0f}s"
    h, rem = divmod(seconds, 3600.0)
    m = rem / 60.0
    return f"{int(h)}h{int(m)}m"


def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return f"{v:.4g}"
    s = str(v)
    if " " in s or "=" in s or '"' in s:
        return '"' + s.replace('"', '\\"') + '"'
    return s


class Logger:
    """Per-component logger emitting ``key=value`` lines."""

    def __init__(self, component: str):
        self.component = component

    def _log(self, level: int, msg: str, /, **fields: Any) -> None:
        if level < _global_level:
            return
        ts = time.strftime("%Y/%m/%d %H:%M:%S")
        kv = " ".join(f"{k}={_fmt_value(v)}" for k, v in fields.items())
        line = f"{ts} [{_LEVEL_NAMES[level]}] [{self.component}] {msg}"
        if kv:
            line += " " + kv
        with _lock:
            print(line, file=_sink, flush=True)

    def debug(self, msg: str, **fields: Any) -> None:
        self._log(DEBUG, msg, **fields)

    def info(self, msg: str, **fields: Any) -> None:
        self._log(INFO, msg, **fields)

    def warn(self, msg: str, **fields: Any) -> None:
        self._log(WARN, msg, **fields)

    def error(self, msg: str, **fields: Any) -> None:
        self._log(ERROR, msg, **fields)

    # Task-lifecycle helpers.
    def task_start(self, task_id: str, /, **fields: Any) -> None:
        self.info("task start", task=task_id, **fields)

    def task_success(self, task_id: str, duration: float, /,
                     **fields: Any) -> None:
        self.info("task success", task=task_id,
                  duration=format_duration(duration), **fields)

    def task_failed(self, task_id: str, reason: str, /,
                    **fields: Any) -> None:
        self.error("task failed", task=task_id, reason=reason, **fields)


def new_logger(component: str) -> Logger:
    return Logger(component)


# LOG_LEVEL env override at import time.
_env = os.environ.get("LOG_LEVEL", "").strip().upper()
if _env in _NAME_LEVELS:
    _global_level = _NAME_LEVELS[_env]
