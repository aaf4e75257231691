from .stream import Stream, Task, QueueInfo, DEFAULT_STREAM, DEFAULT_GROUP
from .history import HistoryManager, HistoryRecord

__all__ = [
    "Stream", "Task", "QueueInfo", "DEFAULT_STREAM", "DEFAULT_GROUP",
    "HistoryManager", "HistoryRecord",
]
