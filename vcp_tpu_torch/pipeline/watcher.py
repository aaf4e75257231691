"""Directory watcher.

Copy of ``vcp_tpu/pipeline/watcher.py``: a polling scanner (shared and
NFS mounts are where inotify is unreliable, and the standard library has
no binding for it) that reports new files by the set difference between
scans. Create events only.
"""

from __future__ import annotations

import os
import threading
from typing import Callable


class PollingWatcher:
    """Polls a directory and invokes ``on_create(path)`` for new files.

    Files present at start are NOT reported (that is ``--mode all``'s
    job); only files appearing after ``start()``.
    """

    def __init__(self, directory: str, on_create: Callable[[str], None],
                 interval: float = 0.5,
                 file_filter: Callable[[str], bool] = lambda p: True):
        self.directory = directory
        self.on_create = on_create
        self.interval = interval
        self.file_filter = file_filter
        self._known: set[str] = set()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _scan(self) -> set[str]:
        try:
            with os.scandir(self.directory) as it:
                return {e.path for e in it if e.is_file()}
        except OSError:
            return set()

    def start(self) -> None:
        self._known = self._scan()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="vcp-watcher")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            current = self._scan()
            fresh = current - self._known
            self._known = current
            for path in sorted(fresh):
                if self.file_filter(path):
                    self.on_create(path)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
