"""Filesystem helpers shared by producer and consumer.

Copy of ``vcp_tpu/utils/fs.py``:

* ``wait_file_stable``     -- 3 consecutive unchanged-size polls at 500 ms
* ``wait_for_file``        -- bounded shared-storage visibility wait with
                              stability and an open probe
* ``move_or_copy``         -- rename, falling back to copy+fsync+unlink
                              across filesystems
* ``copy_file``            -- 4 MiB buffered copy with fsync
* ``is_video_file``        -- extension filter
* ``generate_output_name`` -- always ``.mp4``
* ``format_file_size``     -- human-readable sizes
* ``get_local_ip``         -- best-effort non-loopback IP
"""

from __future__ import annotations

import os
import socket
import time

# Containers the producer publishes, plus .y4m: raw video is a first-class
# input of the encoder (codec.ingest).
VIDEO_EXTENSIONS = (".mp4", ".mkv", ".avi", ".mov", ".webm", ".y4m")

COPY_BUFFER = 4 * 1024 * 1024  # 4 MiB


def is_video_file(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in VIDEO_EXTENSIONS


def generate_output_name(original_name: str, prefix: str = "") -> str:
    """Output is always ``<prefix><stem>.mp4``."""
    stem = os.path.splitext(os.path.basename(original_name))[0]
    return f"{prefix}{stem}.mp4"


def wait_file_stable(
    path: str,
    checks: int = 3,
    interval: float = 0.5,
    timeout: float = 60.0,
    sleep=time.sleep,
) -> bool:
    """Wait until the file size is unchanged for ``checks`` consecutive polls.

    Returns False if the file disappears or the timeout elapses first.
    """
    deadline = time.monotonic() + timeout
    last_size = -1
    stable = 0
    while time.monotonic() < deadline:
        try:
            size = os.path.getsize(path)
        except OSError:
            return False
        if size == last_size and size > 0:
            stable += 1
            if stable >= checks - 1:
                return True
        else:
            stable = 0
            last_size = size
        sleep(interval)
    return False


def wait_for_file(
    path: str,
    timeout: float = 30.0,
    interval: float = 0.5,
    stable_checks: int = 3,
    cancelled=lambda: False,
) -> bool:
    """Bounded wait for a file to appear (NFS visibility), become
    size-stable, and be openable."""
    deadline = time.monotonic() + timeout
    last_size = -1
    stable = 0
    while time.monotonic() < deadline and not cancelled():
        try:
            size = os.path.getsize(path)
        except OSError:
            time.sleep(interval)
            continue
        if size > 0 and size == last_size:
            stable += 1
            if stable >= stable_checks - 1:
                try:
                    with open(path, "rb"):
                        return True
                except OSError:
                    stable = 0
        else:
            stable = 0
        last_size = size
        time.sleep(interval)
    return False


def copy_file(src: str, dst: str) -> None:
    """Buffered copy with fsync on the destination."""
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        while True:
            chunk = fin.read(COPY_BUFFER)
            if not chunk:
                break
            fout.write(chunk)
        fout.flush()
        os.fsync(fout.fileno())


def move_or_copy(src: str, dst: str) -> None:
    """Rename, falling back to copy+unlink across devices."""
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    try:
        os.rename(src, dst)
        return
    except OSError:
        pass
    copy_file(src, dst)
    os.unlink(src)


def format_file_size(num_bytes: int) -> str:
    """Human-readable file size."""
    size = float(num_bytes)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if size < 1024.0 or unit == "TB":
            if unit == "B":
                return f"{int(size)}{unit}"
            return f"{size:.2f}{unit}"
        size /= 1024.0
    return f"{size:.2f}TB"


def get_local_ip() -> str:
    """Best-effort non-loopback local IP."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"
