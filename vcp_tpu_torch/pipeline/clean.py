"""``clean``: queue cleanup.

Copy of ``vcp_tpu/pipeline/clean.py``, printing the same text. Shows a
box-drawn queue status, asks for an interactive "yes" unless
``--force``, then:

* ``--all``      -> DEL stream + history index + SCAN-delete history keys
* ``--consumed`` -> XTRIM MAXLEN 100
* ``--pending``  -> XPENDING scan -> XACK+XDEL each
"""

from __future__ import annotations

from ..config import Config
from ..queue.stream import DEFAULT_GROUP, Stream

TRIM_KEEP = 100


def run_clean(cfg: Config, clean_all: bool = False, pending: bool = False,
              consumed: bool = False, force: bool = False,
              out=print, confirm_input=input) -> int:
    if not (clean_all or pending or consumed):
        out("nothing to do: pass --all, --pending, or --consumed")
        return 1
    stream = Stream(cfg.redis.address, cfg.redis.password, cfg.redis.db)
    if not stream.ping():
        out("error: redis unreachable")
        return 1

    info = stream.get_queue_info()
    out("┌─────────────────────────────┐")
    out("│        Queue Status         │")
    out("├─────────────────────────────┤")
    out(f"│ stream length : {info.length:<11} │")
    out(f"│ pending tasks : {info.pending:<11} │")
    out(f"│ groups        : {info.groups:<11} │")
    out("└─────────────────────────────┘")

    if not force:
        try:
            answer = confirm_input("type 'yes' to proceed: ")
        except EOFError:
            answer = ""
        if answer.strip().lower() != "yes":
            out("aborted")
            return 1

    if clean_all:
        stream.delete_stream()
        deleted = stream.delete_history()
        out(f"deleted stream and {deleted} history records")
    if consumed:
        trimmed = stream.trim_stream(TRIM_KEEP)
        out(f"trimmed {trimmed} consumed messages (kept last {TRIM_KEEP})")
    if pending:
        cleaned = stream.clean_pending_tasks(DEFAULT_GROUP)
        out(f"cleaned {cleaned} pending tasks")
    return 0
