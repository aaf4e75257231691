"""Minimal RESP2 Redis client (pure stdlib sockets).

Copy of ``vcp_tpu/queue/resp.py``. It speaks RESP2 to a real Redis
server or to the embedded ``queue.miniredis`` server: ``execute(*args)``
encodes any command as a RESP array of bulk strings and parses any RESP2
reply.
"""

from __future__ import annotations

import socket
import threading
from typing import Any


class RedisError(Exception):
    """Server-side error reply (RESP '-')."""


class ConnectionError_(RedisError):
    pass


def _encode_command(args: tuple) -> bytes:
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, bytes):
            b = a
        elif isinstance(a, bool):
            b = b"1" if a else b"0"
        elif isinstance(a, (int, float)):
            b = repr(a).encode()
        else:
            b = str(a).encode("utf-8")
        out.append(b"$%d\r\n" % len(b))
        out.append(b)
        out.append(b"\r\n")
    return b"".join(out)


class RedisClient:
    """Thread-safe blocking RESP2 client over one TCP connection.

    A single lock serializes request/response pairs; blocking commands
    (XREADGROUP ... BLOCK) temporarily extend the socket timeout.
    """

    def __init__(self, address: str = "localhost:6379", password: str = "",
                 db: int = 0, timeout: float = 10.0):
        host, _, port = address.rpartition(":")
        self.host = host or "localhost"
        self.port = int(port or 6379)
        self.password = password
        self.db = db
        self.timeout = timeout
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._buf = b""

    # -- connection ---------------------------------------------------------
    def connect(self) -> None:
        if self._sock is not None:
            return
        s = socket.create_connection((self.host, self.port), timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self._buf = b""
        if self.password:
            self._execute_locked("AUTH", self.password)
        if self.db:
            self._execute_locked("SELECT", self.db)

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None
                    self._buf = b""

    # -- protocol -----------------------------------------------------------
    def _read_exact_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError_("connection closed by server")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError_("connection closed by server")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n:]
        return data

    def _read_reply(self) -> Any:
        line = self._read_exact_line()
        kind, payload = line[:1], line[1:]
        if kind == b"+":
            return payload.decode("utf-8")
        if kind == b"-":
            raise RedisError(payload.decode("utf-8"))
        if kind == b":":
            return int(payload)
        if kind == b"$":
            n = int(payload)
            if n == -1:
                return None
            data = self._read_exact(n)
            self._read_exact(2)  # trailing CRLF
            return data
        if kind == b"*":
            n = int(payload)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RedisError(f"unknown RESP type byte: {line!r}")

    def _execute_locked(self, *args, block_timeout: float | None = None) -> Any:
        self._sock.sendall(_encode_command(args))
        if block_timeout is not None:
            self._sock.settimeout(block_timeout + self.timeout)
        try:
            return self._read_reply()
        finally:
            if block_timeout is not None:
                self._sock.settimeout(self.timeout)

    def execute(self, *args, block_timeout: float | None = None) -> Any:
        with self._lock:
            if self._sock is None:
                self.connect()
            try:
                return self._execute_locked(*args, block_timeout=block_timeout)
            except (OSError, ConnectionError_):
                # One reconnect attempt for transient drops.
                try:
                    self._sock.close()
                except Exception:
                    pass
                self._sock = None
                self.connect()
                return self._execute_locked(*args, block_timeout=block_timeout)

    # -- conveniences -------------------------------------------------------
    def ping(self) -> bool:
        try:
            return self.execute("PING") == "PONG"
        except (OSError, RedisError):
            return False


def decode(v: Any) -> Any:
    """Recursively decode bytes → str for human-facing values."""
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, list):
        return [decode(x) for x in v]
    return v


def pairs_to_dict(flat: list) -> dict[str, Any]:
    """RESP flat [k1, v1, k2, v2, ...] → {k1: v1, ...} with str keys."""
    it = iter(flat)
    out = {}
    for k in it:
        v = next(it)
        key = k.decode("utf-8") if isinstance(k, bytes) else str(k)
        out[key] = v
    return out
