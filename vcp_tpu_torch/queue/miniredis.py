"""Embedded Redis-subset server (RESP2, threads, pure stdlib).

Copy of ``vcp_tpu/queue/miniredis.py``, with the same commands, replies
and error strings, for hosts without a Redis binary:

* Streams: XADD (MAXLEN), XLEN, XRANGE, XREADGROUP (COUNT/BLOCK, ">" and
  PEL re-read), XACK, XDEL, XTRIM, XPENDING (summary + extended),
  XGROUP CREATE (MKSTREAM), XINFO STREAM/GROUPS/CONSUMERS
* Strings: GET, SET (EX), SETEX, DEL, EXISTS, EXPIRE, TTL, SCAN, KEYS
* Sorted sets: ZADD, ZRANGEBYSCORE (LIMIT), ZREM, ZREMRANGEBYSCORE, ZCARD
* Admin: PING, AUTH, SELECT, FLUSHDB, FLUSHALL, DBSIZE, QUIT

Start in-process with ``MiniRedisServer(port=0).start()`` (returns the bound
port) or from the CLI with ``python -m vcp_tpu_torch.cli redis-serve``.
Semantics follow Redis 7 closely enough for the control plane; it is NOT a
general Redis.
"""

from __future__ import annotations

import socket
import socketserver
import threading
import time


def _now_ms() -> int:
    return int(time.time() * 1000)


class _StreamGroup:
    def __init__(self, last_delivered: tuple[int, int]):
        self.last_delivered = last_delivered
        # pel: id -> [consumer_name, delivery_time_ms, delivery_count]
        self.pel: dict[tuple[int, int], list] = {}
        self.consumers: dict[str, dict] = {}  # name -> {"seen_ms": int}

    def ensure_consumer(self, name: str) -> None:
        self.consumers.setdefault(name, {"seen_ms": _now_ms()})
        self.consumers[name]["seen_ms"] = _now_ms()


class _Stream:
    def __init__(self):
        self.entries: list[tuple[tuple[int, int], dict[bytes, bytes]]] = []
        self.last_id: tuple[int, int] = (0, 0)
        self.max_deleted_id: tuple[int, int] = (0, 0)
        self.groups: dict[str, _StreamGroup] = {}

    def next_id(self) -> tuple[int, int]:
        ms = _now_ms()
        if ms <= self.last_id[0]:
            return (self.last_id[0], self.last_id[1] + 1)
        return (ms, 0)


def _parse_stream_id(s: bytes | str, default_seq: int = 0) -> tuple[int, int]:
    if isinstance(s, bytes):
        s = s.decode()
    if s == "-":
        return (0, 0)
    if s == "+":
        return (2**63 - 1, 2**63 - 1)
    if "-" in s:
        ms, seq = s.split("-", 1)
        return (int(ms), int(seq))
    return (int(s), default_seq)


def _fmt_id(sid: tuple[int, int]) -> bytes:
    return b"%d-%d" % sid


class _Db:
    def __init__(self):
        self.strings: dict[bytes, bytes] = {}
        self.expiry: dict[bytes, float] = {}  # key -> unix deadline
        self.zsets: dict[bytes, dict[bytes, float]] = {}
        self.streams: dict[bytes, _Stream] = {}

    def purge_expired(self, key: bytes) -> None:
        dl = self.expiry.get(key)
        if dl is not None and time.time() >= dl:
            self.strings.pop(key, None)
            self.zsets.pop(key, None)
            self.expiry.pop(key, None)

    def all_keys(self) -> list[bytes]:
        for k in list(self.expiry):
            self.purge_expired(k)
        keys = set(self.strings) | set(self.zsets) | set(self.streams)
        return sorted(keys)


class RespWriter:
    """Builds RESP2 reply bytes."""

    @staticmethod
    def simple(s: str) -> bytes:
        return b"+" + s.encode() + b"\r\n"

    @staticmethod
    def error(s: str) -> bytes:
        return b"-" + s.encode() + b"\r\n"

    @staticmethod
    def integer(n: int) -> bytes:
        return b":%d\r\n" % n

    @staticmethod
    def bulk(v: bytes | str | None) -> bytes:
        if v is None:
            return b"$-1\r\n"
        if isinstance(v, str):
            v = v.encode()
        return b"$%d\r\n%s\r\n" % (len(v), v)

    @staticmethod
    def array(items: list | None) -> bytes:
        if items is None:
            return b"*-1\r\n"
        out = [b"*%d\r\n" % len(items)]
        for it in items:
            if isinstance(it, bytes) or isinstance(it, str) or it is None:
                out.append(RespWriter.bulk(it))
            elif isinstance(it, int):
                out.append(RespWriter.integer(it))
            elif isinstance(it, list):
                out.append(RespWriter.array(it))
            else:
                out.append(RespWriter.bulk(str(it)))
        return b"".join(out)


class MiniRedis:
    """The command engine, shared by all client connections."""

    def __init__(self):
        self.dbs: dict[int, _Db] = {}
        self.lock = threading.RLock()
        self.cond = threading.Condition(self.lock)  # signaled on XADD

    def db(self, idx: int) -> _Db:
        return self.dbs.setdefault(idx, _Db())

    # ------------------------------------------------------------------
    def dispatch(self, dbidx: int, args: list[bytes]) -> bytes:
        cmd = args[0].decode().upper()
        handler = getattr(self, "cmd_" + cmd, None)
        if handler is None:
            return RespWriter.error(f"ERR unknown command '{cmd}'")
        try:
            with self.lock:
                return handler(self.db(dbidx), args[1:])
        except (ValueError, IndexError) as e:
            return RespWriter.error(f"ERR {e}")

    # -- admin ----------------------------------------------------------
    def cmd_PING(self, db, a):
        return RespWriter.simple("PONG") if not a else RespWriter.bulk(a[0])

    def cmd_SELECT(self, db, a):
        return RespWriter.simple("OK")  # connection handler tracks db index

    def cmd_FLUSHDB(self, db, a):
        db.strings.clear(); db.zsets.clear(); db.streams.clear(); db.expiry.clear()
        return RespWriter.simple("OK")

    def cmd_FLUSHALL(self, db, a):
        self.dbs.clear()
        return RespWriter.simple("OK")

    def cmd_DBSIZE(self, db, a):
        return RespWriter.integer(len(db.all_keys()))

    # -- strings / keys ---------------------------------------------------
    def cmd_GET(self, db, a):
        key = a[0]
        db.purge_expired(key)
        return RespWriter.bulk(db.strings.get(key))

    def cmd_SET(self, db, a):
        key, val = a[0], a[1]
        db.strings[key] = val
        db.expiry.pop(key, None)
        i = 2
        while i < len(a):
            opt = a[i].decode().upper()
            if opt == "EX":
                db.expiry[key] = time.time() + int(a[i + 1]); i += 2
            elif opt == "PX":
                db.expiry[key] = time.time() + int(a[i + 1]) / 1000.0; i += 2
            else:
                i += 1
        return RespWriter.simple("OK")

    def cmd_SETEX(self, db, a):
        key, secs, val = a[0], int(a[1]), a[2]
        db.strings[key] = val
        db.expiry[key] = time.time() + secs
        return RespWriter.simple("OK")

    def cmd_DEL(self, db, a):
        n = 0
        for key in a:
            db.purge_expired(key)
            hit = key in db.strings or key in db.zsets or key in db.streams
            db.strings.pop(key, None)
            db.zsets.pop(key, None)
            db.streams.pop(key, None)
            db.expiry.pop(key, None)
            n += 1 if hit else 0
        return RespWriter.integer(n)

    def cmd_EXISTS(self, db, a):
        n = 0
        for key in a:
            db.purge_expired(key)
            if key in db.strings or key in db.zsets or key in db.streams:
                n += 1
        return RespWriter.integer(n)

    def cmd_EXPIRE(self, db, a):
        key, secs = a[0], int(a[1])
        db.purge_expired(key)
        if key in db.strings or key in db.zsets or key in db.streams:
            db.expiry[key] = time.time() + secs
            return RespWriter.integer(1)
        return RespWriter.integer(0)

    def cmd_TTL(self, db, a):
        key = a[0]
        db.purge_expired(key)
        if key not in db.strings and key not in db.zsets and key not in db.streams:
            return RespWriter.integer(-2)
        dl = db.expiry.get(key)
        if dl is None:
            return RespWriter.integer(-1)
        return RespWriter.integer(max(0, int(round(dl - time.time()))))

    @staticmethod
    def _glob_match(pattern: bytes, s: bytes) -> bool:
        import fnmatch
        return fnmatch.fnmatchcase(s.decode("utf-8", "replace"),
                                   pattern.decode("utf-8", "replace"))

    def cmd_KEYS(self, db, a):
        pat = a[0] if a else b"*"
        return RespWriter.array([k for k in db.all_keys() if self._glob_match(pat, k)])

    def cmd_SCAN(self, db, a):
        cursor = int(a[0])
        pat, count = b"*", 10
        i = 1
        while i < len(a):
            opt = a[i].decode().upper()
            if opt == "MATCH":
                pat = a[i + 1]; i += 2
            elif opt == "COUNT":
                count = int(a[i + 1]); i += 2
            elif opt == "TYPE":
                i += 2
            else:
                i += 1
        keys = db.all_keys()
        batch = keys[cursor:cursor + count]
        nxt = cursor + count
        if nxt >= len(keys):
            nxt = 0
        matched = [k for k in batch if self._glob_match(pat, k)]
        return RespWriter.array([str(nxt).encode(), matched])

    # -- sorted sets -------------------------------------------------------
    def cmd_ZADD(self, db, a):
        key = a[0]
        z = db.zsets.setdefault(key, {})
        added = 0
        for i in range(1, len(a), 2):
            score, member = float(a[i]), a[i + 1]
            if member not in z:
                added += 1
            z[member] = score
        return RespWriter.integer(added)

    @staticmethod
    def _parse_score(s: bytes, lo: bool) -> tuple[float, bool]:
        """Returns (value, exclusive)."""
        t = s.decode()
        excl = t.startswith("(")
        if excl:
            t = t[1:]
        if t in ("-inf", "+inf", "inf"):
            v = float("-inf") if t == "-inf" else float("inf")
        else:
            v = float(t)
        return v, excl

    def cmd_ZRANGEBYSCORE(self, db, a):
        key = a[0]
        db.purge_expired(key)
        z = db.zsets.get(key, {})
        lo, lo_x = self._parse_score(a[1], True)
        hi, hi_x = self._parse_score(a[2], False)
        offset, count = 0, None
        withscores = False
        i = 3
        while i < len(a):
            opt = a[i].decode().upper()
            if opt == "LIMIT":
                offset, count = int(a[i + 1]), int(a[i + 2]); i += 3
            elif opt == "WITHSCORES":
                withscores = True; i += 1
            else:
                i += 1
        items = sorted(z.items(), key=lambda kv: (kv[1], kv[0]))
        sel = [m for m, s in items
               if (s > lo if lo_x else s >= lo) and (s < hi if hi_x else s <= hi)]
        if count is not None:
            sel = sel[offset:offset + count]
        if withscores:
            out = []
            for m in sel:
                out += [m, repr(z[m]).encode()]
            return RespWriter.array(out)
        return RespWriter.array(sel)

    def cmd_ZREM(self, db, a):
        z = db.zsets.get(a[0], {})
        n = 0
        for m in a[1:]:
            if z.pop(m, None) is not None:
                n += 1
        return RespWriter.integer(n)

    def cmd_ZREMRANGEBYSCORE(self, db, a):
        z = db.zsets.get(a[0], {})
        lo, lo_x = self._parse_score(a[1], True)
        hi, hi_x = self._parse_score(a[2], False)
        victims = [m for m, s in z.items()
                   if (s > lo if lo_x else s >= lo) and (s < hi if hi_x else s <= hi)]
        for m in victims:
            del z[m]
        return RespWriter.integer(len(victims))

    def cmd_ZCARD(self, db, a):
        return RespWriter.integer(len(db.zsets.get(a[0], {})))

    # -- streams -------------------------------------------------------
    def cmd_XADD(self, db, a):
        key = a[0]
        i = 1
        maxlen = None
        if a[i].decode().upper() == "NOMKSTREAM":
            i += 1
        if i < len(a) and a[i].decode().upper() == "MAXLEN":
            i += 1
            if a[i] in (b"~", b"="):
                i += 1
            maxlen = int(a[i]); i += 1
        idspec = a[i].decode(); i += 1
        st = db.streams.setdefault(key, _Stream())
        if idspec == "*":
            sid = st.next_id()
        else:
            sid = _parse_stream_id(idspec, default_seq=0)
            if sid <= st.last_id:
                return RespWriter.error(
                    "ERR The ID specified in XADD is equal or smaller than "
                    "the target stream top item")
        fields: dict[bytes, bytes] = {}
        for j in range(i, len(a) - 1, 2):
            fields[a[j]] = a[j + 1]
        st.entries.append((sid, fields))
        st.last_id = sid
        if maxlen is not None and len(st.entries) > maxlen:
            drop = len(st.entries) - maxlen
            for eid, _ in st.entries[:drop]:
                st.max_deleted_id = max(st.max_deleted_id, eid)
            del st.entries[:drop]
        self.cond.notify_all()
        return RespWriter.bulk(_fmt_id(sid))

    def cmd_XLEN(self, db, a):
        st = db.streams.get(a[0])
        return RespWriter.integer(len(st.entries) if st else 0)

    @staticmethod
    def _entry_reply(entry) -> list:
        sid, fields = entry
        flat: list = []
        for k, v in fields.items():
            flat += [k, v]
        return [_fmt_id(sid), flat]

    def cmd_XRANGE(self, db, a):
        st = db.streams.get(a[0])
        if st is None:
            return RespWriter.array([])
        lo = _parse_stream_id(a[1], 0)
        hi = _parse_stream_id(a[2], 2**63 - 1)
        count = None
        if len(a) >= 5 and a[3].decode().upper() == "COUNT":
            count = int(a[4])
        out = [self._entry_reply(e) for e in st.entries if lo <= e[0] <= hi]
        if count is not None:
            out = out[:count]
        return RespWriter.array(out)

    def cmd_XDEL(self, db, a):
        st = db.streams.get(a[0])
        if st is None:
            return RespWriter.integer(0)
        ids = {_parse_stream_id(x) for x in a[1:]}
        before = len(st.entries)
        st.entries = [e for e in st.entries if e[0] not in ids]
        return RespWriter.integer(before - len(st.entries))

    def cmd_XTRIM(self, db, a):
        st = db.streams.get(a[0])
        if st is None:
            return RespWriter.integer(0)
        i = 1
        if a[i].decode().upper() != "MAXLEN":
            raise ValueError("only MAXLEN trim supported")
        i += 1
        if a[i] in (b"~", b"="):
            i += 1
        maxlen = int(a[i])
        drop = max(0, len(st.entries) - maxlen)
        del st.entries[:drop]
        return RespWriter.integer(drop)

    def cmd_XGROUP(self, db, a):
        sub = a[0].decode().upper()
        if sub == "CREATE":
            key, group = a[1], a[2]
            start = a[3].decode()
            mkstream = any(x.decode().upper() == "MKSTREAM" for x in a[4:])
            st = db.streams.get(key)
            if st is None:
                if not mkstream:
                    return RespWriter.error(
                        "ERR The XGROUP subcommand requires the key to exist.")
                st = db.streams.setdefault(key, _Stream())
            gname = group.decode()
            if gname in st.groups:
                return RespWriter.error(
                    "BUSYGROUP Consumer Group name already exists")
            last = st.last_id if start == "$" else _parse_stream_id(start)
            st.groups[gname] = _StreamGroup(last)
            return RespWriter.simple("OK")
        if sub == "DESTROY":
            st = db.streams.get(a[1])
            if st and st.groups.pop(a[2].decode(), None) is not None:
                return RespWriter.integer(1)
            return RespWriter.integer(0)
        return RespWriter.error(f"ERR unsupported XGROUP subcommand {sub}")

    def cmd_XREADGROUP(self, db, a):
        # XREADGROUP GROUP g c [COUNT n] [BLOCK ms] [NOACK] STREAMS key id
        i = 0
        group = consumer = None
        count, block_ms, noack = None, None, False
        while i < len(a):
            opt = a[i].decode().upper()
            if opt == "GROUP":
                group, consumer = a[i + 1].decode(), a[i + 2].decode(); i += 3
            elif opt == "COUNT":
                count = int(a[i + 1]); i += 2
            elif opt == "BLOCK":
                block_ms = int(a[i + 1]); i += 2
            elif opt == "NOACK":
                noack = True; i += 1
            elif opt == "STREAMS":
                keys_ids = a[i + 1:]; i = len(a)
            else:
                i += 1
        key, idspec = keys_ids[0], keys_ids[1].decode()
        block_forever = block_ms == 0
        deadline = (None if block_ms is None or block_forever
                    else time.monotonic() + block_ms / 1000.0)

        while True:
            st = db.streams.get(key)
            if st is None or group not in (st.groups if st else {}):
                return RespWriter.error(
                    f"NOGROUP No such key '{key.decode()}' or consumer group "
                    f"'{group}' in XREADGROUP with GROUP option")
            g = st.groups[group]
            g.ensure_consumer(consumer)
            if idspec == ">":
                fresh = [e for e in st.entries if e[0] > g.last_delivered]
                if count is not None:
                    fresh = fresh[:count]
                if fresh:
                    for sid, _ in fresh:
                        g.last_delivered = max(g.last_delivered, sid)
                        if not noack:
                            g.pel[sid] = [consumer, _now_ms(), 1]
                    entries = [self._entry_reply(e) for e in fresh]
                    return RespWriter.array([[key, entries]])
            else:
                # Re-read this consumer's own PEL entries with id > idspec.
                base = _parse_stream_id(idspec)
                byid = {e[0]: e for e in st.entries}
                mine = sorted(sid for sid, (c, _, _) in
                              ((s, v) for s, v in g.pel.items())
                              if c == consumer and sid > base)
                if count is not None:
                    mine = mine[:count]
                entries = []
                for sid in mine:
                    g.pel[sid][2] += 1
                    e = byid.get(sid)
                    entries.append(self._entry_reply(e) if e else [_fmt_id(sid), None])
                return RespWriter.array([[key, entries]])
            # Nothing new: return nil unless blocking was requested.
            if block_ms is None:
                return RespWriter.array(None)
            if block_forever:
                self.cond.wait(timeout=0.25)
                continue
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return RespWriter.array(None)
            self.cond.wait(timeout=min(remaining, 0.25))

    def cmd_XACK(self, db, a):
        st = db.streams.get(a[0])
        if st is None:
            return RespWriter.integer(0)
        g = st.groups.get(a[1].decode())
        if g is None:
            return RespWriter.integer(0)
        n = 0
        for x in a[2:]:
            if g.pel.pop(_parse_stream_id(x), None) is not None:
                n += 1
        return RespWriter.integer(n)

    def cmd_XPENDING(self, db, a):
        st = db.streams.get(a[0])
        g = st.groups.get(a[1].decode()) if st else None
        if g is None:
            if len(a) == 2:
                return RespWriter.array([0, None, None, None])
            return RespWriter.array([])
        if len(a) == 2:  # summary form
            if not g.pel:
                return RespWriter.array([0, None, None, None])
            ids = sorted(g.pel)
            per_consumer: dict[str, int] = {}
            for c, _, _ in g.pel.values():
                per_consumer[c] = per_consumer.get(c, 0) + 1
            return RespWriter.array([
                len(g.pel), _fmt_id(ids[0]), _fmt_id(ids[-1]),
                [[c.encode(), str(n).encode()] for c, n in sorted(per_consumer.items())],
            ])
        # extended: XPENDING key group [IDLE ms] start end count [consumer]
        i = 2
        if a[i].decode().upper() == "IDLE":
            i += 2
        lo = _parse_stream_id(a[i], 0); i += 1
        hi = _parse_stream_id(a[i], 2**63 - 1); i += 1
        count = int(a[i]); i += 1
        consumer = a[i].decode() if i < len(a) else None
        now = _now_ms()
        out = []
        for sid in sorted(g.pel):
            if not (lo <= sid <= hi):
                continue
            c, t, dc = g.pel[sid]
            if consumer is not None and c != consumer:
                continue
            out.append([_fmt_id(sid), c.encode(), now - t, dc])
            if len(out) >= count:
                break
        return RespWriter.array(out)

    def cmd_XINFO(self, db, a):
        sub = a[0].decode().upper()
        st = db.streams.get(a[1])
        if sub == "STREAM":
            if st is None:
                return RespWriter.error("ERR no such key")
            return RespWriter.array([
                b"length", len(st.entries),
                b"last-generated-id", _fmt_id(st.last_id),
                b"max-deleted-entry-id", _fmt_id(st.max_deleted_id),
                b"groups", len(st.groups),
                b"first-entry",
                self._entry_reply(st.entries[0]) if st.entries else None,
                b"last-entry",
                self._entry_reply(st.entries[-1]) if st.entries else None,
            ])
        if sub == "GROUPS":
            if st is None:
                return RespWriter.array([])
            out = []
            for name, g in st.groups.items():
                out.append([
                    b"name", name.encode(),
                    b"consumers", len(g.consumers),
                    b"pending", len(g.pel),
                    b"last-delivered-id", _fmt_id(g.last_delivered),
                ])
            return RespWriter.array(out)
        if sub == "CONSUMERS":
            g = st.groups.get(a[2].decode()) if st else None
            if g is None:
                return RespWriter.array([])
            now = _now_ms()
            out = []
            for name, meta in g.consumers.items():
                pending = sum(1 for c, _, _ in g.pel.values() if c == name)
                out.append([
                    b"name", name.encode(),
                    b"pending", pending,
                    b"idle", now - meta["seen_ms"],
                ])
            return RespWriter.array(out)
        return RespWriter.error(f"ERR unsupported XINFO subcommand {sub}")


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        engine: MiniRedis = self.server.engine  # type: ignore[attr-defined]
        password = getattr(self.server, "password", None)
        authed = not password  # per-connection auth state
        buf = b""
        dbidx = 0
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

        def read_line():
            nonlocal buf
            while b"\r\n" not in buf:
                chunk = sock.recv(65536)
                if not chunk:
                    return None
                buf += chunk
            line, buf = buf.split(b"\r\n", 1)
            return line

        def read_n(n):
            nonlocal buf
            while len(buf) < n:
                chunk = sock.recv(65536)
                if not chunk:
                    return None
                buf += chunk
            data, buf = buf[:n], buf[n:]
            return data

        while True:
            line = read_line()
            if line is None:
                return
            if not line.startswith(b"*"):
                sock.sendall(RespWriter.error("ERR protocol: arrays only"))
                return
            argc = int(line[1:])
            args = []
            ok = True
            for _ in range(argc):
                hdr = read_line()
                if hdr is None or not hdr.startswith(b"$"):
                    ok = False
                    break
                n = int(hdr[1:])
                data = read_n(n)
                if data is None or read_n(2) is None:
                    ok = False
                    break
                args.append(data)
            if not ok or not args:
                return
            cmd = args[0].decode().upper()
            if cmd == "QUIT":
                sock.sendall(RespWriter.simple("OK"))
                return
            if cmd == "AUTH":
                # AUTH <pass> or AUTH <user> <pass> (redis 6 ACL form)
                supplied = args[-1].decode() if len(args) >= 2 else ""
                if not password:
                    sock.sendall(RespWriter.error(
                        "ERR Client sent AUTH, but no password is set"))
                elif supplied == password:
                    authed = True
                    sock.sendall(RespWriter.simple("OK"))
                else:
                    sock.sendall(RespWriter.error(
                        "WRONGPASS invalid username-password pair"))
                continue
            if not authed:
                sock.sendall(RespWriter.error(
                    "NOAUTH Authentication required."))
                continue
            if cmd == "SELECT":
                dbidx = int(args[1])
                sock.sendall(RespWriter.simple("OK"))
                continue
            reply = engine.dispatch(dbidx, args)
            sock.sendall(reply)


class _ThreadingServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class MiniRedisServer:
    """In-process Redis-subset server. ``start()`` returns the bound port."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 password: str = ""):
        self.engine = MiniRedis()
        self._server = _ThreadingServer((host, port), _Handler)
        self._server.engine = self.engine  # type: ignore[attr-defined]
        self._server.password = password  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None
        if not password and host not in ("127.0.0.1", "localhost", "::1"):
            import sys
            print(f"miniredis: WARNING serving on {host} without a "
                  "password — FLUSHALL/DEL are exposed; pass password=",
                  file=sys.stderr)

    @property
    def address(self) -> str:
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="miniredis")
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)


def serve_forever(host: str = "127.0.0.1", port: int = 6379,
                  password: str = "") -> None:
    """Blocking entry point of ``redis-serve``."""
    srv = MiniRedisServer(host, port, password=password)
    srv.start()
    print(f"miniredis listening on {srv.address}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
