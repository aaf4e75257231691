"""The port's control-plane queue against vcp_tpu's: the embedded
server's raw RESP replies, the task's wire fields, the publish rate
limiter, the history lifecycle and the trim / clean APIs. Tolerance 0 on
every byte and reply."""

import dataclasses
import socket
import threading

import pytest

from vcp_tpu.queue import history as j_history
from vcp_tpu.queue import miniredis as j_miniredis
from vcp_tpu.queue import stream as j_stream
from vcp_tpu_torch.queue import history as t_history
from vcp_tpu_torch.queue import miniredis as t_miniredis
from vcp_tpu_torch.queue import stream as t_stream

NOW_MS = 1_700_000_000_000


@pytest.fixture(scope="module")
def t_server():
    """The port's server (conftest's ``miniredis`` is vcp_tpu's)."""
    srv = t_miniredis.MiniRedisServer(port=0)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture()
def servers(miniredis, t_server, monkeypatch):
    """Both servers with every db flushed and one frozen clock, so stream
    IDs and idle times are the same on both."""
    for mod in (j_miniredis, t_miniredis):
        monkeypatch.setattr(mod, "_now_ms", lambda: NOW_MS)
    miniredis.engine.dbs.clear()
    t_server.engine.dbs.clear()
    return miniredis, t_server


def _read_raw(fh) -> bytes:
    """One RESP2 value off the socket, as the raw bytes it came in."""
    line = fh.readline()
    if not line:
        return b""
    kind, n = line[:1], line[1:-2]
    if kind == b"$" and int(n) >= 0:
        return line + fh.read(int(n) + 2)
    if kind == b"*" and int(n) >= 0:
        return line + b"".join(_read_raw(fh) for _ in range(int(n)))
    return line


def _cmd(*args) -> bytes:
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        b = a if isinstance(a, bytes) else str(a).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
    return b"".join(out)


def run_script(address: str, script: list[bytes]) -> list[bytes]:
    host, port = address.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=10) as s:
        fh = s.makefile("rb")
        replies = []
        for req in script:
            s.sendall(req)
            replies.append(_read_raw(fh))
        return replies


STREAM_SCRIPT = [
    _cmd("PING"), _cmd("PING", "hello"),
    _cmd("XADD", "s", "1-1", "f", "v", "task_id", "a"),
    _cmd("XADD", "s", "MAXLEN", "~", "10", "2-0", "f", "w"),
    _cmd("XADD", "s", "1-0", "f", "old"),               # ID too small
    _cmd("XADD", "s", "*", "f", "star"),
    _cmd("XLEN", "s"), _cmd("XRANGE", "s", "-", "+"),
    _cmd("XRANGE", "s", "-", "+", "COUNT", "1"),
    _cmd("XREADGROUP", "GROUP", "g", "c1", "STREAMS", "s", ">"),
    _cmd("XGROUP", "CREATE", "nokey", "g", "0"),
    _cmd("XGROUP", "CREATE", "s", "g", "0"),
    _cmd("XGROUP", "CREATE", "s", "g", "0"),            # BUSYGROUP
    _cmd("XGROUP", "CREATE", "m", "g", "$", "MKSTREAM"),
    _cmd("XREADGROUP", "GROUP", "g", "c1", "COUNT", "2", "STREAMS", "s",
         ">"),
    _cmd("XREADGROUP", "GROUP", "g", "c2", "COUNT", "5", "BLOCK", "10",
         "STREAMS", "s", ">"),
    _cmd("XREADGROUP", "GROUP", "g", "c2", "BLOCK", "20", "STREAMS", "s",
         ">"),                                          # times out: nil
    _cmd("XREADGROUP", "GROUP", "g", "c1", "STREAMS", "s", "0"),
    _cmd("XPENDING", "s", "g"),
    _cmd("XPENDING", "s", "g", "-", "+", "10"),
    _cmd("XPENDING", "s", "g", "-", "+", "10", "c2"),
    _cmd("XPENDING", "s", "nogroup"),
    _cmd("XINFO", "STREAM", "s"), _cmd("XINFO", "GROUPS", "s"),
    _cmd("XINFO", "CONSUMERS", "s", "g"), _cmd("XINFO", "STREAM", "nokey"),
    _cmd("XINFO", "HELP", "s"),
    _cmd("XACK", "s", "g", "1-1", "9-9"), _cmd("XDEL", "s", "1-1"),
    _cmd("XPENDING", "s", "g"),
    _cmd("XTRIM", "s", "MAXLEN", "1"), _cmd("XTRIM", "s", "MINID", "1"),
    _cmd("XGROUP", "DESTROY", "s", "g"), _cmd("XGROUP", "SETID", "s", "g"),
    _cmd("ZADD", "z", "1.5", "a", "2", "b", "0.5", "c"),
    _cmd("ZADD", "z", "3", "a"), _cmd("ZCARD", "z"),
    _cmd("ZRANGEBYSCORE", "z", "-inf", "+inf"),
    _cmd("ZRANGEBYSCORE", "z", "(0.5", "2", "WITHSCORES"),
    _cmd("ZRANGEBYSCORE", "z", "0", "+inf", "LIMIT", "1", "1"),
    _cmd("ZREMRANGEBYSCORE", "z", "0", "1"), _cmd("ZREM", "z", "b", "x"),
    _cmd("SET", "k", "v", "EX", "100"), _cmd("TTL", "k"), _cmd("GET", "k"),
    _cmd("SETEX", "k2", "50", "w"), _cmd("TTL", "k2"),
    _cmd("SET", "k3", "x"), _cmd("TTL", "k3"), _cmd("TTL", "none"),
    _cmd("EXPIRE", "k3", "10"), _cmd("EXPIRE", "none", "10"),
    _cmd("EXISTS", "k", "k2", "none"), _cmd("KEYS", "*"),
    _cmd("KEYS", "k*"), _cmd("SCAN", "0", "MATCH", "k*", "COUNT", "2"),
    _cmd("SCAN", "2", "COUNT", "100"), _cmd("DBSIZE"),
    _cmd("DEL", "k", "k2", "none"), _cmd("GET", "k"),
    _cmd("SELECT", "2"), _cmd("DBSIZE"), _cmd("SET", "other", "db"),
    _cmd("SELECT", "0"), _cmd("GET", "other"),
    _cmd("NOSUCHCMD", "x"), _cmd("SET", "k"),            # IndexError
    _cmd("ZADD", "z", "notanumber", "m"),                # ValueError
    _cmd("AUTH", "secret"),                              # no password set
    _cmd("FLUSHDB"), _cmd("DBSIZE"), _cmd("FLUSHALL"), _cmd("QUIT"),
]


def test_resp_replies_equal(servers):
    j_srv, t_srv = servers
    j = run_script(j_srv.address, STREAM_SCRIPT)
    t = run_script(t_srv.address, STREAM_SCRIPT)
    assert len(j) == len(STREAM_SCRIPT) and all(j)
    assert t == j


@pytest.mark.parametrize("script", [
    [b"PING\r\n"],                                       # inline command
    [b"*1\r\n:5\r\n"],                                   # not a bulk string
    [b"garbage\r\n\x00\xff\r\n"],
], ids=["inline", "non-bulk", "bytes"])
def test_garbage_input_equal(servers, script):
    """Garbage gets the same error (or the same silent close) from both
    servers, and each server goes on serving."""
    j_srv, t_srv = servers
    j = run_script(j_srv.address, script)
    t = run_script(t_srv.address, script)
    assert t == j
    for srv in servers:
        assert run_script(srv.address, [_cmd("PING")]) == [b"+PONG\r\n"]


def test_auth_replies_equal():
    script = [_cmd("PING"), _cmd("GET", "k"), _cmd("AUTH", "wrong"),
              _cmd("AUTH", "user", "wrong"), _cmd("AUTH", "pw"),
              _cmd("PING"), _cmd("AUTH", "default", "pw"),
              _cmd("SET", "k", "v"), _cmd("GET", "k")]
    out = []
    for mod in (j_miniredis, t_miniredis):
        srv = mod.MiniRedisServer(port=0, password="pw")
        srv.start()
        try:
            out.append(run_script(srv.address, script))
        finally:
            srv.stop()
    assert out[0][0].startswith(b"-NOAUTH")
    assert out[1] == out[0]


def test_task_fields_equal():
    kw = dict(id="1700000000_abcd1234", message_id="5-0",
              source_ip="10.1.2.3", retry=2, input_path="/s/a b.mkv",
              original_name="a b.mkv", output_dir="/o",
              output_name="pre_a b.mp4",
              ffmpeg_args="-c:v h264_nvenc -preset p4 -b:v 10M",
              verify_output=True, published_at=1700000000.125)
    for extra in ({}, {"verify_output": False, "published_at": 0.0,
                       "retry": 0}):
        j = j_stream.Task(**{**kw, **extra})
        t = t_stream.Task(**{**kw, **extra})
        assert t.to_fields() == j.to_fields()
        fields = j.to_fields()
        assert dataclasses.asdict(t_stream.Task.from_fields("5-0", fields)) \
            == dataclasses.asdict(j_stream.Task.from_fields("5-0", fields))
    bad = {"task_id": "x", "retry": "nan?", "published_at": "soon"}
    assert dataclasses.asdict(t_stream.Task.from_fields("1-0", bad)) \
        == dataclasses.asdict(j_stream.Task.from_fields("1-0", bad))


class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1_700_000_000.0 + self.t

    def sleep(self, s):
        self.t += s


def test_rate_limiter_equal(monkeypatch):
    """The same allow() sequence from both limiters under one clock, and
    no lost update when 16 threads take tokens at once."""
    import sys
    clock = _Clock()
    seqs = []
    for mod in (j_stream, t_stream):
        monkeypatch.setattr(mod, "time", clock)
        clock.t = 100.0
        lim = mod.RateLimiter(5)
        seq = []
        for step in (0, 0, 0, 0, 0, 0, 0.125, 0.125, 0.0625, 1.0, 0, 0, 0,
                     0, 0, 0, 0.25):
            clock.t += step
            seq.append(lim.allow())
        seqs.append(seq)
    assert seqs[1] == seqs[0] and seqs[0].count(True) == 12

    lim = t_stream.RateLimiter(100)
    granted = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: granted.extend(lim.allow() for _ in range(50)))
            for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert len(granted) == 800 and granted.count(True) == 100


def test_publish_rate_limited(servers, monkeypatch):
    clock = _Clock()
    errs = []
    for mod, srv in zip((j_stream, t_stream), servers):
        monkeypatch.setattr(mod, "time", clock)
        s = mod.Stream(srv.address, publish_rate_limit=2)
        ids = [s.publish(mod.Task(id=f"t{i}")) for i in range(2)]
        with pytest.raises(Exception) as info:
            s.publish(mod.Task(id="t2"))
        errs.append((ids, type(info.value).__name__, str(info.value),
                     s.get_queue_info().length))
        s.close()
    assert errs[1] == errs[0]
    assert errs[0][1:] == ("RedisError", "publish rate limited", 2)


def _history_ops(mod, client, clock):
    h = mod.HistoryManager(client)
    h.record_task_start("a", "a.mkv", "/s/a.mkv", "c1", "10.0.0.1",
                        dispatch_sec=0.25)
    clock.t += 2.5
    h.record_task_complete("a", "/o/a.mp4", 1234)
    h.record_task_start("b", "b.mp4", "/s/b.mp4", "c2", dispatch_sec=0.5)
    clock.t += 1.0
    h.record_task_failed("b", "encode failed: boom")
    h.record_task_start("c", "c.y4m", "/s/c.y4m", "c1")
    h.record_task_complete("orphan", "/o/x.mp4", 7)       # no start record
    h.record_task_failed("ghost", "input not visible")    # no start record
    keys = sorted(client.execute("KEYS", "*"))
    raw = [client.execute("GET", k) for k in keys if k != b"vcp:history_index"]
    index = client.execute("ZRANGEBYSCORE", "vcp:history_index", "-inf",
                           "+inf", "WITHSCORES")
    stats = h.get_stats()
    stats["records"] = [r.to_json() for r in stats["records"]]
    ttl = client.execute("TTL", "vcp:history:a")
    return keys, raw, index, stats, ttl


def test_history_lifecycle_equal(servers, monkeypatch):
    clock = _Clock()
    out = []
    for mod, stream_mod, srv in ((j_history, j_stream, servers[0]),
                                 (t_history, t_stream, servers[1])):
        monkeypatch.setattr(mod, "time", clock)
        clock.t = 100.0
        out.append(_history_ops(mod, stream_mod.Stream(srv.address).client,
                                clock))
    assert out[1] == out[0]
    keys, raw, index, stats, ttl = out[0]
    assert (stats["total"], stats["completed"], stats["failed"],
            stats["processing"]) == (5, 2, 2, 1)
    assert ttl == 7 * 24 * 3600
    # the wire: each package reads the other's records
    rec = t_history.HistoryManager(
        j_stream.Stream(servers[0].address).client).get_task_history("a")
    assert rec.to_json() == j_history.HistoryManager(
        j_stream.Stream(servers[0].address).client).get_task_history(
            "a").to_json()
    assert rec.status == "completed" and rec.duration_sec == 2.5


def _trim_clean_ops(mod, hist_mod, address):
    s = mod.Stream(address, max_stream_length=6)
    s.create_consumer_group()
    s.create_consumer_group()                              # BUSYGROUP ok
    ids = [s.publish(mod.Task(id=f"t{i}", input_path=f"/s/{i}.mp4"))
           for i in range(9)]
    h = hist_mod.HistoryManager(s.client)
    for i in range(3):
        h.record_task_start(f"t{i}", f"{i}.mp4", f"/s/{i}.mp4", "c")
    got = s.read_group(mod.DEFAULT_GROUP, "dead", count=4, block=0.1)
    again = s.read_pending_tasks(mod.DEFAULT_GROUP, "dead", count=10)
    out = [ids, [dataclasses.asdict(t) for t in got],
           [dataclasses.asdict(t) for t in again],
           dataclasses.asdict(s.get_queue_info()),
           s.get_pending_tasks(mod.DEFAULT_GROUP), s.get_stream_info(),
           s.get_consumer_groups(), s.get_consumers(mod.DEFAULT_GROUP)]
    retry_id = s.retry_task(got[0])
    out += [retry_id, s.trim_stream(3), dataclasses.asdict(s.get_queue_info()),
            s.clean_pending_tasks(mod.DEFAULT_GROUP),
            dataclasses.asdict(s.get_queue_info()), s.delete_history()]
    s.delete_stream()
    out += [dataclasses.asdict(s.get_queue_info()), s.get_stream_info(),
            s.get_pending_tasks(mod.DEFAULT_GROUP),
            s.client.execute("KEYS", "*")]
    s.close()
    return out


def test_trim_and_clean_equal(servers, monkeypatch):
    clock = _Clock()
    out = []
    for mod, hist_mod, srv in ((j_stream, j_history, servers[0]),
                               (t_stream, t_history, servers[1])):
        monkeypatch.setattr(mod, "time", clock)
        monkeypatch.setattr(hist_mod, "time", clock)
        out.append(_trim_clean_ops(mod, hist_mod, srv.address))
    assert out[1] == out[0]
    info = out[0][3]
    assert info == {"length": 6, "pending": 4, "groups": 1}
    assert out[0][-4:-1] == [{"length": 0, "pending": 0, "groups": 0}, {},
                             []]
    assert out[0][-1] == []
