"""The RD intra wavefront as a replayed CUDA graph, on the card: IDRs
from ``intra_rd.encode_iframe_rd8`` and ``encode_iframe_rd`` on ``cuda``
equal to the same calls on ``cpu`` (the eager steps), one capture per
(frame size, QP) and one replay per diagonal, the least recently used
graph evicted at the cache's bound, and worker threads that share the
cache. Imports nothing of JAX: run on a machine with a card as

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_card_intra_rd.py

Without CUDA every test skips."""

import sys
import threading

import numpy as np
import pytest
import torch

from vcp_tpu_torch.codec.h264 import intra_rd as tir
from vcp_tpu_torch.ops.transform import chroma_qp

pytestmark = pytest.mark.card

H, W = 144, 240                      # 9 x 15 MBs


def _frame(seed: int, h: int = H, w: int = W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    y = 128 + 60 * np.sin(xx / (3 + seed % 5)) * np.cos(yy / 2.1) \
        + rng.integers(-20, 21, (h, w))
    u = 128 + 30 * np.sin(xx[::2, ::2] / 7.0) \
        + rng.integers(-4, 5, (h // 2, w // 2))
    v = 100 + 0.3 * yy[::2, ::2] + rng.integers(-4, 5, (h // 2, w // 2))
    return tuple(torch.from_numpy(np.clip(p, 0, 255).astype(np.uint8))
                 for p in (y, u, v))


@pytest.fixture()
def card():
    """The first card, with an empty graph cache; skips without CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with tir._graphs_lock:
        tir._graphs.clear()
    return torch.device("cuda", 0)


def _encode(fn, planes, qp: int, dev):
    out = fn(*(p.to(dev) for p in planes), qp, chroma_qp(qp), True)
    return {k: t.cpu() for k, t in out.items()}


def _assert_same(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert torch.equal(got[k], want[k]), f"{what}: {k}"


def _steps(maps, h: int = H, w: int = W) -> int:
    return maps(h // 16, w // 16)[0].shape[0]


def test_rd8_replays_equal_cpu(card):
    """Two IDRs at QP 26 and one at QP 33: equal to the eager steps on
    the CPU, two captures, one replay per diagonal of each IDR."""
    drv = tir.run_wavefront
    c0, r0 = drv.captures, drv.replays
    for seed, qp in ((1, 26), (2, 26), (3, 33)):
        planes = _frame(seed)
        _assert_same(_encode(tir.encode_iframe_rd8, planes, qp, card),
                     _encode(tir.encode_iframe_rd8, planes, qp, "cpu"),
                     f"rd8 seed {seed} qp {qp}")
    assert drv.captures - c0 == 2
    assert drv.replays - r0 == 3 * _steps(tir.diagonal_maps2)


@pytest.mark.parametrize("h,w", [(H, W), (1088, 1920)])
def test_rd_replays_equal_cpu(card, h, w):
    """The I16-only RD IDR over the anti-diagonal wavefront, twice at one
    QP: equal to the CPU, one capture."""
    drv = tir.run_wavefront
    c0, r0 = drv.captures, drv.replays
    for seed in (4, 5):
        planes = _frame(seed, h, w)
        _assert_same(_encode(tir.encode_iframe_rd, planes, 30, card),
                     _encode(tir.encode_iframe_rd, planes, 30, "cpu"),
                     f"rd seed {seed} {h}x{w}")
    assert drv.captures - c0 == 1
    assert drv.replays - r0 == 2 * _steps(tir.diagonal_maps, h, w)


def test_cache_evicts_least_recent(card, monkeypatch):
    """At a bound of 2, a third key evicts the least recently used one,
    which captures anew when it comes back; a used key is kept."""
    monkeypatch.setattr(tir, "GRAPH_CACHE_SIZE", 2)
    drv = tir.run_wavefront
    planes = _frame(6)
    c0 = drv.captures
    for qp in (20, 24, 20, 28):          # 20 used again before 28 arrives
        _encode(tir.encode_iframe_rd8, planes, qp, card)
    assert drv.captures - c0 == 3
    assert [k[4] for k in tir._graphs] == [20, 28]
    _assert_same(_encode(tir.encode_iframe_rd8, planes, 24, card),
                 _encode(tir.encode_iframe_rd8, planes, 24, "cpu"),
                 "qp 24 captured again")
    assert drv.captures - c0 == 4
    assert [k[4] for k in tir._graphs] == [28, 24]


def test_threads_share_the_cache(card):
    """Six threads encode IDRs of their own content at one QP at once
    with a short switch interval: each equal to its CPU encode."""
    frames = [_frame(10 + i) for i in range(6)]
    want = [_encode(tir.encode_iframe_rd8, p, 27, "cpu") for p in frames]
    got: list = [None] * len(frames)
    errors: list = []

    def work(i):
        try:
            for _ in range(2):
                got[i] = _encode(tir.encode_iframe_rd8, frames[i], 27, card)
        except Exception as exc:  # reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(frames))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, f"thread {i}")
