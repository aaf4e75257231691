"""What crosses the bus in vcp_tpu_torch against vcp_tpu on the CPU: the
changed-tile delta upload (the native ``tile_delta`` pass and its numpy
reference, the device carry of ``source_tiles`` / ``delta_planes`` /
``encode_iframe_delta`` / ``encode_pchunk_delta``), the one-buffer P-chunk
fetch (``combine_fetch`` / ``split_fetch``) and the word-sparse B-GOP
fetch (``sparsify_buf`` / ``unsparsify_buf``), and the encoder streams,
carried tiles and sticky caps for every ``VCP_DELTA`` x ``VCP_SPARSE_B``
setting. Exact equality."""

import numpy as np
import pytest
import torch

from vcp_tpu.codec.h264 import encoder as je
from vcp_tpu.codec.h264 import gop_ops as jg
from vcp_tpu.ops import transform as jtf
from vcp_tpu_torch import native
from vcp_tpu_torch.codec.h264 import encoder as te
from vcp_tpu_torch.codec.h264 import gop_ops as tg
from vcp_tpu_torch.native import build as native_build

# 6 x 4 MBs: a bucket is min(128, n_mb), so every frame with fewer
# changed tiles than MBs is padded (index n_mb). The device-level cases
# take the encoders' shapes (4-frame chunks, sr 8, full-pel, deblocking),
# so that vcp_tpu traces each program once for the whole module.
W, H = 96, 64
N_MB = (H // 16) * (W // 16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(port, ref, msg=""):
    np.testing.assert_array_equal(
        port.numpy() if isinstance(port, torch.Tensor) else port,
        np.asarray(ref), err_msg=msg)


def box_frames(n, w=W, h=H, step=8, cut=None, seed=0):
    """A fixed textured background with a textured box (48x48, at most
    half the frame height) moving ``step`` px a frame (no noise, so unchanged tiles
    stay equal); the background inverted from frame ``cut`` on."""
    rng = np.random.default_rng(seed)
    bg = [rng.integers(40, 216, s, dtype=np.uint8)
          for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    side = min(48, h // 2)
    box = [rng.integers(0, 256, (s, s), dtype=np.uint8)
           for s in (side, side // 2, side // 2)]
    out = []
    for t in range(n):
        planes = [255 - p if cut is not None and t >= cut else p.copy()
                  for p in bg]
        x, y = 8 + (step * t) % (w - side - 8), 21 if h > 64 else 9
        for k, (p, b) in enumerate(zip(planes, box)):
            s = 2 if k else 1
            p[y // s:y // s + b.shape[0], x // s:x // s + b.shape[1]] = b
        out.append(tuple(planes))
    return out


def noisy_frames(n, w=W, h=H, seed=1):
    """Every pixel of every frame fresh: every tile changes."""
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 256, s, dtype=np.uint8)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# The host side of the upload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(48, 64), (1088, 1920)])
@pytest.mark.parametrize("case", ["full", "unchanged", "all_changed",
                                  "box"])
def test_tile_delta(shape, case):
    """The native pass equals vcp_tpu's ``tile_delta`` and the numpy pair
    in idx, tiles and the updated carry."""
    h, w = shape
    fr = box_frames(2, w, h, step=8)
    if case == "all_changed":
        fr = noisy_frames(2, w, h)
    a, b = fr
    if case == "unchanged":
        b = a
    prev0 = tg.tiles_from_planes_host(*a)
    full = case == "full"
    if full:
        prev0 = np.zeros_like(prev0)
    pt, pj = prev0.copy(), prev0.copy()
    it, tt = tg.tile_delta(*b, pt, full=full)
    ij, tj = jg.tile_delta(*b, pj, full=full)
    cur = tg.tiles_from_planes_host(*b)
    if full:
        ih, th = np.arange(len(cur), dtype=np.int32), cur
    else:
        ih, th = tg.delta_tiles_host(prev0, cur)
    _eq(it, ij)
    _eq(tt, tj)
    _eq(it, ih)
    _eq(tt, th)
    _eq(pt, pj)
    _eq(pt, cur)
    assert it.dtype == np.int32 and tt.dtype == np.uint8
    want = {"full": len(cur), "unchanged": 0, "all_changed": len(cur)}
    if case in want:
        assert len(it) == want[case]
    else:
        assert 0 < len(it) < len(cur)


def test_host_tiles_equal_vcp_tpu():
    fr = box_frames(2)
    prev = jg.tiles_from_planes_host(*fr[0])
    cur = jg.tiles_from_planes_host(*fr[1])
    _eq(tg.tiles_from_planes_host(*fr[1]), cur)
    for a, b in zip(tg.delta_tiles_host(prev, cur),
                    jg.delta_tiles_host(prev, cur)):
        _eq(a, b)


def test_buckets_and_padding():
    for n_mb in (12, 140, 8160):
        for k in (0, 1, 127, 128, 129, 511, 512, 513, 2048, 8159, 8160):
            if k > n_mb:
                continue
            assert tg.delta_bucket(k, n_mb) == jg.delta_bucket(k, n_mb)
    for cap in (16, 300, 65280):
        for count in (0, 1, 255, 256, 4096, 4097, 9000, 65280):
            for base in (256, 2048, 4096):
                assert tg.fetch_bucket(count, cap, base) == \
                    jg.fetch_bucket(count, cap, base)
    rng = np.random.default_rng(3)
    for n_mb, k, bucket in ((140, 5, 128), (140, 128, 128), (24, 0, 24),
                            (24, 3, 24)):
        idx = np.sort(rng.choice(n_mb, k, replace=False)).astype(np.int32)
        tiles = rng.integers(0, 256, (k, tg.TILE_WORDS), dtype=np.uint8)
        for a, b in zip(tg.pad_delta(idx, tiles, bucket, n_mb),
                        jg.pad_delta(idx, tiles, bucket, n_mb)):
            _eq(a, b)
            assert a.dtype == np.asarray(b).dtype


def test_tile_delta_raises_without_host_library(monkeypatch):
    """A failed host-library build raises out of ``tile_delta``; nothing
    routes to the numpy pair."""
    def broken():
        raise RuntimeError("host entropy build failed: g++ said no")

    monkeypatch.setattr(native_build, "build", broken)
    native.get_lib.cache_clear()
    a, b = box_frames(2, 64, 48)
    prev = tg.tiles_from_planes_host(*a)
    try:
        with pytest.raises(RuntimeError, match="build failed"):
            tg.tile_delta(*b, prev)
        _eq(prev, tg.tiles_from_planes_host(*a))       # untouched
    finally:
        native.get_lib.cache_clear()


# ---------------------------------------------------------------------------
# The device side of the upload
# ---------------------------------------------------------------------------

def _deltas(frames, bucket=None):
    """Host deltas of frames[1:] against frames[0], each padded to one
    bucket: (idx (N, K), tiles (N, K, 384)), and the tiles of frame 0."""
    prev = tg.tiles_from_planes_host(*frames[0])
    first = prev.copy()
    got = [tg.tile_delta(*f, prev) for f in frames[1:]]
    k = bucket or tg.delta_bucket(max(len(i) for i, _ in got), N_MB)
    pads = [tg.pad_delta(i, t, k, N_MB) for i, t in got]
    return (np.stack([p[0] for p in pads]), np.stack([p[1] for p in pads]),
            first)


@pytest.fixture(scope="module")
def box():
    return box_frames(5)


def test_source_tiles_and_delta_planes(box):
    """The MB-tiled carry from planes, and one padded delta applied (the
    bucket holds padding rows with index n_mb)."""
    idx, tiles, _ = _deltas(box[:2])
    assert idx.shape[1] == N_MB and (idx == N_MB).any()
    sj = jg.source_tiles(*box[0], H, W)
    st = tg.source_tiles(*(_t(p) for p in box[0]), H, W)
    for a, b in zip(st, sj):
        _eq(a, b)
    oj = jg.delta_planes(*sj, idx[0], tiles[0], H, W)
    ot = tg.delta_planes(*st, _t(idx[0]), _t(tiles[0]), H, W)
    for a, b in zip(ot, oj):
        _eq(a, b)
    for a, b in zip(ot[3:], box[1]):
        _eq(a, b)                       # the untiled planes are the frame


@pytest.mark.parametrize("content", ["box", "cut"])
def test_encode_iframe_delta(box, content):
    """An IDR as a delta against the carried source: a few tiles (padded
    bucket) or, at a scene cut, every tile (bucket n_mb)."""
    frames = [box[0], box[1]] if content == "box" else \
        [box[0], box_frames(2, cut=1)[1]]
    idx, tiles, _ = _deltas(frames)
    qp = 23
    sj = jg.source_tiles(*frames[0], H, W)
    st = tg.source_tiles(*(_t(p) for p in frames[0]), H, W)
    j = jg.encode_iframe_delta(*sj, idx[0], tiles[0], qp, jtf.chroma_qp(qp),
                               H, W, True)
    t = tg.encode_iframe_delta(*st, _t(idx[0]), _t(tiles[0]), qp,
                               jtf.chroma_qp(qp), H, W, True)
    cnt = int(np.asarray(j[1])[0])
    assert int(t[1][0]) == cnt
    _eq(t[0], j[0])
    _eq(t[2][:cnt], np.asarray(j[2])[:cnt])
    for a, b in zip(t[3:], j[3:]):
        _eq(a, b)


@pytest.fixture(scope="module")
def pchunk(box):
    """One 4-frame delta P chunk from an IDR recon, through vcp_tpu and
    the port (padded bucket): (port outputs, vcp_tpu outputs)."""
    qp = 26
    idx, tiles, _ = _deltas(box)
    assert idx.shape == (4, N_MB) and (idx == N_MB).any()
    ij = jg.encode_iframe_sparse(*box[0], qp - 3, jtf.chroma_qp(qp - 3),
                                 True)
    recon = [np.asarray(p) for p in ij[3:]]
    sj = jg.source_tiles(*box[0], H, W)
    st = tg.source_tiles(*(_t(p) for p in box[0]), H, W)
    j = jg.encode_pchunk_delta(*sj, idx, tiles, *recon, qp,
                               jtf.chroma_qp(qp), 8, 5, H, W, True, 0, False)
    t = tg.encode_pchunk_delta(*st, _t(idx), _t(tiles),
                               *(_t(p) for p in recon), qp,
                               jtf.chroma_qp(qp), 8, 5, H, W, True, 0,
                               False)
    return t, j


def test_encode_pchunk_delta(pchunk, box):
    """bitmap, counts, meta and payload rows, the carried (sy, su, sv) and
    the recon of the last frame."""
    t, j = pchunk
    mcount, bcount = (int(c) for c in np.asarray(j[1]))
    assert 0 < mcount and 0 < bcount
    _eq(t[0], j[0])
    _eq(t[1], j[1])
    _eq(t[2][:mcount], np.asarray(j[2])[:mcount])
    _eq(t[3][:bcount], np.asarray(j[3])[:bcount])
    for a, b, name in zip(t[4:], j[4:], ("sy", "su", "sv", "ry", "ru",
                                         "rv")):
        _eq(a, b, name)
    _eq(t[4], tg.tiles_from_planes_host(*box[4])[:, :256])


@pytest.mark.parametrize("mcap,pcap", [(512, 256), (4, 2), (0, 0),
                                       (4, 256)])
def test_combine_split_fetch(pchunk, mcap, pcap):
    """The one fetch buffer of a P chunk and its host split, with caps
    above and below the counts (the overflow leaves rows for the tail)."""
    t, j = pchunk
    mcap, pcap = min(mcap, t[2].shape[0]), min(pcap, t[3].shape[0])
    ct = tg.combine_fetch(*t[:4], mcap, pcap)
    cj = jg.combine_fetch(*j[:4], mcap, pcap)
    _eq(ct, cj)
    assert ct.dtype == torch.int16
    st = tg.split_fetch(ct.numpy(), 4, N_MB, mcap, pcap)
    sj = jg.split_fetch(np.asarray(cj), 4, N_MB, mcap, pcap)
    assert st[:2] == sj[:2] == tuple(int(c) for c in np.asarray(j[1]))
    for a, b in zip(st[2:], sj[2:]):
        _eq(a, b)


@pytest.mark.parametrize("n,nnz,cap", [
    (5003, 200, 64),        # n % 16 != 0, overflow into the tail
    (5003, 200, 4096),      # no overflow
    (4096, 0, 16),          # all zero
    (17, 17, 1),            # one padded chunk past the cap
])
def test_sparsify_buf(n, nnz, cap):
    rng = np.random.default_rng(n + nnz)
    buf = np.zeros(n, np.int16)
    buf[rng.choice(n, nnz, replace=False)] = \
        rng.integers(1, 3000, nnz).astype(np.int16) * rng.choice([-1, 1],
                                                                 nnz)
    ct, compt = tg.sparsify_buf(_t(buf), cap)
    cj, compj = jg.sparsify_buf(buf, cap)
    _eq(ct, cj)
    count = int(np.asarray(cj[:2]).view(np.int32)[0])
    _eq(compt[:count], np.asarray(compj)[:count])
    dt, kt = tg.unsparsify_buf(ct.numpy(), n, cap, compt)
    dj, kj = jg.unsparsify_buf(np.asarray(cj), n, cap, compj)
    assert kt == kj == count
    _eq(dt, dj)
    _eq(dt, buf)


# ---------------------------------------------------------------------------
# The encoders
# ---------------------------------------------------------------------------

PAIRS = [("0", "0"), ("0", "1"), ("1", "0"), ("1", "1")]


def _speed(**kw):
    return dict(width=W, height=H, qp=26, gop_size=5, effort=4, **kw)


def _run(enc, plan, frames):
    out = []
    for kind, lo, hi in plan:
        if kind == "gop":
            out += [tuple(s) for s in enc.encode_gop(frames[lo:hi])]
        else:
            for f in frames[lo:hi]:
                out.append(tuple(enc.encode_frame(*f)))
    return out


def _state(enc):
    tiles = getattr(enc, "_prev_tiles", None)
    return (None if tiles is None else np.asarray(tiles).copy(),
            enc._mcap, enc._pcap, dict(getattr(enc, "_spcaps", {})))


def _assert_encoders_equal(cfg, plan, frames, monkeypatch, delta, sparse,
                           caps=None):
    monkeypatch.setenv("VCP_DELTA", delta)
    monkeypatch.setenv("VCP_SPARSE_B", sparse)
    j = je.H264Encoder(je.EncoderConfig(**cfg))
    t = te.H264Encoder(te.EncoderConfig(**cfg), device="cpu")
    for enc in (j, t):
        for k, v in (caps or {}).items():
            setattr(enc, k, dict(v) if isinstance(v, dict) else v)
    got, want = _run(t, plan, frames), _run(j, plan, frames)
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"access unit {k} differs"
    st, sj = _state(t), _state(j)
    if sj[0] is None:
        assert st[0] is None
    else:
        _eq(st[0], sj[0], "carried tiles")
    assert st[1:] == sj[1:]
    if t._src_dev is not None:
        _eq(t._src_dev[0], tg.tiles_from_planes_host(
            *(te.H264Encoder._pad(t, *frames[plan[-1][2] - 1])))[:, :256])
    return t


SCENARIOS = {
    # two GOPs of 5: the second IDR a delta against the carry
    "two_gops": (_speed(), [("gop", 0, 5), ("gop", 5, 10)],
                 lambda: box_frames(10, W, H)),
    # nothing changes: every delta is empty (K = 0, a bucket of padding)
    "static": (_speed(), [("gop", 0, 5), ("gop", 5, 10)],
               lambda: [box_frames(1, W, H)[0]] * 10),
    # B pictures; the last GOP of 2 frames takes the P path, so the carry
    # passes from the B coder to the P coder and back
    "b_stream": (_speed(bframes=2), [("gop", 0, 5), ("gop", 5, 7),
                                     ("gop", 7, 12)],
                 lambda: box_frames(12, W, H)),
    # encode_frame between GOPs drops the carry
    "encode_frame": (_speed(), [("gop", 0, 5), ("frame", 5, 6),
                                ("gop", 6, 11)],
                     lambda: box_frames(11, W, H)),
}


@pytest.mark.parametrize("delta,sparse", PAIRS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_encoder_matches_vcp_tpu(monkeypatch, scenario, delta, sparse):
    cfg, plan, make = SCENARIOS[scenario]
    _assert_encoders_equal(cfg, plan, make(), monkeypatch, delta, sparse)


@pytest.mark.parametrize("delta,sparse", [("1", "1"), ("0", "1")])
def test_small_caps_grow_as_in_vcp_tpu(monkeypatch, delta, sparse):
    """Caps far below the counts force the tail fetches of both coders;
    the caps grow as vcp_tpu's do."""
    frames = noisy_frames(12, W, H)
    caps = {"_mcap": 4, "_pcap": 2, "_spcaps": {"i": 16, "p": 16,
                                                "b": 16}}
    t = _assert_encoders_equal(
        _speed(bframes=2), [("gop", 0, 5), ("gop", 5, 7), ("gop", 7, 12)],
        frames, monkeypatch, delta, sparse, caps)
    assert t._mcap > 4 and t._pcap > 2
    assert all(c > 16 for c in t._spcaps.values())
