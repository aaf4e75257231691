"""Block motion estimation + motion compensation, plain PyTorch versions.

Port of the main-path subset of ``vcp_tpu/ops/motion.py``:
``full_search`` (full-pel exhaustive SAD search, the plain version of the
``motion_search`` kernel in ``motion_cuda``; ``full_search_split`` models
how that kernel splits and merges the search), ``mc_luma`` (full-pel luma
MC, the plain version of the kernel's fused prediction), ``mc_chroma_q``
(1/8-pel bilinear chroma MC, spec 8.4.2.2.2) and the half-pel tools of
the quality presets: ``half_planes`` (spec 8.4.2.2.1 6-tap planes),
``aligned_windows`` + ``refine_half_mc`` (fused half-pel refinement and
MC from one window gather), their unfused pair ``refine_half`` +
``mc_luma_h``, ``mc_luma_uniform`` (MC of one frame-wide vector), the
quarter-pel tools of efforts 7-9 (``mc_luma_q``: the 16-case quarter-pel
MC of spec 8.4.2.2.1 from the half-pel planes; ``refine_quarter`` and
``refine_subpel``), and
``hier_search`` (the two-level pyramid full-pel search that wide windows
take instead of the exhaustive one). The partitioned P step searches
every granularity (16x16, 8x8, 16x8, 8x16) at once:
``full_search_parts`` exhaustively, ``hier_search_parts`` by the
pyramid. Everything but the 16x16 exhaustive search runs as plain
tensor code on every device. All int32-exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import constant


def pad_edge(x: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Edge-replicate padding of a 2-D integer plane (index clamp)."""
    h, w = x.shape
    dev = x.device
    rows = torch.arange(-top, h + bottom, device=dev).clamp_(0, h - 1)
    cols = torch.arange(-left, w + right, device=dev).clamp_(0, w - 1)
    return x.index_select(0, rows).index_select(1, cols)


def full_search(cur: torch.Tensor, ref: torch.Tensor, search_range: int,
                lam: int = 4, row0: int = 0):
    """Full-pel exhaustive SAD search over ±search_range, 16x16 MBs.

    cur: (Hb, W) int32 (a whole frame when ``row0`` is 0); ref: (H, W).
    Returns (mv (nMBy, nMBx, 2) int32 [dy, dx], best_cost). Cost = SAD +
    lam * (|dx| + |dy|); ties keep the first offset in dy-major,
    dx-ascending order.
    """
    hb, w = cur.shape
    n_mby, n_mbx = hb // 16, w // 16
    sr = search_range
    side = 2 * sr + 1
    ref_pad = pad_edge(ref.to(torch.int32), sr, sr, sr, sr)
    cur_mb = cur.to(torch.int32).reshape(n_mby, 16, n_mbx, 16)
    best_cost = torch.full((n_mby, n_mbx), 2 ** 30, dtype=torch.int32,
                           device=cur.device)
    best_o = torch.zeros((n_mby, n_mbx), dtype=torch.int32,
                         device=cur.device)
    for o in range(side * side):
        dy = o // side - sr
        dx = o % side - sr
        shifted = ref_pad[row0 + dy + sr:row0 + dy + sr + hb,
                          dx + sr:dx + sr + w]
        sad = (cur_mb - shifted.reshape(n_mby, 16, n_mbx, 16)).abs() \
            .sum(dim=(1, 3), dtype=torch.int32)
        cost = sad + lam * (abs(dx) + abs(dy))
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_o = torch.where(better, torch.full_like(best_o, o), best_o)
    mv = torch.stack([best_o // side - sr, best_o % side - sr], dim=-1)
    return mv, best_cost


def _part_sads(sad8: torch.Tensor):
    """The 16x16 / 8x8 / 16x8 / 8x16 SADs of one offset from its per-8x8
    block SADs (2nMBy, 2nMBx): 16x8 halves are block rows, 8x16 halves
    block columns."""
    nby2, nbx2 = sad8.shape
    return (sad8.reshape(nby2 // 2, 2, nbx2 // 2, 2).sum(dim=(1, 3)),
            sad8, sad8[:, 0::2] + sad8[:, 1::2], sad8[0::2, :] + sad8[1::2, :])


def _track_min(best, costs, o: int) -> None:
    """Keep the first offset of the lowest cost per block, in place, for
    each granularity: ``best`` is a list of [cost, offset] pairs."""
    for pair, cost in zip(best, costs):
        better = cost < pair[0]
        pair[0] = torch.where(better, cost, pair[0])
        pair[1] = torch.where(better, o, pair[1])


def _part_init(n_mby: int, n_mbx: int, dev):
    return [[torch.full(shape, 2 ** 30, dtype=torch.int32, device=dev),
             torch.zeros(shape, dtype=torch.int32, device=dev)]
            for shape in ((n_mby, n_mbx), (2 * n_mby, 2 * n_mbx),
                          (2 * n_mby, n_mbx), (n_mby, 2 * n_mbx))]


def full_search_parts(cur: torch.Tensor, ref: torch.Tensor,
                      search_range: int, lam: int = 4):
    """Full-pel exhaustive search at every partition granularity in one
    sweep: each offset's absolute differences reduce once per 8x8 block,
    and the 16x16 / 16x8 / 8x16 SADs are sums of those. Cost = SAD + lam
    * (|dx| + |dy|), first offset (dy-major) on ties, as ``full_search``.
    Returns full-pel (mv16 (nMBy, nMBx, 2), mv8 (2nMBy, 2nMBx, 2), mv16x8
    (2nMBy, nMBx, 2), mv8x16 (nMBy, 2nMBx, 2)), [dy, dx]."""
    h, w = cur.shape
    n_mby, n_mbx = h // 16, w // 16
    sr = search_range
    side = 2 * sr + 1
    ref_pad = pad_edge(ref.to(torch.int32), sr, sr, sr, sr)
    cur_b8 = cur.to(torch.int32).reshape(2 * n_mby, 8, 2 * n_mbx, 8)
    best = _part_init(n_mby, n_mbx, cur.device)
    for o in range(side * side):
        dy = o // side - sr
        dx = o % side - sr
        shifted = ref_pad[dy + sr:dy + sr + h, dx + sr:dx + sr + w]
        sad8 = (cur_b8 - shifted.reshape(cur_b8.shape)).abs() \
            .sum(dim=(1, 3), dtype=torch.int32)
        rate = lam * (abs(dx) + abs(dy))
        _track_min(best, [s + rate for s in _part_sads(sad8)], o)
    return tuple(torch.stack([bo // side - sr, bo % side - sr], dim=-1)
                 for _, bo in best)


SAD_GROUP = 4           # samples per packed word of the motion_search kernel


def sad_keys(cost: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is the lexicographic order of (cost, offset
    index), the tie rule of ``full_search``. The kernel's 64-bit key
    (cost with its sign bit flipped in the high word, the index in the
    low word) is this key plus 2^63, so both order alike."""
    return cost.to(torch.int64) * (1 << 32) + index.to(torch.int64)


def key_cost_index(key: torch.Tensor):
    """(cost, offset index) of ``sad_keys`` keys."""
    return key >> 32, key & 0xFFFFFFFF


def full_search_split(cur: torch.Tensor, ref: torch.Tensor,
                      search_range: int, lam: int = 4, run: int = 12,
                      order=None):
    """Plain model of how the ``motion_search`` kernel splits and merges
    the search; equal to ``full_search``. No path calls it.

    Each MB's offsets are cut into items of one dy and a run of ``run``
    consecutive dx (the last run of a row is cut at the range: its dx
    past 2 sr are computed on the padded window and dropped). An item's
    SADs are sums over words of ``SAD_GROUP`` samples, as the kernel's
    packed absolute differences form them; the item keeps the first
    minimum of its run, as (cost, index) key, and the items are merged by
    the lexicographic minimum. ``order`` is the merge order of an MB's
    items (indices dy * nruns + j); by default the kernel's item order,
    although the kernel's shared-memory atomics merge in whatever order
    the items finish. Returns (mv, best_cost) as ``full_search``."""
    hb, w = cur.shape
    n_mby, n_mbx = hb // 16, w // 16
    sr = search_range
    side = 2 * sr + 1
    nruns = -(-side // run)
    span = run * nruns                     # dx slots, the cut tail included
    dev = cur.device
    ref_pad = pad_edge(ref.to(torch.int32), sr, sr, sr, sr + span - side)
    cur_w = cur.to(torch.int32).reshape(n_mby, 16, n_mbx, 16 // SAD_GROUP,
                                        SAD_GROUP)
    sad = torch.empty((n_mby, n_mbx, side, span), dtype=torch.int32,
                      device=dev)
    for dy in range(side):
        for dx in range(span):
            win = ref_pad[dy:dy + hb, dx:dx + w].reshape(cur_w.shape)
            words = (cur_w - win).abs().sum(dim=4, dtype=torch.int32)
            sad[:, :, dy, dx] = words.sum(dim=(1, 3), dtype=torch.int32)
    dys = torch.arange(side, device=dev)[:, None]
    dxs = torch.arange(span, device=dev)[None, :]
    cost = sad + lam * ((dxs - sr).abs() + (dys - sr).abs()).to(torch.int32)
    keys = sad_keys(cost, dys * side + dxs)
    keys = torch.where(dxs < side, keys, torch.iinfo(torch.int64).max)
    items = keys.reshape(n_mby, n_mbx, side, nruns, run).amin(dim=-1) \
        .reshape(n_mby, n_mbx, side * nruns)
    best = torch.full((n_mby, n_mbx), torch.iinfo(torch.int64).max,
                      dtype=torch.int64, device=dev)
    for i in (range(side * nruns) if order is None else order):
        best = torch.minimum(best, items[..., i])
    best_cost, best_o = key_cost_index(best)
    mv = torch.stack([best_o // side - sr, best_o % side - sr], dim=-1)
    return mv.to(torch.int32), best_cost.to(torch.int32)


def mc_luma(ref: torch.Tensor, mv: torch.Tensor, search_range: int,
            row0: int = 0) -> torch.Tensor:
    """Full-pel luma MC: gather each MB's 16x16 block at its MV.

    ref: (H, W) int32; mv: (nMBy, nMBx, 2) [dy, dx] full-pel."""
    w = ref.shape[1]
    hb = 16 * mv.shape[0]
    sr = search_range
    ref_pad = pad_edge(ref.to(torch.int32), sr, sr, sr, sr)
    dy = mv[..., 0].repeat_interleave(16, 0).repeat_interleave(16, 1)
    dx = mv[..., 1].repeat_interleave(16, 0).repeat_interleave(16, 1)
    dev = ref.device
    rows = torch.arange(hb, device=dev)[:, None] + row0 + dy.long() + sr
    cols = torch.arange(w, device=dev)[None, :] + dx.long() + sr
    return ref_pad[rows, cols]


def mc_chroma_q(ref_c: torch.Tensor, mvq_luma: torch.Tensor, margin: int,
                row0c: int = 0, bs: int = 16) -> torch.Tensor:
    """Chroma MC for quarter-pel luma MVs: the chroma vector in 1/8 units
    equals the quarter-luma value (spec 8.4.1.4); full 1/8 bilinear.
    ``bs`` is the LUMA block size of the MV grid (chroma blocks bs//2)."""
    cs = bs // 2
    hc, wc = cs * mvq_luma.shape[0], cs * mvq_luma.shape[1]
    ref_pad = pad_edge(ref_c.to(torch.int32), margin, margin + 1, margin,
                       margin + 1)

    def px(a):
        return a.repeat_interleave(cs, 0).repeat_interleave(cs, 1)

    dy_i = px(mvq_luma[..., 0] >> 3).long()
    dx_i = px(mvq_luma[..., 1] >> 3).long()
    fy = px(mvq_luma[..., 0] & 7)
    fx = px(mvq_luma[..., 1] & 7)
    dev = ref_c.device
    rows = torch.arange(hc, device=dev)[:, None] + row0c + dy_i + margin
    cols = torch.arange(wc, device=dev)[None, :] + dx_i + margin
    a = ref_pad[rows, cols]
    b = ref_pad[rows, cols + 1]
    c = ref_pad[rows + 1, cols]
    d = ref_pad[rows + 1, cols + 1]
    num = ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
           + (8 - fx) * fy * c + fx * fy * d + 32)
    return num >> 6


# ---------------------------------------------------------------------------
# Hierarchical (two-level pyramid) full-pel search
# ---------------------------------------------------------------------------

REFINE_R = 4            # +-4 full-pel refine window around the coarse MV


def _downsample4(a: torch.Tensor) -> torch.Tensor:
    """4x4 box mean (H, W) -> (H/4, W/4), int32 (rounded)."""
    h, w = a.shape
    return (a.reshape(h // 4, 4, w // 4, 4).sum(dim=(1, 3),
                                                dtype=torch.int32) + 8) >> 4


def _coarse_search(cur4: torch.Tensor, ref4: torch.Tensor, sr4: int,
                   lam: int):
    """Exhaustive search with 4x4 blocks on the quarter-resolution plane
    (one block per full-resolution MB). Returns two full-pel base
    candidates per MB (x4 scale): the per-block argmin, and the argmin of
    the 3x3-block context sum, which stays robust where the box
    decimation aliases the small per-block SAD."""
    h4, w4 = cur4.shape
    nby, nbx = h4 // 4, w4 // 4
    side = 2 * sr4 + 1
    dev = cur4.device
    ref_pad = pad_edge(ref4, sr4, sr4, sr4, sr4)
    cur_b = cur4.reshape(nby, 4, nbx, 4)
    bc_blk = torch.full((nby, nbx), 2 ** 30, dtype=torch.int32, device=dev)
    bc_ctx = bc_blk.clone()
    bo_blk = torch.zeros((nby, nbx), dtype=torch.int32, device=dev)
    bo_ctx = bo_blk.clone()
    for o in range(side * side):
        dy, dx = o // side - sr4, o % side - sr4
        shifted = ref_pad[dy + sr4:dy + sr4 + h4, dx + sr4:dx + sr4 + w4]
        sad = (cur_b - shifted.reshape(nby, 4, nbx, 4)).abs() \
            .sum(dim=(1, 3), dtype=torch.int32)
        rate = abs(dx) + abs(dy)
        cost_blk = sad * 16 + lam * 4 * rate
        sp = pad_edge(sad, 1, 1, 1, 1)
        ctx = sum(sp[dy2:dy2 + nby, dx2:dx2 + nbx]
                  for dy2 in range(3) for dx2 in range(3))
        cost_ctx = ctx * 16 + lam * 4 * 9 * rate
        bb = cost_blk < bc_blk
        bx_ = cost_ctx < bc_ctx
        bc_blk = torch.where(bb, cost_blk, bc_blk)
        bo_blk = torch.where(bb, o, bo_blk)
        bc_ctx = torch.where(bx_, cost_ctx, bc_ctx)
        bo_ctx = torch.where(bx_, o, bo_ctx)

    def mv_of(o):
        return torch.stack([o // side - sr4, o % side - sr4], dim=-1) * 4

    return mv_of(bo_blk), mv_of(bo_ctx)


def _refine_sweep(cur: torch.Tensor, win4: torch.Tensor,
                  mv_base: torch.Tensor, lam: int, r: int,
                  track_parts: bool = False):
    """+-r full-pel sweep over per-MB windows (nMBy, 16+2r, nMBx, 16+2r)
    centered at each MB's base vector; the first offset with the lowest
    cost wins. Returns (mv (nMBy, nMBx, 2), best cost), or with
    ``track_parts`` the 16x16 / 8x8 / 16x8 / 8x16 winners and costs as
    two 4-tuples (the ``full_search_parts`` analogue; every block is
    charged its MB's vector rate)."""
    h, w = cur.shape
    nby, nbx = h // 16, w // 16
    side = 2 * r + 1
    dev = cur.device
    cur_mb = cur.reshape(nby, 16, nbx, 16)
    best = _part_init(nby, nbx, dev)
    if not track_parts:
        best = best[:1]
    for o in range(side * side):
        dy, dx = o // side, o % side
        diff = (cur_mb - win4[:, dy:dy + 16, :, dx:dx + 16]).abs()
        rate = lam * ((mv_base[..., 1] + (dx - r)).abs()
                      + (mv_base[..., 0] + (dy - r)).abs())
        if not track_parts:
            cost = diff.sum(dim=(1, 3), dtype=torch.int32) + rate
            _track_min(best, [cost], o)
            continue
        sad8 = diff.reshape(nby, 2, 8, nbx, 2, 8) \
            .sum(dim=(2, 5), dtype=torch.int32).reshape(2 * nby, 2 * nbx)
        s16, s8, sh, sv = _part_sads(sad8)
        _track_min(best, [s16 + rate, s8 + _px(rate, 2, 2),
                          sh + _px(rate, 2, 1), sv + _px(rate, 1, 2)], o)
    mvs = tuple(_px(mv_base, ry, rx)
                + torch.stack([bo // side - r, bo % side - r], dim=-1)
                for (_, bo), (ry, rx) in zip(best, ((1, 1), (2, 2), (2, 1),
                                                    (1, 2))))
    costs = tuple(bc for bc, _ in best)
    if not track_parts:
        return mvs[0], costs[0]
    return mvs, costs


def _zero_sad(cur: torch.Tensor, ref: torch.Tensor, gran) -> torch.Tensor:
    """Per-block SAD of the zero vector at granularity 16 / 8 / "h"
    (16x8) / "v" (8x16)."""
    h, w = cur.shape
    sad8 = (cur - ref).abs().reshape(h // 8, 8, w // 8, 8) \
        .sum(dim=(1, 3), dtype=torch.int32)
    return _part_sads(sad8)[(16, 8, "h", "v").index(gran)]


def _coarse_bases(cur: torch.Tensor, ref: torch.Tensor, sr: int, lam: int):
    """Both coarse candidates of the pyramid search, clamped so base +
    refine stays within +-sr."""
    sr4 = max(1, -(-sr // 4))
    lim = sr - REFINE_R
    return [b.clamp(-lim, lim) for b in _coarse_search(
        _downsample4(cur), _downsample4(ref), sr4, lam)]


def _hier_refines(cur, ref, sr: int, lam: int, track_parts: bool):
    """The +-REFINE_R sweeps around both coarse candidates."""
    r = REFINE_R
    pad = sr + r
    ref_pad = pad_edge(ref, pad, pad, pad, pad)[None]
    return [_refine_sweep(cur, aligned_windows(ref_pad, b, pad, e=r)[0], b,
                          lam, r, track_parts)
            for b in _coarse_bases(cur, ref, sr, lam)]


def _pick(mv, cost, mv2, cost2, zero_sad):
    """The cheaper of the two refines; the zero vector where its SAD is no
    worse."""
    mv = torch.where((cost2 < cost)[..., None], mv2, mv)
    cost = torch.minimum(cost, cost2)
    return torch.where((zero_sad <= cost)[..., None], 0, mv)


def hier_search(cur: torch.Tensor, ref: torch.Tensor, search_range: int,
                lam: int = 4) -> torch.Tensor:
    """Two-level pyramid full-pel search (the quality presets' wide
    windows, R >= 12), same MV convention as ``full_search``. A coarse
    exhaustive sweep on the 4x-downsampled planes yields two base vectors
    per MB (per-block and context vote), clamped so base + refine stays
    within +-search_range; a +-REFINE_R sweep refines around both and the
    cheaper wins; the winner must beat SAD(0, 0) or the vector is 0."""
    cur = cur.to(torch.int32)
    ref = ref.to(torch.int32)
    (mv, cost), (mv2, cost2) = _hier_refines(cur, ref, search_range, lam,
                                             False)
    return _pick(mv, cost, mv2, cost2, _zero_sad(cur, ref, 16))


def hier_search_parts(cur: torch.Tensor, ref: torch.Tensor,
                      search_range: int, lam: int = 4):
    """Pyramid counterpart of ``full_search_parts``: one coarse 16x16
    sweep, both refines tracking every partition granularity, each
    granularity with its own per-block winner and zero-vector fallback.
    Returns (mv16, mv8, mv16x8, mv8x16) full-pel."""
    cur = cur.to(torch.int32)
    ref = ref.to(torch.int32)
    (mvs, costs), (mvs2, costs2) = _hier_refines(cur, ref, search_range,
                                                 lam, True)
    return tuple(_pick(*a, _zero_sad(cur, ref, g)) for *a, g in zip(
        mvs, costs, mvs2, costs2, (16, 8, "h", "v")))


# ---------------------------------------------------------------------------
# Sub-pel interpolation (spec 8.4.2.2.1: 6-tap half-pel planes)
# ---------------------------------------------------------------------------

def _tap6_x(a: torch.Tensor) -> torch.Tensor:
    """6-tap (1,-5,20,20,-5,1) along x; the result at x is the half sample
    between x and x+1. The input carries >= 3 columns of margin."""
    return (a[:, 0:-5] - 5 * a[:, 1:-4] + 20 * a[:, 2:-3]
            + 20 * a[:, 3:-2] - 5 * a[:, 4:-1] + a[:, 5:])


def _tap6_y(a: torch.Tensor) -> torch.Tensor:
    return (a[0:-5, :] - 5 * a[1:-4, :] + 20 * a[2:-3, :]
            + 20 * a[3:-2, :] - 5 * a[4:-1, :] + a[5:, :])


def half_planes(ref_pad: torch.Tensor):
    """The integer plane and the three half-pel planes of an edge-padded
    int32 plane: (G, b, h, j), each cropped by 3 pixels on every side
    relative to ``ref_pad``. Sample (y, x) of every plane refers to
    integer position (y, x) of G; b is the half sample to its right, h
    below, j diagonal. The edge replication in ``ref_pad`` reproduces the
    spec's coordinate clamping. Intermediates reach about +-2^19, so the
    arithmetic stays int32 with arithmetic shifts."""
    a = ref_pad.to(torch.int32)
    b1 = _tap6_x(a)                           # (Hp, Wp-5)
    h1 = _tap6_y(a)                           # (Hp-5, Wp)
    j1 = _tap6_y(b1)                          # (Hp-5, Wp-5)
    b = torch.clamp((b1 + 16) >> 5, 0, 255)
    h = torch.clamp((h1 + 16) >> 5, 0, 255)
    j = torch.clamp((j1 + 512) >> 10, 0, 255)
    # b1[:, k] sits between ref_pad columns k+2 / k+3, so column x+1 of
    # b1 is "right of x+3"
    return a[3:-3, 3:-3], b[3:-3, 1:], h[1:, 3:-3], j[1:, 1:]


def _bs2(bs):
    """Block size spec -> (bh, bw): int = square, tuple = rectangular."""
    return (bs, bs) if isinstance(bs, int) else bs


def _half_candidates():
    """The nine half-pel candidates around a full-pel vector in scan
    order: (dy, dx) in quarter units, the plane that holds the sample
    (0=G 1=b 2=h 3=j) and the integer offset (iy, ix) into it."""
    for dy in (-2, 0, 2):
        for dx in (-2, 0, 2):
            yield (dy, dx, (2 if dy else 0) + (1 if dx else 0),
                   -1 if dy < 0 else 0, -1 if dx < 0 else 0)


def _mv_rate(cand: torch.Tensor, lam: int) -> torch.Tensor:
    return lam * ((cand[..., 0].abs() + cand[..., 1].abs()) >> 1)


def _px(a: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """Per-block values -> per-pixel grid."""
    return a.repeat_interleave(bh, 0).repeat_interleave(bw, 1)


def refine_half(cur: torch.Tensor, planes, mv_full: torch.Tensor, lam: int,
                margin: int, row0: int = 0, bs=16) -> torch.Tensor:
    """Half-pel refinement with one full-frame gather per candidate.

    Returns mvq in quarter-pel units (phases 0/2); the first candidate
    with the lowest cost SAD + lam * ((|dy| + |dx|) >> 1) wins. ``bs`` is
    the block size the MV grid covers."""
    bh, bw = _bs2(bs)
    n_mby, n_mbx = mv_full.shape[:2]
    h, w = cur.shape
    dev = cur.device
    cur_mb = cur.reshape(n_mby, bh, n_mbx, bw)
    rows = torch.arange(h, device=dev)[:, None] + row0 \
        + _px(mv_full[..., 0], bh, bw).long() + margin
    cols = torch.arange(w, device=dev)[None, :] \
        + _px(mv_full[..., 1], bh, bw).long() + margin
    base = mv_full * 4
    mvq = base
    best = torch.full((n_mby, n_mbx), 2 ** 30, dtype=torch.int32, device=dev)
    for dy, dx, p, iy, ix in _half_candidates():
        pred = planes[p][rows + iy, cols + ix]
        cand = base + torch.tensor([dy, dx], dtype=torch.int32, device=dev)
        cost = (cur_mb - pred.reshape(n_mby, bh, n_mbx, bw)).abs() \
            .sum(dim=(1, 3), dtype=torch.int32) + _mv_rate(cand, lam)
        better = cost < best
        mvq = torch.where(better[..., None], cand, mvq)
        best = torch.minimum(cost, best)
    return mvq


def aligned_windows(planes: torch.Tensor, mv_full: torch.Tensor,
                    margin: int, row0: int = 0, bs=16,
                    e: int = 1) -> torch.Tensor:
    """One batched gather of per-block interpolation windows.

    W[p, by, y, bx, x] = planes[p] at integer position (row0 + bh*by + y -
    e + mv_full[by, bx, 0], bw*bx + x - e + mv_full[by, bx, 1]): every
    block's (bh+2e) x (bw+2e) neighborhood of all four half-pel planes,
    aligned at its own full-pel vector. Returns (4, n_mby, bh+2e, n_mbx,
    bw+2e)."""
    bh, bw = _bs2(bs)
    n_mby, n_mbx = mv_full.shape[:2]
    dev = planes.device
    mv = mv_full.long()
    rows = (row0 + bh * torch.arange(n_mby, device=dev)[:, None, None, None]
            + (torch.arange(bh + 2 * e, device=dev) - e)[None, :, None, None]
            + mv[:, None, :, None, 0] + margin)
    cols = (bw * torch.arange(n_mbx, device=dev)[None, None, :, None]
            + (torch.arange(bw + 2 * e, device=dev) - e)[None, None, None, :]
            + mv[:, None, :, None, 1] + margin)
    return planes[:, rows, cols]


def refine_half_mc(cur: torch.Tensor, planes: torch.Tensor,
                   mv_full: torch.Tensor, lam: int, margin: int,
                   row0: int = 0, bs=16):
    """Fused half-pel refinement + MC: (mvq, pred) with mvq equal to
    ``refine_half`` and pred to ``mc_luma_h(planes, mvq)``, from one
    ``aligned_windows`` gather: every candidate is a static slice of the
    window, and the winner's prediction is kept beside the cost argmin."""
    bh, bw = _bs2(bs)
    n_mby, n_mbx = mv_full.shape[:2]
    dev = cur.device
    win = aligned_windows(planes, mv_full, margin, row0, bs, e=1)
    cur_b = cur.reshape(n_mby, bh, n_mbx, bw)
    base = mv_full * 4
    mvq = base
    best = torch.full((n_mby, n_mbx), 2 ** 30, dtype=torch.int32, device=dev)
    pred = torch.zeros_like(cur_b)
    for dy, dx, p, iy, ix in _half_candidates():
        pr = win[p, :, 1 + iy:1 + iy + bh, :, 1 + ix:1 + ix + bw]
        cand = base + torch.tensor([dy, dx], dtype=torch.int32, device=dev)
        cost = (cur_b - pr).abs().sum(dim=(1, 3), dtype=torch.int32) \
            + _mv_rate(cand, lam)
        better = cost < best
        mvq = torch.where(better[..., None], cand, mvq)
        pred = torch.where(better[:, None, :, None], pr, pred)
        best = torch.minimum(cost, best)
    return mvq, pred.reshape(cur.shape)


def mc_luma_uniform(planes: torch.Tensor, g: torch.Tensor, margin: int,
                    row0: int, h: int, w: int) -> torch.Tensor:
    """Luma MC for ONE frame-uniform quarter-pel vector ``g`` (2,) [dy,
    dx] with half-pel phases (g & 1 == 0): equal to ``mc_luma_h`` with a
    broadcast grid. The window offset stays a device tensor (index
    arithmetic, no host read)."""
    dev = planes.device
    rows = torch.arange(h, device=dev) + (g[0] >> 2) + margin + row0
    cols = torch.arange(w, device=dev) + (g[1] >> 2) + margin
    win = planes[:, rows.long()[:, None], cols.long()[None, :]]
    hx = ((g[1] >> 1) & 1) == 1
    top = torch.where(hx, win[1], win[0])
    bot = torch.where(hx, win[3], win[2])
    return torch.where(((g[0] >> 1) & 1) == 1, bot, top)


def mc_luma_h(planes, mvq: torch.Tensor, margin: int, row0: int = 0,
              bs=16) -> torch.Tensor:
    """Half-pel-only luma MC: mvq phases are in {0, 2}^2 (the
    ``refine_half`` output), so each pixel reads exactly one of the four
    planes."""
    bh, bw = _bs2(bs)
    n_mby, n_mbx = mvq.shape[:2]
    h, w = bh * n_mby, bw * n_mbx
    dev = mvq.device
    rows = torch.arange(h, device=dev)[:, None] + row0 \
        + _px(mvq[..., 0] >> 2, bh, bw).long() + margin
    cols = torch.arange(w, device=dev)[None, :] \
        + _px(mvq[..., 1] >> 2, bh, bw).long() + margin
    hy = _px((mvq[..., 0] >> 1) & 1, bh, bw) == 1
    hx = _px((mvq[..., 1] >> 1) & 1, bh, bw) == 1
    top = torch.where(hx, planes[1][rows, cols], planes[0][rows, cols])
    bot = torch.where(hx, planes[3][rows, cols], planes[2][rows, cols])
    return torch.where(hy, bot, top)


# ---------------------------------------------------------------------------
# Quarter-pel MC and refinement (efforts 7-9)
# ---------------------------------------------------------------------------

# quarter-pel case table: case = fy*4+fx -> (plane1, dy1, dx1, plane2,
# dy2, dx2); planes 0=G (integer), 1=b (half-x), 2=h (half-y), 3=j
# (half-xy). The prediction is (p1 + p2 + 1) >> 1 (a half or integer
# case names the same sample twice). The native decoder's header takes
# this table too (native/build.py).
_QPEL_TABLE = np.array([
    # fy=0
    (0, 0, 0, 0, 0, 0), (0, 0, 0, 1, 0, 0), (1, 0, 0, 1, 0, 0),
    (1, 0, 0, 0, 0, 1),
    # fy=1
    (0, 0, 0, 2, 0, 0), (1, 0, 0, 2, 0, 0), (1, 0, 0, 3, 0, 0),
    (1, 0, 0, 2, 0, 1),
    # fy=2
    (2, 0, 0, 2, 0, 0), (2, 0, 0, 3, 0, 0), (3, 0, 0, 3, 0, 0),
    (3, 0, 0, 2, 0, 1),
    # fy=3
    (0, 1, 0, 2, 0, 0), (2, 0, 0, 1, 1, 0), (3, 0, 0, 1, 1, 0),
    (2, 0, 1, 1, 1, 0),
], dtype=np.int32)

# the eight neighbours refine_quarter tries, in order (quarter units)
_QUARTER_STEPS = np.array([(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
                           (1, -1), (1, 0), (1, 1)], np.int32)


def mc_luma_q(planes: torch.Tensor, mvq: torch.Tensor, margin: int,
              row0: int = 0, bs=16) -> torch.Tensor:
    """Quarter-pel luma MC from the stacked half-pel planes.

    planes: (4, Hp, Wp) int32 [G, b, h, j] (``half_planes``), aligned so
    that index (margin + y, margin + x) is integer position (y, x) of the
    frame. mvq: (nBy, nBx, 2) [dy, dx] in quarter-pel units, one vector
    per ``bs`` block (16, 8, (8, 16) or (16, 8)), covering a band that
    starts at frame row ``row0``. Each pixel averages the two samples its
    case names, (p1 + p2 + 1) >> 1: every block's case picks a flat
    offset into the planes per sample, so the MC is two gathers. With
    margin = sr + 3, every vector that ``refine_subpel`` can return from
    full-pel vectors within +-sr, +-(4 sr + 5), reads inside the planes
    (no index is clamped, as none is in vcp_tpu)."""
    bh, bw = _bs2(bs)
    n_by, n_bx = mvq.shape[:2]
    h, w = bh * n_by, bw * n_bx
    dev = planes.device
    _, hp, wp = planes.shape
    tab = constant("qpel_table", _QPEL_TABLE, dev)              # (16, 6)
    src_off = (tab[:, 0::3] * (hp * wp) + tab[:, 1::3] * wp
               + tab[:, 2::3])                                  # (16, 2)
    mv = mvq.to(torch.int64)
    case = (mv[..., 0] & 3) * 4 + (mv[..., 1] & 3)
    base = ((mv[..., 0] >> 2) + margin + row0) * wp \
        + (mv[..., 1] >> 2) + margin
    off = base[..., None] + src_off[case]                       # (nBy, nBx, 2)
    pix = torch.arange(h, device=dev)[:, None] * wp \
        + torch.arange(w, device=dev)[None, :]
    flat = planes.reshape(-1)
    p1 = flat[pix + _px(off[..., 0], bh, bw)]
    p2 = flat[pix + _px(off[..., 1], bh, bw)]
    return (p1 + p2 + 1) >> 1


def refine_quarter(cur: torch.Tensor, planes: torch.Tensor,
                   mvq: torch.Tensor, lam: int, margin: int, row0: int = 0,
                   bs=16) -> torch.Tensor:
    """Quarter-pel refinement around a half-pel result: starting from the
    cost of ``mvq`` (SAD + lam * ((|dy| + |dx|) >> 1)), each of the eight
    neighbours in turn, taken around the vector that wins so far, replaces
    it only at a strictly lower cost. The walk can move a vector by up to
    3 quarters along an axis."""
    bh, bw = _bs2(bs)
    n_by, n_bx = mvq.shape[:2]
    cur_b = cur.reshape(n_by, bh, n_bx, bw)
    steps = constant("quarter_steps", _QUARTER_STEPS, cur.device,
                     torch.int32)

    def cost_of(m):
        pred = mc_luma_q(planes, m, margin, row0, bs)
        return (cur_b - pred.reshape(n_by, bh, n_bx, bw)).abs() \
            .sum(dim=(1, 3), dtype=torch.int32) + _mv_rate(m, lam)

    mvq = mvq.to(torch.int32)
    best = cost_of(mvq)
    for k in range(len(_QUARTER_STEPS)):
        cand = mvq + steps[k]
        c = cost_of(cand)
        better = c < best
        mvq = torch.where(better[..., None], cand, mvq)
        best = torch.minimum(c, best)
    return mvq


def refine_subpel(cur: torch.Tensor, planes: torch.Tensor,
                  mv_full: torch.Tensor, lam: int, margin: int,
                  quarter: bool = False, row0: int = 0,
                  bs=16) -> torch.Tensor:
    """Full-pel vectors -> sub-pel: half-pel always (``refine_half``),
    quarter-pel on top with ``quarter``."""
    mvq = refine_half(cur, planes, mv_full, lam, margin, row0, bs)
    if quarter:
        mvq = refine_quarter(cur, planes, mvq, lam, margin, row0, bs)
    return mvq
