"""RD-selected intra frame encode (the quality presets' IDR), wavefront.

Port of ``encode_iframe_rd``, ``encode_iframe_rd8`` and their helpers
from ``vcp_tpu/codec/h264/intra_rd.py``. Every MB picks, by
rate-distortion cost (SSD + lambda2 * bits estimate), its Intra_16x16
mode (Vertical / Horizontal / DC / Plane, spec 8.3.3) and, in
``encode_iframe_rd8``, between that and I_NxN with the 8x8 transform
(four 8x8 blocks, 9 directional modes each, spec 8.3.2), plus a chroma
mode shared by Cb and Cr (DC / Horizontal / Vertical / Plane, spec 8.3.4).

An I16 MB reads its left, top and top-left neighbours, so
``encode_iframe_rd`` runs over anti-diagonals d = mby + mbx
(``diagonal_maps``). An i8 block also reads the above-right MB's bottom
row, which an anti-diagonal would process concurrently, so
``encode_iframe_rd8`` runs over slope-2 diagonals d = 2*mby + mbx
(``diagonal_maps2``). Every MB on a diagonal depends only on earlier
diagonals, so each step handles a whole diagonal as a batch of lanes
(the ``lax.scan`` of the reference is a Python loop over device tensors
here). Within an i8 trial the four 8x8 blocks run in raster order, each
predicting from the plane as the previous one left it; the MB-level
decision then overwrites the MB with the winner.

Sample arithmetic is int32-exact; the costs are float32 built from the
device-independent pieces of ``rdcost``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import constant
from ...ops import transform as tf
from ...ops import transform8 as t8ops
from . import rdcost
from .frame_ops import _blk_order, _zigzag

# mode-signalling overhead (bins) for the I16-vs-i8 decision: I16 mb_type
# carries ~5 suffix bins + the always-coded qp_delta; I_NxN adds the
# transform flag and a 6-bin CBP but its mode bits ride in the block costs
I16_OVERHEAD_BITS = 7.0
I8_OVERHEAD_BITS = 9.0
# extra mb_type prefix bin + lost-skip opportunity for intra inside a P
# slice
P_INTRA_EXTRA_BITS = 2.0

# intra_chroma_pred_mode ue(v) bit cost per mode 0..3
_CHROMA_UE_BITS = np.array([1.0, 3.0, 3.0, 5.0], np.float32)

# availability required per i8 mode 0..8: (needs_top, needs_left)
_I8_NEED_T = np.array([1, 0, 0, 1, 1, 1, 1, 1, 0], bool)
_I8_NEED_L = np.array([0, 1, 0, 0, 1, 1, 1, 0, 1], bool)


def _maps(lanes: list, nby: int, nbx: int):
    """Index maps of a wavefront given each step's (mby, mbx) cells:
    (MBY, MBX, VALID) each (D, L) plus the inverse maps (DMAP, KMAP) with
    stacked[DMAP[y, x], KMAP[y, x]] == (y, x)."""
    D = len(lanes)
    L = max(1, max(len(c) for c in lanes) if lanes else 1)
    MBY = np.zeros((D, L), np.int32)
    MBX = np.zeros((D, L), np.int32)
    VALID = np.zeros((D, L), bool)
    DMAP = np.zeros((nby, nbx), np.int32)
    KMAP = np.zeros((nby, nbx), np.int32)
    for d, cells in enumerate(lanes):
        for k, (mby, mbx) in enumerate(cells):
            MBY[d, k] = mby
            MBX[d, k] = mbx
            VALID[d, k] = True
            DMAP[mby, mbx] = d
            KMAP[mby, mbx] = k
    return MBY, MBX, VALID, DMAP, KMAP


def diagonal_maps(nby: int, nbx: int):
    """Anti-diagonal wavefront maps (``_maps``): MB (mby, mbx) runs at
    step d = mby + mbx, lanes in increasing mby."""
    return _maps([[(mby, d - mby) for mby in range(nby) if 0 <= d - mby < nbx]
                  for d in range(nby + nbx - 1)], nby, nbx)


def diagonal_maps2(nby: int, nbx: int):
    """Slope-2 wavefront maps (``_maps``): MB (mby, mbx) runs at step d =
    2*mby + mbx."""
    D = 2 * nby + nbx - 2 if nby and nbx else 0
    return _maps([[(mby, d - 2 * mby) for mby in range(nby)
                   if 0 <= d - 2 * mby < nbx] for d in range(D)], nby, nbx)


def _build_i8_tables() -> np.ndarray:
    """(6, 3, 8, 8) gather tables for the directional 8x8 modes 3..8
    (spec 8.3.2.2): every predicted sample is (r[Ia] + 2*r[Ib] + r[Ic] +
    2) >> 2 over the flat reference vector r = [left(8) | corner |
    top(16)]. Two-tap samples (a + b + 1) >> 1 use (a, b, a) and plain
    copies (a, a, a), with identical integer results. Axis 1 holds (Ia,
    Ic, Ib)."""
    ns = 8
    L, M, T = 0, ns, ns + 1          # le[i] = i, m = ns, t[i] = ns+1+i
    tabs = []
    for mode in (3, 4, 5, 6, 7, 8):
        I1 = np.zeros((ns, ns), np.int32)
        I2 = np.zeros((ns, ns), np.int32)
        I3 = np.zeros((ns, ns), np.int32)
        for yy in range(ns):
            for xx in range(ns):
                if mode == 3:                          # diag down-left
                    if xx == ns - 1 and yy == ns - 1:
                        a, b, c = T + 2 * ns - 2, T + 2 * ns - 1, \
                            T + 2 * ns - 1
                    else:
                        i = xx + yy
                        a, b, c = T + i, T + i + 1, T + i + 2
                elif mode == 4:                        # diag down-right
                    if xx > yy:
                        i = xx - yy
                        a = M if i == 1 else T + i - 2
                        b, c = T + i - 1, T + i
                    elif xx < yy:
                        i = yy - xx
                        a = M if i == 1 else L + i - 2
                        b, c = L + i - 1, L + i
                    else:
                        a, b, c = T + 0, M, L + 0
                elif mode == 5:                        # vertical-right
                    z = 2 * xx - yy
                    i = xx - (yy >> 1)
                    if z >= 0 and z % 2 == 0:
                        a = M if i == 0 else T + i - 1
                        b, c = T + i, a
                    elif z >= 0:
                        a = M if i == 1 else T + i - 2
                        b, c = T + i - 1, T + i
                    elif z == -1:
                        a, b, c = L + 0, M, T + 0
                    else:
                        j = yy - 2 * xx
                        a, b = L + j - 1, L + j - 2
                        c = L + j - 3 if j >= 3 else M
                elif mode == 6:                        # horizontal-down
                    z = 2 * yy - xx
                    i = yy - (xx >> 1)
                    if z >= 0 and z % 2 == 0:
                        a = M if i == 0 else L + i - 1
                        b, c = L + i, a
                    elif z >= 0:
                        a = M if i == 1 else L + i - 2
                        b, c = L + i - 1, L + i
                    elif z == -1:
                        a, b, c = T + 0, M, L + 0
                    else:
                        j = xx - 2 * yy
                        a, b = T + j - 1, T + j - 2
                        c = T + j - 3 if j >= 3 else M
                elif mode == 7:                        # vertical-left
                    i = xx + (yy >> 1)
                    if yy % 2 == 0:
                        a, b, c = T + i, T + i + 1, T + i
                    else:
                        a, b, c = T + i, T + i + 1, T + i + 2
                else:                                  # horizontal-up
                    z = xx + 2 * yy
                    if z > 2 * ns - 3:
                        a = b = c = L + ns - 1
                    elif z == 2 * ns - 3:
                        a, b, c = L + ns - 2, L + ns - 1, L + ns - 1
                    elif z % 2 == 0:
                        i = yy + (xx >> 1)
                        a, b, c = L + i, L + i + 1, L + i
                    else:
                        i = yy + (xx >> 1)
                        a, b, c = L + i, L + i + 1, L + i + 2
                I1[yy, xx], I2[yy, xx], I3[yy, xx] = a, b, c
        tabs.append(np.stack([I1, I3, I2]))
    return np.stack(tabs)


I8_TABS = _build_i8_tables()


def _plane_pred(text, lext, size: int):
    """Plane prediction (spec 8.3.3.4 luma size=16 / 8.3.4.4 chroma
    size=8). text/lext: (L, size+1) int32 with [:, 0] = the above-left
    corner, [:, 1:] = the top row / left column."""
    half = size // 2
    dev = text.device
    w = torch.arange(1, half + 1, dtype=torch.int32, device=dev)
    hh = (w * (text[:, half + 1:] - text[:, :half].flip(1))) \
        .sum(1, dtype=torch.int32)
    vv = (w * (lext[:, half + 1:] - lext[:, :half].flip(1))) \
        .sum(1, dtype=torch.int32)
    a = 16 * (text[:, size] + lext[:, size])
    if size == 16:
        b = (5 * hh + 32) >> 6
        c = (5 * vv + 32) >> 6
    else:
        b = (17 * hh + 16) >> 5
        c = (17 * vv + 16) >> 5
    xs = torch.arange(size, dtype=torch.int32, device=dev) - (half - 1)
    grid = (a[:, None, None] + b[:, None, None] * xs[None, None, :]
            + c[:, None, None] * xs[None, :, None] + 16) >> 5
    return torch.clamp(grid, 0, 255)


def _bits_proxy(levels):
    """~2*log2(|z|+1)+1.7 bits per nonzero level, summed over all but the
    two leading dims."""
    return rdcost.level_bits(levels, tuple(range(2, levels.dim())))


def _dc_or(avt, avl, both, t_only, l_only):
    """DC value by neighbor availability (128 with neither)."""
    return torch.where(avt & avl, both,
                       torch.where(avt, t_only,
                                   torch.where(avl, l_only, 128)))


def _luma_modes(cur, top, left, corner, avt, avl, qp: int, lam2: float):
    """Batched I16 luma mode trial. cur (L,16,16); top/left (L,16);
    corner (L,); avt/avl (L,) bool. Returns per lane the chosen (mode
    (L,), z_dc (L,16) zigzag, z_ac (L,16,16) coding order + zigzag, recon
    (L,16,16), cost (L,))."""
    n = cur.shape[0]
    pred_v = top[:, None, :].expand(n, 16, 16)
    pred_h = left[:, :, None].expand(n, 16, 16)
    st = top.sum(1, dtype=torch.int32)
    sl = left.sum(1, dtype=torch.int32)
    dc = _dc_or(avt, avl, (st + sl + 16) >> 5, (st + 8) >> 4, (sl + 8) >> 4)
    pred_dc = dc[:, None, None].expand(n, 16, 16)
    text = torch.cat([corner[:, None], top], 1)
    lext = torch.cat([corner[:, None], left], 1)
    pred_pl = _plane_pred(text, lext, 16)
    preds = torch.stack([pred_v, pred_h, pred_dc, pred_pl])   # (4,L,16,16)
    allowed = torch.stack([avt, avl, torch.ones_like(avt), avt & avl])

    res = cur[None] - preds
    blocks = res.reshape(4, n, 4, 4, 4, 4).movedim(3, 4)
    coef = tf.fdct4(blocks)                                # (4,L,4,4,4,4)
    dc_mb = coef[..., 0, 0]                                # (4,L,4,4)
    z_dc = tf.quant_dc4(tf.hadamard4(dc_mb) >> 1, qp)
    z_ac = tf.quant4(coef, qp, intra=True)
    w_rec = tf.dequant4(z_ac, qp)
    w_rec[..., 0, 0] = tf.dequant_dc4(z_dc, qp)
    res_rec = tf.idct4(w_rec).movedim(4, 3).reshape(4, n, 16, 16)
    recon = torch.clamp(preds + res_rec, 0, 255)

    ssd = rdcost.ssd(cur[None], recon, (2, 3))
    ac_lv = z_ac.clone()
    ac_lv[..., 0, 0] = 0
    bits = _bits_proxy(ac_lv) + _bits_proxy(z_dc)
    cost = torch.where(allowed, ssd + lam2 * bits, torch.inf)
    mode = rdcost.first_argmin(cost, 0)                    # (L,)

    lane = torch.arange(n, device=cur.device)
    z_dc_b = z_dc[mode, lane]                              # (L,4,4)
    z_ac_b = z_ac[mode, lane]                              # (L,4,4,4,4)
    return (mode.to(torch.int32), _zigzag(z_dc_b),
            _zigzag(_blk_order(z_ac_b)), recon[mode, lane],
            cost[mode, lane])


def _i8_filter_refs(t, le, m, avt, avl, avtl):
    """Spec 8.3.2.2.1 reference filtering, batched over lanes. t (L,16)
    top incl. top-right (the caller already substituted t[7] for an
    unavailable top-right), le (L,8), m (L,). All int32."""
    mf = torch.where(avt & avl & avtl,
                     (t[:, 0] + 2 * m + le[:, 0] + 2) >> 2, m)
    t0 = torch.where(avtl & avl,
                     (m + 2 * t[:, 0] + t[:, 1] + 2) >> 2,
                     (3 * t[:, 0] + t[:, 1] + 2) >> 2)
    tmid = (t[:, :-2] + 2 * t[:, 1:-1] + t[:, 2:] + 2) >> 2   # x=1..14
    t15 = (t[:, 14] + 3 * t[:, 15] + 2) >> 2
    ft = torch.cat([t0[:, None], tmid, t15[:, None]], dim=1)
    ft = torch.where(avt[:, None], ft, t)
    l0 = torch.where(avtl & avt,
                     (m + 2 * le[:, 0] + le[:, 1] + 2) >> 2,
                     (3 * le[:, 0] + le[:, 1] + 2) >> 2)
    lmid = (le[:, :-2] + 2 * le[:, 1:-1] + le[:, 2:] + 2) >> 2  # y=1..6
    l7 = (le[:, 6] + 3 * le[:, 7] + 2) >> 2
    fle = torch.cat([l0[:, None], lmid, l7[:, None]], dim=1)
    fle = torch.where(avl[:, None], fle, le)
    return ft, fle, torch.where(avtl, mf, m)


def _i8_block_trial(cur8, t_raw, le_raw, m_raw, avt, avl, avtl, avtr,
                    qp: int, lam2: float, pred_mode):
    """One 8x8 intra block, all 9 modes batched over lanes.

    cur8 (L,8,8); t_raw (L,16) top incl. top-right; le_raw (L,8); m_raw
    (L,); av* (L,) bool; pred_mode (L,) the spec-predicted mode for the
    1-bin prev flag. Returns (mode (L,), z64 (L,64) zigzag, recon
    (L,8,8), cost (L,))."""
    n = cur8.shape[0]
    dev = cur8.device
    # unavailable top-right -> replicate t[7] (spec substitution)
    t_raw = torch.cat(
        [t_raw[:, :8],
         torch.where(avtr[:, None], t_raw[:, 8:], t_raw[:, 7:8])], dim=1)
    t, le, m = _i8_filter_refs(t_raw, le_raw, m_raw, avt, avl, avtl)
    pred_v = t[:, None, :8].expand(n, 8, 8)
    pred_h = le[:, :, None].expand(n, 8, 8)
    st = t[:, :8].sum(1, dtype=torch.int32)
    sl = le.sum(1, dtype=torch.int32)
    dc = _dc_or(avt, avl, (st + sl + 8) >> 4, (st + 4) >> 3, (sl + 4) >> 3)
    pred_dc = dc[:, None, None].expand(n, 8, 8)
    # directional modes via the gather tables over
    # r = [left(8) | corner | top(16)]
    r = torch.cat([le, m[:, None], t], dim=1)              # (L, 25)
    tabs = constant("i8_tabs", I8_TABS.reshape(6, 3, 64), dev)
    pred_dir = (r[:, tabs[:, 0]] + 2 * r[:, tabs[:, 2]] + r[:, tabs[:, 1]]
                + 2).reshape(n, 6, 8, 8) >> 2
    preds = torch.cat(
        [torch.stack([pred_v, pred_h, pred_dc], dim=1), pred_dir],
        dim=1)                                             # (L,9,8,8)
    need_t = constant("i8_need_t", _I8_NEED_T, dev, torch.bool)
    need_l = constant("i8_need_l", _I8_NEED_L, dev, torch.bool)
    allowed = ((avt[:, None] | ~need_t[None, :])
               & (avl[:, None] | ~need_l[None, :]))        # (L,9)

    res = cur8[:, None] - preds                            # (L,9,8,8)
    z = t8ops.quant8(t8ops.fdct8(res), qp, intra=True)
    rec = torch.clamp(preds + t8ops.idct8(t8ops.dequant8(z, qp)), 0, 255)
    ssd = rdcost.ssd(cur8[:, None], rec, (2, 3))
    lbits = _bits_proxy(z.reshape(n, 9, 64))
    # prev_intra8x8_pred_mode: 1 bin if predicted, else 1 + 3 bins
    mbits = torch.where(
        torch.arange(9, device=dev)[None, :] == pred_mode[:, None],
        1.0, 4.0)
    cost = torch.where(allowed, ssd + lam2 * (lbits + mbits), torch.inf)
    mode = rdcost.first_argmin(cost, 1)
    lane = torch.arange(n, device=dev)
    return (mode.to(torch.int32), t8ops.zigzag8(z[lane, mode]),
            rec[lane, mode], cost[lane, mode])


def _chroma_dc_pred(top, left, avt, avl):
    """Chroma DC prediction, per-4x4-sub-block neighbor rules (spec
    8.3.4.2). top/left (L,8). Returns (L,8,8)."""
    st0 = top[:, :4].sum(1, dtype=torch.int32)
    st1 = top[:, 4:].sum(1, dtype=torch.int32)
    sl0 = left[:, :4].sum(1, dtype=torch.int32)
    sl1 = left[:, 4:].sum(1, dtype=torch.int32)

    def one_side(first_ok, first, second_ok, second):
        return torch.where(first_ok, (first + 2) >> 2,
                           torch.where(second_ok, (second + 2) >> 2, 128))

    dc00 = _dc_or(avt, avl, (st0 + sl0 + 4) >> 3, (st0 + 2) >> 2,
                  (sl0 + 2) >> 2)
    # corner blocks prefer one side: (0,1) top (fallback left), (1,0)
    # left (fallback top)
    dc01 = one_side(avt, st1, avl, sl0)
    dc10 = one_side(avl, sl1, avt, st0)
    dc11 = _dc_or(avt, avl, (st1 + sl1 + 4) >> 3, (st1 + 2) >> 2,
                  (sl1 + 2) >> 2)
    q = torch.stack([torch.stack([dc00, dc01], -1),
                     torch.stack([dc10, dc11], -1)], -2)   # (L,2,2)
    return q.repeat_interleave(4, -2).repeat_interleave(4, -1)


def _chroma_mode_trials(cur, top, left, corner, avt, avl, qpc: int):
    """Candidate chroma predictions + residual trial for one plane.
    Returns (z_dc (4,L,2,2), z_ac (4,L,2,2,4,4), recon (4,L,8,8), ssd
    (4,L), bits (4,L))."""
    n = cur.shape[0]
    pred_dc = _chroma_dc_pred(top, left, avt, avl)
    pred_h = left[:, :, None].expand(n, 8, 8)
    pred_v = top[:, None, :].expand(n, 8, 8)
    text = torch.cat([corner[:, None], top], 1)
    lext = torch.cat([corner[:, None], left], 1)
    pred_pl = _plane_pred(text, lext, 8)
    preds = torch.stack([pred_dc, pred_h, pred_v, pred_pl])   # (4,L,8,8)

    res = cur[None] - preds
    blocks = res.reshape(4, n, 2, 4, 2, 4).movedim(3, 4)
    coef = tf.fdct4(blocks)                                # (4,L,2,2,4,4)
    dc_mb = coef[..., 0, 0]                                # (4,L,2,2)
    z_dc = tf.quant_dc2(tf.hadamard2(dc_mb), qpc, intra=True)
    z_ac = tf.quant4(coef, qpc, intra=True)
    w_rec = tf.dequant4(z_ac, qpc)
    w_rec[..., 0, 0] = tf.dequant_dc2(z_dc, qpc)
    res_rec = tf.idct4(w_rec).movedim(4, 3).reshape(4, n, 8, 8)
    recon = torch.clamp(preds + res_rec, 0, 255)
    ssd = rdcost.ssd(cur[None], recon, (2, 3))
    ac_lv = z_ac.clone()
    ac_lv[..., 0, 0] = 0
    bits = _bits_proxy(ac_lv) + _bits_proxy(z_dc)
    return z_dc, z_ac, recon, ssd, bits


def _gather_edges(plane, y0, x0, ar):
    """Top row, left column and corner of the blocks at (y0, x0) in a
    plane with a 1-sample top/left border; ``ar`` = arange(block size)."""
    top = plane[(y0 - 1)[:, None], x0[:, None] + ar[None, :]]
    left = plane[y0[:, None] + ar[None, :], (x0 - 1)[:, None]]
    return top, left, plane[y0 - 1, x0 - 1]


def _scatter(plane, y0, x0, blk, ar) -> None:
    """Write the (L, n, n) blocks at (y0, x0) into ``plane`` in place."""
    plane[y0[:, None, None] + ar[None, :, None],
          x0[:, None, None] + ar[None, None, :]] = blk


def _i8_trial(py, mg, cur, y0, x0, mbyc, mbxc, valid, n_mbx: int, h: int,
              qp: int, lam2: float):
    """I_NxN trial of one diagonal's MBs: the four 8x8 blocks in raster
    order, each predicting from ``py`` as the previous block left it
    (each block's winner is written into ``py`` in place; invalid lanes
    write into the sink rows below the frame). ``mg`` is the 8x8-granular
    grid of published i8 modes (-1 = none) for the mode prediction.
    Returns (modes (L, 4) int32, scans (L, 4, 64), recon (L, 16, 16),
    summed block cost (L,))."""
    dev = py.device
    a16 = torch.arange(16, device=dev)
    a8 = torch.arange(8, device=dev)
    b_modes, b_z, b_rec, b_cost = [], [], [], []
    for b8 in range(4):
        oy, ox = 8 * (b8 // 2), 8 * (b8 % 2)
        r0 = y0 + oy
        c0 = x0 + ox
        avt_b = (r0 > 1) & valid
        avl_b = (c0 > 1) & valid
        if b8 == 1:
            avtr_b = avt_b & (mbxc < n_mbx - 1)
        elif b8 == 3:
            avtr_b = torch.zeros_like(avt_b)
        else:
            avtr_b = avt_b
        t_raw = py[(r0 - 1)[:, None], c0[:, None] + a16[None, :]]
        le_raw = py[r0[:, None] + a8[None, :], (c0 - 1)[:, None]]
        m_raw = py[r0 - 1, c0 - 1]
        # prev-mode prediction (spec 8.3.1.1 min rule, -1 -> DC)
        gy = 2 * mbyc + b8 // 2
        gx = 2 * mbxc + b8 % 2
        if b8 in (0, 2):
            a_m = torch.where(gx > 0, mg[gy, (gx - 1).clamp_min(0)], -1)
        else:
            a_m = b_modes[b8 - 1]
        if b8 in (0, 1):
            b_m = torch.where(gy > 0, mg[(gy - 1).clamp_min(0), gx], -1)
        else:
            b_m = b_modes[b8 - 2]
        pred_m = torch.minimum(torch.where(a_m >= 0, a_m, 2),
                               torch.where(b_m >= 0, b_m, 2))
        bm, z64, rec8, bc = _i8_block_trial(
            cur[:, oy:oy + 8, ox:ox + 8], t_raw, le_raw, m_raw, avt_b,
            avl_b, avt_b & avl_b, avtr_b, qp, lam2, pred_m)
        _scatter(py, torch.where(valid, r0, h + 1), c0, rec8, a8)
        b_modes.append(bm)
        b_z.append(z64)
        b_rec.append(rec8)
        b_cost.append(bc)
    rec = torch.cat([torch.cat([b_rec[0], b_rec[1]], dim=2),
                     torch.cat([b_rec[2], b_rec[3]], dim=2)], dim=1)
    return (torch.stack(b_modes, dim=1), torch.stack(b_z, dim=1), rec,
            b_cost[0] + b_cost[1] + b_cost[2] + b_cost[3])


def _publish_modes(mg, valid, mbyc, mbxc, vals, n_mby: int) -> None:
    """Write each lane's four 8x8 mode values (L, 4) into ``mg`` in place
    (invalid lanes into the two sink rows)."""
    dy = constant("mg_dy", [0, 0, 1, 1], mg.device)
    dx = constant("mg_dx", [0, 1, 0, 1], mg.device)
    gy0 = torch.where(valid, 2 * mbyc, 2 * n_mby)
    mg[gy0[:, None] + dy[None, :], (2 * mbxc)[:, None] + dx[None, :]] = vals


def _chroma_trial(pu, pv, umb, vmb, mbyc, mbxc, avt, avl, qpc: int,
                  lam2c: float):
    """Joint Cb / Cr intra mode trial of one diagonal's MBs (one mode for
    both planes). Returns (mode (L,) int32, its cost (L,), levels (cb_dc
    (L, 4), cb_ac (L, 64), cr_dc, cr_ac) zig-zagged, recon_u, recon_v
    (L, 8, 8), block origins (c0, cx0) in the bordered planes)."""
    dev = pu.device
    a8 = torch.arange(8, device=dev)
    c0 = mbyc * 8 + 1
    cx0 = mbxc * 8 + 1
    topu, leftu, cornu = _gather_edges(pu, c0, cx0, a8)
    topv, leftv, cornv = _gather_edges(pv, c0, cx0, a8)
    udc, uac, urec, ussd, ubits = _chroma_mode_trials(
        umb[mbyc, mbxc], topu, leftu, cornu, avt, avl, qpc)
    vdc, vac, vrec, vssd, vbits = _chroma_mode_trials(
        vmb[mbyc, mbxc], topv, leftv, cornv, avt, avl, qpc)
    ue_bits = constant("chroma_ue_bits", _CHROMA_UE_BITS, dev, torch.float32)
    callowed = torch.stack([torch.ones_like(avt), avl, avt, avt & avl])
    ccost = torch.where(
        callowed, ussd + vssd + lam2c * (ubits + vbits + ue_bits[:, None]),
        torch.inf)
    cmode = rdcost.first_argmin(ccost, 0)
    lane = torch.arange(cmode.shape[0], device=dev)
    n = lane.shape[0]
    levels = (udc[cmode, lane].reshape(n, 4),
              _zigzag(uac[cmode, lane].reshape(n, 4, 4, 4)).reshape(n, 64),
              vdc[cmode, lane].reshape(n, 4),
              _zigzag(vac[cmode, lane].reshape(n, 4, 4, 4)).reshape(n, 64))
    return (cmode.to(torch.int32), ccost[cmode, lane], levels,
            urec[cmode, lane], vrec[cmode, lane], (c0, cx0))


class _Wavefront:
    """The schedule of an n_mby x n_mbx frame on ``dev`` by the maps of
    ``maps`` (``diagonal_maps`` or ``diagonal_maps2``): per step d the
    lanes' MB coordinates (clamped to 0 on invalid lanes), validity and
    availability of the top / left neighbours, plus the inverse map that
    puts per-step outputs back in raster order."""

    def __init__(self, n_mby: int, n_mbx: int, dev, maps=diagonal_maps2):
        MBY, MBX, VALID, DMAP, KMAP = maps(n_mby, n_mbx)
        # the whole schedule goes up in a few copies
        self.mby = torch.from_numpy(MBY).to(dev).long()
        self.mbx = torch.from_numpy(MBX).to(dev).long()
        self.valid = torch.from_numpy(VALID).to(dev)
        self.dm = torch.from_numpy(DMAP).to(dev).long()
        self.km = torch.from_numpy(KMAP).to(dev).long()
        self.steps = MBY.shape[0]

    def lanes(self, d: int):
        """(valid, mbyc, mbxc, avt, avl) of step d."""
        valid = self.valid[d]
        return (valid, torch.where(valid, self.mby[d], 0),
                torch.where(valid, self.mbx[d], 0),
                (self.mby[d] > 0) & valid, (self.mbx[d] > 0) & valid)

    def raster(self, outs):
        """Per-step output tuples -> raster-order tensors, one per column."""
        return tuple(torch.stack(col)[self.dm, self.km] for col in zip(*outs))


def _mb_planes(y, u, v):
    n_mby, n_mbx = y.shape[0] // 16, y.shape[1] // 16
    return (y.reshape(n_mby, 16, n_mbx, 16).movedim(1, 2),
            u.reshape(n_mby, 8, n_mbx, 8).movedim(1, 2),
            v.reshape(n_mby, 8, n_mbx, 8).movedim(1, 2))


def _bordered_planes(h: int, w: int, dev):
    """Zeroed recon planes with a 1-sample top / left border, 16 extra
    right columns for block 1's raw top-right gather at the last MB
    column (masked by avtr), and sink rows below the frame for the
    scatters of invalid lanes; the 8x8 mode grid with two sink rows."""
    py = torch.zeros((h + 17, w + 17), dtype=torch.int32, device=dev)
    pu = torch.zeros((h // 2 + 9, w // 2 + 1), dtype=torch.int32, device=dev)
    mg = torch.full((2 * (h // 16) + 2, 2 * (w // 16)), -1,
                    dtype=torch.int32, device=dev)
    return py, pu, torch.zeros_like(pu), mg


def _deblock_intra(recon_y, recon_u, recon_v, qp: int, t8=None):
    """The in-loop filter of an all-intra frame at one QP."""
    from ...ops import deblock as dbf
    dev = recon_y.device
    h, w = recon_y.shape
    n_mby, n_mbx = h // 16, w // 16
    qp_mb = torch.full((n_mby, n_mbx), qp, dtype=torch.int32, device=dev)
    intra = torch.ones((n_mby, n_mbx), dtype=torch.bool, device=dev)
    nz = torch.zeros((h // 4, w // 4), dtype=torch.bool, device=dev)
    mvq = torch.zeros((n_mby, n_mbx, 2), dtype=torch.int32, device=dev)
    return dbf.deblock_frame(recon_y, recon_u, recon_v, qp_mb, intra, nz,
                             mvq, t8=t8)


def _recon_planes(py, pu, pv):
    """The frame inside the bordered planes."""
    h, w = py.shape[0] - 17, py.shape[1] - 17
    return (py[1:h + 1, 1:w + 1].contiguous(),
            pu[1:h // 2 + 1, 1:w // 2 + 1].contiguous(),
            pv[1:h // 2 + 1, 1:w // 2 + 1].contiguous())


def encode_iframe_rd(y, u, v, qp: int, qpc: int, deblock: bool = False):
    """Intra frame of I_16x16 MBs, each with its RD-chosen luma mode and
    chroma mode, over the anti-diagonal wavefront.

    y: (H, W) (multiples of 16, pre-padded); u, v: (H/2, W/2); any
    integer dtype. Returns the level arrays of ``frame_ops.encode_iframe``
    plus "modes" / "cmodes" (n_mby, n_mbx) int32, and the uint8 recon
    planes."""
    y, u, v = (a.to(torch.int32) for a in (y, u, v))
    dev = y.device
    h, w = y.shape
    n_mby, n_mbx = h // 16, w // 16
    wf = _Wavefront(n_mby, n_mbx, dev, maps=diagonal_maps)
    lam2 = rdcost.lam2_for_qp(qp)
    lam2c = rdcost.lam2_for_qp(qpc)
    ymb, umb, vmb = _mb_planes(y, u, v)
    py, pu, pv, _ = _bordered_planes(h, w, dev)
    a16 = torch.arange(16, device=dev)
    a8 = torch.arange(8, device=dev)

    outs = []
    for d in range(wf.steps):
        valid, mbyc, mbxc, avt, avl = wf.lanes(d)
        y0 = mbyc * 16 + 1
        x0 = mbxc * 16 + 1
        top, left, corner = _gather_edges(py, y0, x0, a16)
        mode, z_dc, z_ac, recon, _ = _luma_modes(
            ymb[mbyc, mbxc], top, left, corner, avt, avl, qp, lam2)
        _scatter(py, torch.where(valid, y0, h + 1), x0, recon, a16)
        cmode, _, clevels, urec, vrec, (c0, cx0) = _chroma_trial(
            pu, pv, umb, vmb, mbyc, mbxc, avt, avl, qpc, lam2c)
        c0s = torch.where(valid, c0, h // 2 + 1)
        _scatter(pu, c0s, cx0, urec, a8)
        _scatter(pv, c0s, cx0, vrec, a8)
        outs.append((mode, z_dc, z_ac, cmode, *clevels))

    modes, luma_dc, luma_ac, cmodes, cb_dc, cb_ac, cr_dc, cr_ac = \
        wf.raster(outs)
    recon = _recon_planes(py, pu, pv)
    if deblock:
        recon = _deblock_intra(*recon, qp)
    return {
        "luma_dc": luma_dc, "luma_ac": luma_ac,
        "cb_dc": cb_dc, "cb_ac": cb_ac.reshape(n_mby, n_mbx, 4, 16),
        "cr_dc": cr_dc, "cr_ac": cr_ac.reshape(n_mby, n_mbx, 4, 16),
        "modes": modes, "cmodes": cmodes,
        "recon_y": recon[0].to(torch.uint8),
        "recon_u": recon[1].to(torch.uint8),
        "recon_v": recon[2].to(torch.uint8),
    }


def encode_iframe_rd8(y, u, v, qp: int, qpc: int, deblock: bool = False):
    """Intra frame with a per-MB RD choice between I_16x16 (4 modes) and
    I_NxN with the 8x8 transform (four 8x8 blocks, 9 modes each).

    y: (H, W) (multiples of 16, pre-padded); u, v: (H/2, W/2); any
    integer dtype. Returns the level arrays of ``frame_ops.encode_iframe``
    plus "modes" / "cmodes" (n_mby, n_mbx) int32, "i8" (n_mby, n_mbx)
    bool, "i8_modes" (n_mby, n_mbx, 4) and "i8_luma" (n_mby, n_mbx, 4,
    64) zigzag scans (the High-profile CABAC entropy inputs), and the
    uint8 recon planes."""
    y, u, v = (a.to(torch.int32) for a in (y, u, v))
    dev = y.device
    h, w = y.shape
    n_mby, n_mbx = h // 16, w // 16
    wf = _Wavefront(n_mby, n_mbx, dev)
    lam2 = rdcost.lam2_for_qp(qp)
    lam2c = rdcost.lam2_for_qp(qpc)
    ymb, umb, vmb = _mb_planes(y, u, v)
    py, pu, pv, mg = _bordered_planes(h, w, dev)
    a16 = torch.arange(16, device=dev)
    a8 = torch.arange(8, device=dev)

    outs = []
    for d in range(wf.steps):
        valid, mbyc, mbxc, avt, avl = wf.lanes(d)
        y0 = mbyc * 16 + 1
        x0 = mbxc * 16 + 1
        cur = ymb[mbyc, mbxc]

        top, left, corner = _gather_edges(py, y0, x0, a16)
        mode16, z_dc, z_ac, recon16, cost16 = _luma_modes(
            cur, top, left, corner, avt, avl, qp, lam2)
        gmodes, b_z, rec_i8, cost8 = _i8_trial(
            py, mg, cur, y0, x0, mbyc, mbxc, valid, n_mbx, h, qp, lam2)
        use_i8 = cost8 + lam2 * I8_OVERHEAD_BITS \
            < cost16 + lam2 * I16_OVERHEAD_BITS
        recon = torch.where(use_i8[:, None, None], rec_i8, recon16)
        _scatter(py, torch.where(valid, y0, h + 1), x0, recon, a16)
        # i8 winners publish their modes, everything else stays -1 (DC to
        # its neighbors)
        _publish_modes(mg, valid, mbyc, mbxc,
                       torch.where(use_i8[:, None], gmodes, -1), n_mby)

        cmode, _, clevels, urec, vrec, (c0, cx0) = _chroma_trial(
            pu, pv, umb, vmb, mbyc, mbxc, avt, avl, qpc, lam2c)
        c0s = torch.where(valid, c0, h // 2 + 1)
        _scatter(pu, c0s, cx0, urec, a8)
        _scatter(pv, c0s, cx0, vrec, a8)

        # zero the losing representation's level arrays
        outs.append((mode16, z_dc * ~use_i8[:, None],
                     z_ac * ~use_i8[:, None, None], cmode, *clevels, use_i8,
                     gmodes, b_z * use_i8[:, None, None]))

    (modes, luma_dc, luma_ac, cmodes, cb_dc, cb_ac, cr_dc, cr_ac, i8_grid,
     i8_modes, i8_luma) = wf.raster(outs)
    cb_ac = cb_ac.reshape(n_mby, n_mbx, 4, 16)
    cr_ac = cr_ac.reshape(n_mby, n_mbx, 4, 16)

    recon = _recon_planes(py, pu, pv)
    if deblock:
        recon = _deblock_intra(*recon, qp, t8=i8_grid)
    return {
        "luma_dc": luma_dc, "luma_ac": luma_ac,
        "cb_dc": cb_dc, "cb_ac": cb_ac, "cr_dc": cr_dc, "cr_ac": cr_ac,
        "modes": modes, "cmodes": cmodes,
        "i8": i8_grid, "i8_modes": i8_modes, "i8_luma": i8_luma,
        "recon_y": recon[0].to(torch.uint8),
        "recon_u": recon[1].to(torch.uint8),
        "recon_v": recon[2].to(torch.uint8),
    }


def intra_overlay_pass(cur_y, cur_u, cur_v, ry, ru, rv, inter_cost,
                       qp: int, qpc: int) -> dict:
    """Intra MBs inside a P picture: the slope-2 wavefront of
    ``encode_iframe_rd8`` run over planes that start as the inter pass's
    pre-deblock recon (``ry``, ``ru``, ``rv``), replacing each MB where
    I16 or I_NxN / i8 (with its chroma mode trial) costs less than the
    inter MB's ``inter_cost`` (nMBy, nMBx) in the same SSD + lambda2 *
    bits currency. Later MBs predict from the final recon, so the levels
    reproduce exactly in any spec decoder.

    Returns "intra" / "i8" (nMBy, nMBx) bool, "modes" (I16) / "cmodes",
    "luma_dc" (nMBy, nMBx, 16), "luma_mux" (nMBy, nMBx, 256: an intra
    MB's I16 AC blocks or four i8 scans, zeros elsewhere), "i8_modes"
    (nMBy, nMBx, 4; -1 off i8 MBs), the chroma levels of the intra MBs
    "cb_dc" / "cb_ac" / "cr_dc" / "cr_ac" (zeros elsewhere), and the int32
    recon planes (pre-deblock)."""
    dev = cur_y.device
    h, w = cur_y.shape
    n_mby, n_mbx = h // 16, w // 16
    wf = _Wavefront(n_mby, n_mbx, dev)
    lam2 = rdcost.lam2_for_qp(qp)
    lam2c = rdcost.lam2_for_qp(qpc)
    ymb, umb, vmb = _mb_planes(cur_y, cur_u, cur_v)
    py, pu, pv, mg = _bordered_planes(h, w, dev)
    py[1:h + 1, 1:w + 1] = ry
    pu[1:h // 2 + 1, 1:w // 2 + 1] = ru
    pv[1:h // 2 + 1, 1:w // 2 + 1] = rv
    a16 = torch.arange(16, device=dev)
    a8 = torch.arange(8, device=dev)
    ic_s = inter_cost[wf.mby, wf.mbx]                       # (D, L)

    outs = []
    for d in range(wf.steps):
        valid, mbyc, mbxc, avt, avl = wf.lanes(d)
        y0 = mbyc * 16 + 1
        x0 = mbxc * 16 + 1
        cur = ymb[mbyc, mbxc]

        top, left, corner = _gather_edges(py, y0, x0, a16)
        mode16, z_dc, z_ac, recon16, cost16 = _luma_modes(
            cur, top, left, corner, avt, avl, qp, lam2)
        save16 = py[y0[:, None, None] + a16[None, :, None],
                    x0[:, None, None] + a16[None, None, :]]
        gmodes, b_z, rec_i8, cost8 = _i8_trial(
            py, mg, cur, y0, x0, mbyc, mbxc, valid, n_mbx, h, qp, lam2)
        cmode, ccost, clevels, urec, vrec, (c0, cx0) = _chroma_trial(
            pu, pv, umb, vmb, mbyc, mbxc, avt, avl, qpc, lam2c)

        # MB decision: inter vs I16 vs i8 (the chroma cost is shared)
        cost_i8 = cost8 + lam2 * I8_OVERHEAD_BITS
        cost_i16 = cost16 + lam2 * I16_OVERHEAD_BITS
        intra_cost = torch.minimum(cost_i8, cost_i16) + ccost \
            + lam2 * P_INTRA_EXTRA_BITS
        use_intra = valid & (intra_cost < ic_s[d])
        use_i8 = use_intra & (cost_i8 < cost_i16)
        use_16 = use_intra & ~use_i8

        rec_mb = torch.where(use_i8[:, None, None], rec_i8, recon16)
        # MBs that stay inter restore the recon the i8 blocks overwrote
        final = torch.where(use_intra[:, None, None], rec_mb, save16)
        _scatter(py, torch.where(valid, y0, h + 1), x0, final, a16)
        c0s = torch.where(use_intra, c0, h // 2 + 1)
        _scatter(pu, c0s, cx0, urec, a8)
        _scatter(pv, c0s, cx0, vrec, a8)
        gvals = torch.where(use_i8[:, None], gmodes, -1)
        _publish_modes(mg, valid, mbyc, mbxc, gvals, n_mby)

        n = valid.shape[0]
        luma_mux = (z_ac * use_16[:, None, None]).reshape(n, 256) \
            + (b_z * use_i8[:, None, None]).reshape(n, 256)
        outs.append((use_intra, use_i8, mode16, cmode,
                     z_dc * use_16[:, None], luma_mux, gvals,
                     *(lv * use_intra[:, None] for lv in clevels)))

    (intra, i8, modes, cmodes, luma_dc, luma_mux, i8_modes, cb_dc, cb_ac,
     cr_dc, cr_ac) = wf.raster(outs)
    return {
        "intra": intra, "i8": i8, "modes": modes, "cmodes": cmodes,
        "luma_dc": luma_dc, "luma_mux": luma_mux, "i8_modes": i8_modes,
        "cb_dc": cb_dc, "cb_ac": cb_ac.reshape(n_mby, n_mbx, 4, 16),
        "cr_dc": cr_dc, "cr_ac": cr_ac.reshape(n_mby, n_mbx, 4, 16),
        **dict(zip(("recon_y", "recon_u", "recon_v"),
                   _recon_planes(py, pu, pv))),
    }
