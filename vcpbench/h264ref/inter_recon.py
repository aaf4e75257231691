"""Whole-picture inter reconstruction in NumPy; copy of the NumPy body of
``vcp_tpu/codec/h264/inter_recon.py``.

The twin of ``native_recon.recon_inter_native`` (``native/h264recon.cpp``),
which the decoder runs under ``VCP_NO_NATIVE=1``. It reconstructs every
inter MB of a picture from the decoder's 8x8-grid state: per-list
motion (``mv8_l0/1``) and reference indices (``ref8_l0/1``),
multi-picture reference lists, explicit (P) and implicit (B) weighted
prediction, and a QP per MB. The inverse transforms are the port's own
(``ops.transform``, ``ops.transform8``).
"""

from __future__ import annotations

import numpy as np

from . import xform as tf
from . import xform as t8ops
from .consts import _QPEL_TABLE
from .pframe_dec import _BLK_GRID
from .consts import ZIGZAG_4x4

_ZZ = np.asarray(ZIGZAG_4x4)


def _tap6_x_np(a):
    a = a.astype(np.int64)
    return (a[:, 0:-5] - 5 * a[:, 1:-4] + 20 * a[:, 2:-3]
            + 20 * a[:, 3:-2] - 5 * a[:, 4:-1] + a[:, 5:])


def _tap6_y_np(a):
    a = a.astype(np.int64)
    return (a[0:-5, :] - 5 * a[1:-4, :] + 20 * a[2:-3, :]
            + 20 * a[3:-2, :] - 5 * a[4:-1, :] + a[5:, :])


def _mc_luma_np(ref_y, y0, x0, mvq_y, mvq_x, ns: int = 16):
    """Quarter-pel luma MC of one ``ns`` x ``ns`` block (spec 8.4.2.2.1),
    the NumPy mirror of ``ops.motion.half_planes`` / ``mc_luma_q``.
    Coordinates clamp to the picture."""
    h, w = ref_y.shape
    iy, ix = mvq_y >> 2, mvq_x >> 2
    fy, fx = mvq_y & 3, mvq_x & 3
    if fy == 0 and fx == 0:
        ys = np.clip(np.arange(y0 + iy, y0 + iy + ns), 0, h - 1)
        xs = np.clip(np.arange(x0 + ix, x0 + ix + ns), 0, w - 1)
        return ref_y[np.ix_(ys, xs)].astype(np.int64)
    # a clamped (ns + 12)^2 region: the block, the one-sample case
    # offsets and the filter margins (origin at base - 6; the planes
    # align at region + 3)
    ys = np.clip(np.arange(y0 + iy - 6, y0 + iy + ns + 6), 0, h - 1)
    xs = np.clip(np.arange(x0 + ix - 6, x0 + ix + ns + 6), 0, w - 1)
    a = ref_y[np.ix_(ys, xs)].astype(np.int64)
    b1 = _tap6_x_np(a)
    h1 = _tap6_y_np(a)
    j1 = _tap6_y_np(b1)
    g = a[3:-3, 3:-3]
    b = np.clip((b1 + 16) >> 5, 0, 255)[3:-3, 1:]
    hh = np.clip((h1 + 16) >> 5, 0, 255)[1:, 3:-3]
    j = np.clip((j1 + 512) >> 10, 0, 255)[1:, 1:]
    planes = (g, b, hh, j)
    p1i, o1y, o1x, p2i, o2y, o2x = _QPEL_TABLE[fy * 4 + fx]
    base = 3                     # plane coordinate of the block origin
    p1 = planes[p1i][base + o1y: base + o1y + ns,
                     base + o1x: base + o1x + ns]
    p2 = planes[p2i][base + o2y: base + o2y + ns,
                     base + o2x: base + o2x + ns]
    return (p1 + p2 + 1) >> 1


def _pred_luma_list(refs, mv8, ref8, h, w):
    """Luma prediction plane for one list: per-reference vectorized
    full-pel gather + per-8x8 quarter-pel fallback. Blocks with
    ref < 0 are left zero (masked out by the caller)."""
    mvx, mvy = mv8[..., 0], mv8[..., 1]
    dyf = np.repeat(np.repeat(mvy >> 2, 8, 0), 8, 1)
    dxf = np.repeat(np.repeat(mvx >> 2, 8, 0), 8, 1)
    rows = np.clip(np.arange(h)[:, None] + dyf, 0, h - 1)
    cols = np.clip(np.arange(w)[None, :] + dxf, 0, w - 1)
    pred = np.zeros((h, w), np.int32)
    for r in np.unique(ref8[ref8 >= 0]):
        ref_y = refs[r][0]
        m8 = ref8 == r
        mpx = np.repeat(np.repeat(m8, 8, 0), 8, 1)
        pred[mpx] = ref_y[rows, cols][mpx]
        for by, bx in np.argwhere(m8 & (((mvx | mvy) & 3) != 0)):
            pred[8 * by:8 * by + 8, 8 * bx:8 * bx + 8] = \
                _mc_luma_np(ref_y, 8 * by, 8 * bx,
                            int(mvy[by, bx]), int(mvx[by, bx]), ns=8)
    return pred


def _pred_chroma_list(refs, plane_idx, mv8, ref8, hc, wc):
    """Chroma prediction for one list: 1/8-pel bilinear, per-reference
    masked gather. The MV grid is per-8x8-luma block = 4x4 chroma px."""
    mvx, mvy = mv8[..., 0], mv8[..., 1]
    dy8 = np.repeat(np.repeat(mvy >> 3, 4, 0), 4, 1)
    dx8 = np.repeat(np.repeat(mvx >> 3, 4, 0), 4, 1)
    fy8 = np.repeat(np.repeat(mvy & 7, 4, 0), 4, 1)
    fx8 = np.repeat(np.repeat(mvx & 7, 4, 0), 4, 1)
    base_r = np.arange(hc)[:, None] + dy8
    base_c = np.arange(wc)[None, :] + dx8
    r0 = np.clip(base_r, 0, hc - 1)
    r1 = np.clip(base_r + 1, 0, hc - 1)
    c0 = np.clip(base_c, 0, wc - 1)
    c1 = np.clip(base_c + 1, 0, wc - 1)
    pred = np.zeros((hc, wc), np.int32)
    for r in np.unique(ref8[ref8 >= 0]):
        refc = refs[r][plane_idx]
        a = refc[r0, c0]
        b = refc[r0, c1]
        cc = refc[r1, c0]
        d = refc[r1, c1]
        pr = ((8 - fx8) * (8 - fy8) * a + fx8 * (8 - fy8) * b
              + (8 - fx8) * fy8 * cc + fx8 * fy8 * d + 32) >> 6
        mpx = np.repeat(np.repeat(ref8 == r, 4, 0), 4, 1)
        pred[mpx] = pr[mpx]
    return pred


def _apply_weight_single(pred, wts, ref8, rep, chroma_c=None):
    """Explicit single-list weighting (8.4.2.3.2) over a whole plane.
    ``wts`` a refpic.WeightTable; ``rep`` pixel repeat of the 8x8 grid
    (8 luma, 4 chroma); ``chroma_c`` 0/1 selects the Cb/Cr table."""
    if chroma_c is None:
        logwd = wts.luma_log2
        wl = np.asarray([w for w, _ in wts.luma], np.int32)
        ol = np.asarray([o for _, o in wts.luma], np.int32)
    else:
        logwd = wts.chroma_log2
        wl = np.asarray([w[chroma_c][0] for w in wts.chroma], np.int32)
        ol = np.asarray([w[chroma_c][1] for w in wts.chroma], np.int32)
    rsafe = np.clip(ref8, 0, None)
    wmap = np.repeat(np.repeat(wl[rsafe], rep, 0), rep, 1)
    omap = np.repeat(np.repeat(ol[rsafe], rep, 0), rep, 1)
    if logwd >= 1:
        out = ((pred * wmap + (1 << (logwd - 1))) >> logwd) + omap
    else:
        out = pred * wmap + omap
    return np.clip(out, 0, 255)


def _combine(pred0, pred1, use0, use1, rep, *, wt0=None, wt1=None,
             ref0=None, ref1=None, implicit=None, chroma_c=None):
    """Per-block L0/L1/Bi combine with the applicable weighting.

    ``implicit``: (W0, W1) int LUTs indexed [r0, r1] for implicit
    bipred, or None. Explicit tables weight single-list blocks too;
    implicit weighting only affects bipred blocks (8.4.2.3.1).
    """
    p0 = pred0
    p1 = pred1 if pred1 is not None else np.zeros_like(pred0)
    if wt0 is not None:
        p0w = _apply_weight_single(pred0, wt0, ref0, rep, chroma_c)
    else:
        p0w = pred0
    if wt1 is not None and pred1 is not None:
        p1w = _apply_weight_single(pred1, wt1, ref1, rep, chroma_c)
    else:
        p1w = p1
    u0 = np.repeat(np.repeat(use0, rep, 0), rep, 1)
    if use1 is None:
        return np.where(u0, p0w, 0)
    u1 = np.repeat(np.repeat(use1, rep, 0), rep, 1)
    bi = u0 & u1

    if wt0 is not None and wt1 is not None:
        # explicit bipred (8.4.2.3.2): combined rounding + mean offset
        logwd = (wt0.luma_log2 if chroma_c is None else wt0.chroma_log2)

        def pick(wt, ref, c):
            if c is None:
                wl = np.asarray([w for w, _ in wt.luma], np.int32)
                olc = np.asarray([o for _, o in wt.luma], np.int32)
            else:
                wl = np.asarray([w[c][0] for w in wt.chroma], np.int32)
                olc = np.asarray([w[c][1] for w in wt.chroma], np.int32)
            rs = np.clip(ref, 0, None)
            return (np.repeat(np.repeat(wl[rs], rep, 0), rep, 1),
                    np.repeat(np.repeat(olc[rs], rep, 0), rep, 1))
        w0m, o0m = pick(wt0, ref0, chroma_c)
        w1m, o1m = pick(wt1, ref1, chroma_c)
        bi_val = np.clip(((p0 * w0m + p1 * w1m + (1 << logwd))
                          >> (logwd + 1)) + ((o0m + o1m + 1) >> 1), 0, 255)
    elif implicit is not None:
        W0, W1 = implicit
        r0s = np.clip(ref0, 0, None)
        r1s = np.clip(ref1, 0, None)
        w0m = np.repeat(np.repeat(W0[r0s, r1s], rep, 0), rep, 1)
        w1m = np.repeat(np.repeat(W1[r0s, r1s], rep, 0), rep, 1)
        bi_val = np.clip((p0 * w0m + p1 * w1m + 32) >> 6, 0, 255)
    else:
        bi_val = (p0 + p1 + 1) >> 1

    out = np.where(bi, bi_val, np.where(u0, p0w, p1w))
    return out


def recon_inter_frame(ctx) -> None:
    """Reconstruct every inter MB of the current picture in place."""
    y, u, v = ctx["y"], ctx["u"], ctx["v"]
    pp = ctx["pp"]
    h, w = y.shape
    hc, wc = u.shape
    inter = ctx["mv_valid"]                     # per-MB inter-ness
    n_mby, n_mbx = inter.shape
    list0 = ctx["list0"]
    list1 = ctx.get("list1")
    mv0, ref0 = ctx["mv8_l0"], ctx["ref8_l0"]
    use0 = ref0 >= 0
    is_b = list1 is not None
    wt0, wt1 = ctx.get("wt0"), ctx.get("wt1")
    implicit = ctx.get("implicit_w")

    pred0 = _pred_luma_list(list0, mv0, ref0, h, w)
    if is_b:
        mv1, ref1 = ctx["mv8_l1"], ctx["ref8_l1"]
        use1 = ref1 >= 0
        pred1 = _pred_luma_list(list1, mv1, ref1, h, w)
    else:
        mv1 = ref1 = use1 = pred1 = None
    pred = _combine(pred0, pred1, use0, use1, 8, wt0=wt0, wt1=wt1,
                    ref0=ref0, ref1=ref1, implicit=implicit)

    # ---- luma residual at per-MB QP
    qp_mb = ctx["qp_mb"]
    z = ctx["p_z_luma"]                         # (nMBy, nMBx, 16, 16)
    wq_flat = np.zeros_like(z)
    wq_flat[..., _ZZ] = z
    res = tf.idct4_np(tf.dequant4_np_qpmap(
        wq_flat.reshape(n_mby, n_mbx, 16, 4, 4), qp_mb))
    res_plane = res[:, :, _BLK_GRID].transpose(0, 2, 4, 1, 3, 5) \
        .reshape(h, w)
    t8 = ctx.get("p_t8")
    if t8 is not None and t8.any():
        sel = np.nonzero(t8)
        scans = z[sel].reshape(-1, 4, 64)
        blocks = t8ops.unzigzag8_np(scans)
        deq = np.stack([t8ops.dequant8_np(blocks[i], int(qp_mb[sel][i]))
                        for i in range(len(blocks))]) \
            if len(blocks) else blocks
        r8 = t8ops.idct8_np(deq)
        r8 = r8.reshape(-1, 2, 2, 8, 8).transpose(0, 1, 3, 2, 4) \
            .reshape(-1, 16, 16)
        res_mb = res_plane.reshape(n_mby, 16, n_mbx, 16).swapaxes(1, 2)
        res_mb[sel] = r8
        res_plane = res_mb.swapaxes(1, 2).reshape(h, w)
    mask = np.repeat(np.repeat(inter, 16, 0), 16, 1)
    out_y = np.clip(pred + res_plane, 0, 255)
    y[mask] = out_y[mask]

    # ---- chroma
    qpc_mb = np.asarray(tf.CHROMA_QP_FULL)[
        np.clip(qp_mb + pp.chroma_qp_index_offset, 0, 51)]
    cmask = np.repeat(np.repeat(inter, 8, 0), 8, 1)
    for ci, plane in ((0, u), (1, v)):
        pc0 = _pred_chroma_list(list0, ci + 1, mv0, ref0, hc, wc)
        pc1 = _pred_chroma_list(list1, ci + 1, mv1, ref1, hc, wc) \
            if is_b else None
        predc = _combine(pc0, pc1, use0, use1, 4, wt0=wt0, wt1=wt1,
                         ref0=ref0, ref1=ref1, implicit=implicit,
                         chroma_c=ci)
        dc_rec = tf.dequant_dc2_np_qpmap(
            ctx["p_cdc"][:, :, ci].reshape(n_mby, n_mbx, 2, 2), qpc_mb)
        cac = ctx["p_cac"][:, :, ci]            # (nMBy, nMBx, 4, 16)
        wc_flat = np.zeros_like(cac)
        wc_flat[..., _ZZ] = cac
        wcq = tf.dequant4_np_qpmap(
            wc_flat.reshape(n_mby, n_mbx, 4, 4, 4), qpc_mb)
        wcq[..., 0, 0] = dc_rec.reshape(n_mby, n_mbx, 4)
        resc = tf.idct4_np(wcq)
        resc_plane = resc.reshape(n_mby, n_mbx, 2, 2, 4, 4) \
            .transpose(0, 2, 4, 1, 3, 5).reshape(hc, wc)
        outp = np.clip(predc + resc_plane, 0, 255)
        plane[cmask] = outp[cmask]
