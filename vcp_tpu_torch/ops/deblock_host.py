"""H.264 in-loop deblocking for the host decoder (spec 8.7).

Copy of ``deblock_frame_host`` / ``_deblock_host_native`` of
``vcp_tpu/ops/deblock.py``: the C++ direct-threshold filter
(``native/deblock.cpp``, ``vcp_deblock_frame_direct``) filters a decoded
picture in spec order, computing bS / alpha / beta / tc0 inline per edge
segment. This is host code: it launches no device kernel and is not a
port of the deblock kernels (``ops/deblock_cuda.py``), which filter the
encoder's recon on the card. The motion argument takes the decoder's two
forms: an (nMBy, nMBx, 2) or (2nMBy, 2nMBx, 2) quarter-pel grid (I
slices pass their all-zero grid), or the general 8x8-grid dict of
per-list vectors and reference-picture ids ``{"mv0", "id0"[, "mv1",
"id1"]}`` (bS 1 on differing reference pictures, 8.7.2.1).

Under ``VCP_NO_NATIVE=1`` (read on every call, as in ``vcp_tpu``) the
same filter runs in NumPy: the edge prep of ``vcp_tpu``'s
``deblock_frame_host`` (bS, averaged QP and alpha / beta / tc0 per edge
sample) and its NumPy wavefront (``_wavefront_luma_np``,
``_wavefront_chroma_np``), which walks the MB diagonals d = mbx + 2 mby
of the spec order over skewed planes.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import native
from .deblock import ALPHA, BETA, TC0

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def deblock_frame_host(y, u, v, qp_mb, intra_mb, nz_y, mvq,
                       chroma_qp_table, t8=None):
    """Filter the planes (H, W) / (H/2, W/2) in spec order; returns new
    int32 (y, u, v). ``qp_mb`` / ``intra_mb`` per MB, ``nz_y`` (H/4, W/4)
    residual presence per transform block, ``chroma_qp_table`` (52,) with
    the PPS chroma offset folded in, ``t8`` the per-MB 8x8-transform
    flags (their interior 4-offset edges are not filtered)."""
    if native.disabled():
        return deblock_frame_np(y, u, v, qp_mb, intra_mb, nz_y, mvq,
                                chroma_qp_table, t8)
    lib = native.get_lib()
    null = ctypes.cast(None, _I32P)
    h, w = np.shape(y)
    yi = np.ascontiguousarray(y, np.int32)
    ui = np.ascontiguousarray(u, np.int32)
    vi = np.ascontiguousarray(v, np.int32)
    qp = np.ascontiguousarray(qp_mb, np.int32)
    intra = np.ascontiguousarray(intra_mb, bool).view(np.uint8)
    nz = np.ascontiguousarray(nz_y, bool).view(np.uint8)
    t8u = (np.ascontiguousarray(t8, bool).view(np.uint8)
           if t8 is not None else None)
    cq = np.ascontiguousarray(chroma_qp_table, np.int32)

    if isinstance(mvq, dict):
        mv_mode = 2
        mv0 = np.ascontiguousarray(mvq["mv0"], np.int32)
        id0 = np.ascontiguousarray(mvq["id0"], np.int32)
        mv1 = (np.ascontiguousarray(mvq["mv1"], np.int32)
               if "mv1" in mvq else None)
        id1 = (np.ascontiguousarray(mvq["id1"], np.int32)
               if "mv1" in mvq else None)
        gh = gw = 0
    else:
        mv_mode = 1
        mv0 = np.ascontiguousarray(mvq, np.int32)
        id0 = mv1 = id1 = None
        gh, gw = mv0.shape[:2]

    def p(a):
        return a.ctypes.data_as(_I32P) if a is not None else null
    lib.vcp_deblock_frame_direct(
        p(yi), p(ui), p(vi), h, w,
        intra.ctypes.data_as(_U8P), nz.ctypes.data_as(_U8P), p(qp),
        t8u.ctypes.data_as(_U8P) if t8u is not None
        else ctypes.cast(None, _U8P),
        mv_mode, p(mv0), p(id0), p(mv1), p(id1), gh, gw, p(cq))
    return yi, ui, vi


# ---------------------------------------------------------------------------
# NumPy path (VCP_NO_NATIVE=1)
# ---------------------------------------------------------------------------

def _filter_luma_np(p3, p2, p1, p0, q0, q1, q2, q3, bs, alpha, beta, tc0):
    """Elementwise luma edge filter (spec 8.7.2.3-4). Returns (out_p2,
    out_p1, out_p0, out_q0, out_q1, out_q2)."""
    filt = ((bs > 0) & (np.abs(p0 - q0) < alpha)
            & (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta))
    ap = np.abs(p2 - p0) < beta
    aq = np.abs(q2 - q0) < beta
    # normal filter (bS 1..3)
    tc = tc0 + ap.astype(np.int32) + aq.astype(np.int32)
    delta = np.clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = np.clip(p0 + delta, 0, 255)
    nq0 = np.clip(q0 - delta, 0, 255)
    dp1 = np.clip((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1, -tc0, tc0)
    dq1 = np.clip((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1, -tc0, tc0)
    np1 = np.where(ap, p1 + dp1, p1)
    nq1 = np.where(aq, q1 + dq1, q1)
    # strong filter (bS == 4)
    sc = np.abs(p0 - q0) < ((alpha >> 2) + 2)
    ps, qs = ap & sc, aq & sc
    sp0 = np.where(ps, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                   (2 * p1 + p0 + q1 + 2) >> 2)
    sp1 = np.where(ps, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = np.where(ps, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = np.where(qs, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                   (2 * q1 + q0 + p1 + 2) >> 2)
    sq1 = np.where(qs, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    sq2 = np.where(qs, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    is4 = bs == 4
    return (np.where(filt & is4, sp2, p2),
            np.where(filt, np.where(is4, sp1, np1), p1),
            np.where(filt, np.where(is4, sp0, np0), p0),
            np.where(filt, np.where(is4, sq0, nq0), q0),
            np.where(filt, np.where(is4, sq1, nq1), q1),
            np.where(filt & is4, sq2, q2))


def _filter_chroma_np(p1, p0, q0, q1, bs, alpha, beta, tc0):
    """Elementwise chroma edge filter (spec 8.7.2.3-4). Returns (out_p0,
    out_q0)."""
    filt = ((bs > 0) & (np.abs(p0 - q0) < alpha)
            & (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta))
    tc = tc0 + 1
    delta = np.clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = np.clip(p0 + delta, 0, 255)
    nq0 = np.clip(q0 - delta, 0, 255)
    sp0 = (2 * p1 + p0 + q1 + 2) >> 2
    sq0 = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs == 4
    return (np.where(filt, np.where(is4, sp0, np0), p0),
            np.where(filt, np.where(is4, sq0, nq0), q0))


def _mv_differ_general(m0, i0, m1, i1):
    """8.7.2.1's motion test between the two sides of each edge, on the
    per-list vectors and reference-picture ids: bS 1 when the sides use
    different MV counts or reference sets, or a picture-matched vector
    pair differs by >= 1 luma sample (both pairings tried when one
    picture serves both lists)."""
    m0p, m0q = m0[:, :-1], m0[:, 1:]
    m1p, m1q = m1[:, :-1], m1[:, 1:]
    i0p, i0q = i0[:, :-1], i0[:, 1:]
    i1p, i1q = i1[:, :-1], i1[:, 1:]
    cnt_p = (i0p >= 0).astype(np.int32) + (i1p >= 0)
    cnt_q = (i0q >= 0).astype(np.int32) + (i1q >= 0)

    def dmv(a, b):
        return np.any(np.abs(a - b) >= 4, axis=-1)
    # single-MV sides: the one used (mv, id), whichever list
    sp_mv = np.where((i0p >= 0)[..., None], m0p, m1p)
    sq_mv = np.where((i0q >= 0)[..., None], m0q, m1q)
    sp_id = np.where(i0p >= 0, i0p, i1p)
    sq_id = np.where(i0q >= 0, i0q, i1q)
    single = (sp_id != sq_id) | dmv(sp_mv, sq_mv)
    # bi sides: compare reference sets, then picture-matched pairs
    straight = (i0p == i0q) & (i1p == i1q)
    crossed = (i0p == i1q) & (i1p == i0q)
    d_ss = dmv(m0p, m0q) | dmv(m1p, m1q)
    d_cx = dmv(m0p, m1q) | dmv(m1p, m0q)
    bi = np.where(~(straight | crossed), True,
                  np.where(i0p == i1p, d_ss & d_cx,
                           np.where(straight, d_ss, d_cx)))
    return np.where(cnt_p != cnt_q, True, np.where(cnt_p == 2, bi, single))


def _bs_luma_np(intra_mb, nz_blk, mvq, vertical: bool, t8=None):
    """Boundary strengths of every internal luma edge in one direction,
    (n_edges, H/4 or W/4) int32, each edge's values along the edge;
    ``mvq`` a per-MB or per-8x8 quarter-pel grid or the general dict."""
    general = isinstance(mvq, dict)
    if not vertical:
        intra_mb, nz_blk = intra_mb.T, nz_blk.T
        if t8 is not None:
            t8 = t8.T
        mvq = ({k: np.swapaxes(a, 0, 1) for k, a in mvq.items()}
               if general else np.swapaxes(mvq, 0, 1))
    bh, bw = nz_blk.shape
    intra_e4 = np.repeat(np.repeat(intra_mb, 4, 0), 4, 1)
    intra_e = intra_e4[:, :-1] | intra_e4[:, 1:]
    j = np.arange(bw - 1)
    is_mb_edge = ((j + 1) % 4 == 0)[None, :]
    nz_e = nz_blk[:, :-1] | nz_blk[:, 1:]
    if general:
        rep = bh // mvq["mv0"].shape[0]

        def exp2(a):
            return np.repeat(np.repeat(a, rep, 0), rep, 1)
        m0, i0 = exp2(mvq["mv0"]), exp2(mvq["id0"])
        if "mv1" in mvq:
            m1, i1 = exp2(mvq["mv1"]), exp2(mvq["id1"])
        else:
            m1, i1 = np.zeros_like(m0), np.full_like(i0, -1)
        mv_diff = _mv_differ_general(m0, i0, m1, i1)
    else:
        rep = bh // mvq.shape[0]          # 4 = per-MB grid, 2 = per-8x8
        mv_e = np.repeat(np.repeat(mvq, rep, 0), rep, 1)
        mv_diff = np.any(np.abs(mv_e[:, :-1] - mv_e[:, 1:]) >= 4, axis=-1)
    bs = np.where(intra_e, np.where(is_mb_edge, 4, 3),
                  np.where(nz_e, 2, np.where(mv_diff, 1, 0)))
    if t8 is not None:
        # interior 4-offset edges of 8x8-transform MBs are not filtered
        t8_e = np.repeat(np.repeat(t8, 4, 0), 4, 1)[:, :-1]
        bs = np.where(t8_e & ((j + 1) % 2 == 1)[None, :], 0, bs)
    return bs.T.astype(np.int32)


def _qp_edges_np(qp_mb, vertical: bool, chroma: bool, chroma_qp_table):
    """Per-edge averaged QP, expanded per block row: (n_edges, Hb)."""
    if not vertical:
        qp_mb = qp_mb.T
    if chroma:
        qp_mb = np.asarray(chroma_qp_table)[np.clip(qp_mb, 0, 51)]
    per_mb = 2 if chroma else 4
    qp_e = np.repeat(np.repeat(qp_mb, per_mb, 0), per_mb, 1)
    return (((qp_e[:, :-1] + qp_e[:, 1:] + 1) >> 1).T).astype(np.int32)


def _skew_np(a, band: int, shift: int, extra: int = 0):
    h, w = a.shape
    nb = h // band
    out = np.zeros((h, w + shift * (nb - 1) + extra), a.dtype)
    for b in range(nb):
        out[b * band:(b + 1) * band, b * shift:b * shift + w] = \
            a[b * band:(b + 1) * band]
    return out


def _unskew_np(a, band: int, shift: int, w: int):
    h = a.shape[0]
    return np.concatenate(
        [a[b * band:(b + 1) * band, b * shift:b * shift + w]
         for b in range(h // band)], axis=0)


def _wavefront_luma_np(y, vthr, hthr, n_mby, n_mbx):
    """The luma filter in spec order: one step per MB diagonal over the
    plane skewed by 32 columns a 16-row band, vertical edges then
    horizontal ones; ``vthr`` / ``hthr`` (4, ...) the bS, alpha, beta and
    tc0 of every edge sample."""
    h, w = y.shape
    d_steps = n_mbx + 2 * (n_mby - 1)
    ys = np.pad(_skew_np(y, 16, 32, extra=16), ((0, 0), (32, 0)))
    vs = np.stack([_skew_np(vthr[i], 16, 8, extra=8) for i in range(4)])
    hs = np.stack([_skew_np(hthr[i], 4, 32, extra=16) for i in range(4)])
    for d in range(d_steps):
        win = ys[:, 16 * d:16 * d + 48]
        vt = vs[:, :, 4 * d:4 * d + 4]
        ht = hs[:, :, 16 * d:16 * d + 16].reshape(4, n_mby, 4, 16)
        for k in range(4):
            c = 32 + 4 * k
            out = _filter_luma_np(*(win[:, c - 4 + i] for i in range(8)),
                                  vt[0, :, k], vt[1, :, k], vt[2, :, k],
                                  vt[3, :, k])
            win[:, c - 3:c + 3] = np.stack(out, axis=1)
        r = win.reshape(n_mby, 16, 48)
        p = r[:-1, 12:16, 0:16]
        q = r[1:, 0:4, 32:48]
        out = _filter_luma_np(
            p[:, 0], p[:, 1], p[:, 2], p[:, 3],
            q[:, 0], q[:, 1], q[:, 2], q[:, 3],
            ht[0, 1:, 0], ht[1, 1:, 0], ht[2, 1:, 0], ht[3, 1:, 0])
        r[:-1, 13:16, 0:16] = np.stack(out[:3], axis=1)
        r[1:, 0:3, 32:48] = np.stack(out[3:], axis=1)
        for k in range(1, 4):
            seg = r[:, 4 * k - 4:4 * k + 4, 32:48]
            out = _filter_luma_np(
                *(seg[:, i] for i in range(8)),
                ht[0, :, k], ht[1, :, k], ht[2, :, k], ht[3, :, k])
            r[:, 4 * k - 3:4 * k + 3, 32:48] = np.stack(out, axis=1)
    return _unskew_np(ys[:, 32:], 16, 32, w)


def _wavefront_chroma_np(u, v, vthr, hthr, n_mby, n_mbx):
    """Both chroma planes in spec order, stacked, as the luma wavefront."""
    hc, wc = u.shape
    d_steps = n_mbx + 2 * (n_mby - 1)
    ys = np.concatenate([_skew_np(u, 8, 16, extra=8),
                         _skew_np(v, 8, 16, extra=8)], axis=0)
    ys = np.pad(ys, ((0, 0), (16, 0)))
    vs = np.stack([
        np.concatenate([_skew_np(vthr[i], 8, 4, extra=4)] * 2, axis=0)
        for i in range(4)])
    hs = np.stack([
        np.concatenate([_skew_np(hthr[i], 2, 16, extra=8)] * 2, axis=0)
        for i in range(4)])
    for d in range(d_steps):
        win = ys[:, 8 * d:8 * d + 24]
        vt = vs[:, :, 2 * d:2 * d + 2]
        ht = hs[:, :, 8 * d:8 * d + 8].reshape(4, 2 * n_mby, 2, 8)
        for k in range(2):
            c = 16 + 4 * k
            op0, oq0 = _filter_chroma_np(
                win[:, c - 2], win[:, c - 1], win[:, c], win[:, c + 1],
                vt[0, :, k], vt[1, :, k], vt[2, :, k], vt[3, :, k])
            win[:, c - 1] = op0
            win[:, c] = oq0
        r = win.reshape(2 * n_mby, 8, 24)
        p = r[:-1, 6:8, 0:8]
        q = r[1:, 0:2, 16:24]
        op0, oq0 = _filter_chroma_np(
            p[:, 0], p[:, 1], q[:, 0], q[:, 1],
            ht[0, 1:, 0], ht[1, 1:, 0], ht[2, 1:, 0], ht[3, 1:, 0])
        r[:-1, 7, 0:8] = op0
        r[1:, 0, 16:24] = oq0
        seg = r[:, 2:6, 16:24]
        op0, oq0 = _filter_chroma_np(
            seg[:, 0], seg[:, 1], seg[:, 2], seg[:, 3],
            ht[0, :, 1], ht[1, :, 1], ht[2, :, 1], ht[3, :, 1])
        r[:, 3, 16:24] = op0
        r[:, 4, 16:24] = oq0
    ys = ys[:, 16:]
    return (_unskew_np(ys[:hc], 8, 16, wc), _unskew_np(ys[hc:], 8, 16, wc))


def deblock_frame_np(y, u, v, qp_mb, intra_mb, nz_y, mvq, chroma_qp_table,
                     t8=None):
    """``deblock_frame_host`` in NumPy (same arguments, same result): the
    per-edge threshold grids, then the two wavefronts."""
    y, u, v = (np.asarray(p, np.int64) for p in (y, u, v))
    qp_mb, intra_mb, nz_y = (np.asarray(a) for a in (qp_mb, intra_mb,
                                                     nz_y))
    mvq = ({k: np.asarray(a) for k, a in mvq.items()}
           if isinstance(mvq, dict) else np.asarray(mvq))
    t8 = np.asarray(t8) if t8 is not None else None
    hc, wc = u.shape
    n_mby, n_mbx = qp_mb.shape

    def grid(bs_e, qp_e, rep):
        """(4, samples along the edges, n_edges + 1) bS / alpha / beta /
        tc0, a zero column for the picture's left (or top) edge, each
        value repeated ``rep`` times along its edge."""
        pad = np.zeros((1, bs_e.shape[1]), np.int64)
        bs = np.repeat(np.concatenate([pad, bs_e]), rep, axis=1).T
        qp = np.repeat(np.concatenate([pad, qp_e]), rep, axis=1).T
        idx = np.clip(qp, 0, 51)
        return np.stack([bs, ALPHA[idx], BETA[idx],
                         TC0[np.clip(bs, 1, 3) - 1, idx]]).astype(np.int64)

    bs_v = _bs_luma_np(intra_mb, nz_y, mvq, True, t8)
    vthr = grid(bs_v, _qp_edges_np(qp_mb, True, False, None), 4)
    bs_h = _bs_luma_np(intra_mb, nz_y, mvq, False, t8)
    hthr = np.swapaxes(grid(bs_h, _qp_edges_np(qp_mb, False, False, None),
                            4), 1, 2)
    bs_cv = np.repeat(bs_v[1::2], 2, axis=1).reshape(wc // 4 - 1, hc)
    qp_cv = np.repeat(_qp_edges_np(qp_mb, True, True, chroma_qp_table), 4,
                      axis=1)
    cvthr = grid(bs_cv, qp_cv, 1)
    bs_ch = np.repeat(bs_h[1::2], 2, axis=1).reshape(hc // 4 - 1, wc)
    qp_ch = np.repeat(_qp_edges_np(qp_mb, False, True, chroma_qp_table), 4,
                      axis=1)
    chthr = np.swapaxes(grid(bs_ch, qp_ch, 1), 1, 2)
    y = _wavefront_luma_np(y, vthr, hthr, n_mby, n_mbx)
    u, v = _wavefront_chroma_np(u, v, cvthr, chthr, n_mby, n_mbx)
    return tuple(np.ascontiguousarray(p, np.int32) for p in (y, u, v))
