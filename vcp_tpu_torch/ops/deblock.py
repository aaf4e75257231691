"""H.264 in-loop deblocking filter (spec 8.7): tables, boundary strengths,
thresholds and the plain PyTorch spec-order filter.

Port of the main-path subset of ``vcp_tpu/ops/deblock.py``. The filter
order is normatively sequential across macroblocks (per-MB raster,
vertical then horizontal edges, each edge reading previously filtered
samples). The plain versions below realize that order as the skewed
diagonal wavefront over d = mbx + 2*mby that ``vcp_tpu`` uses: MBs on
one diagonal touch disjoint samples, so each step is dense tensor work.

Two forms, each the plain version of one CUDA kernel in ``deblock_cuda``:

* ``deblock_fast_plain`` — uniform slice QP, all-inter (bS <= 3): one bS
  grid per edge direction plus ten scalars (alpha, beta, tc0 for bS 1..3,
  luma then chroma); the P-frame path.
* ``deblock_general_plain`` — per-edge (bS, alpha, beta, tc0) threshold
  grids and, with ``strong=True``, the bS 4 strong filter; the IDR path.

``deblock_frame`` computes the grids and routes to the kernel wrappers,
which run these plain versions only for CPU tensors. ``deblock_mb_plain``
is one macroblock step of the same filter, the unit the CUDA kernel's
blocks schedule; the tests use it to check the kernel's wait rule.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import constant
from .transform import CHROMA_QP_FULL

# Table 8-16: alpha / beta per index 0..51.
ALPHA = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28,
    32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113,
    127, 144, 162, 182, 203, 226, 255, 255], dtype=np.int32)

BETA = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8,
    9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14,
    15, 15, 16, 16, 17, 17, 18, 18], dtype=np.int32)

# Table 8-17: tc0 per (bS-1, index).
TC0 = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2,
     2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2,
     2, 3, 3, 3, 4, 4, 5, 5, 6, 7, 8, 8, 10, 11, 12, 13, 15, 17],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3,
     4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 23, 25],
], dtype=np.int32)


def _clip1(x):
    return torch.clamp(x, 0, 255)


def filter_core_luma(p3, p2, p1, p0, q0, q1, q2, q3, bs, alpha, beta,
                     tc0, strong: bool = True):
    """Elementwise luma edge filter (spec 8.7.2.3-4). Returns (out_p2,
    out_p1, out_p0, out_q0, out_q1, out_q2). ``strong=False`` drops the
    bS 4 path, which is bit-identical whenever no bS is 4."""
    filt = ((bs > 0) & ((p0 - q0).abs() < alpha)
            & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta

    # normal filter (bS 1..3)
    tc = tc0 + ap.to(torch.int32) + aq.to(torch.int32)
    delta = torch.clamp(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = _clip1(p0 + delta)
    nq0 = _clip1(q0 - delta)
    ntc0 = -tc0 if isinstance(tc0, torch.Tensor) else -int(tc0)
    dp1 = torch.clamp((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1, ntc0, tc0)
    dq1 = torch.clamp((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1, ntc0, tc0)
    np1 = torch.where(ap, p1 + dp1, p1)
    nq1 = torch.where(aq, q1 + dq1, q1)

    if not strong:
        return (p2, torch.where(filt, np1, p1), torch.where(filt, np0, p0),
                torch.where(filt, nq0, q0), torch.where(filt, nq1, q1), q2)

    # strong filter (bS == 4)
    sc = (p0 - q0).abs() < ((alpha >> 2) + 2)
    ps, qs = ap & sc, aq & sc
    sp0 = torch.where(ps, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                      (2 * p1 + p0 + q1 + 2) >> 2)
    sp1 = torch.where(ps, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = torch.where(ps, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = torch.where(qs, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                      (2 * q1 + q0 + p1 + 2) >> 2)
    sq1 = torch.where(qs, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    sq2 = torch.where(qs, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    is4 = bs == 4
    return (torch.where(filt & is4, sp2, p2),
            torch.where(filt, torch.where(is4, sp1, np1), p1),
            torch.where(filt, torch.where(is4, sp0, np0), p0),
            torch.where(filt, torch.where(is4, sq0, nq0), q0),
            torch.where(filt, torch.where(is4, sq1, nq1), q1),
            torch.where(filt & is4, sq2, q2))


def filter_core_chroma(p1, p0, q0, q1, bs, alpha, beta, tc0):
    """Elementwise chroma edge filter (spec 8.7.2.3-4). Returns (out_p0,
    out_q0)."""
    filt = ((bs > 0) & ((p0 - q0).abs() < alpha)
            & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    tc = tc0 + 1
    delta = torch.clamp(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = _clip1(p0 + delta)
    nq0 = _clip1(q0 - delta)
    sp0 = (2 * p1 + p0 + q1 + 2) >> 2
    sq0 = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs == 4
    return (torch.where(filt, torch.where(is4, sp0, np0), p0),
            torch.where(filt, torch.where(is4, sq0, nq0), q0))


def lookup_tables(bs: torch.Tensor, qp_av: torch.Tensor):
    """(alpha, beta, tc0) per element from the spec tables."""
    idx = qp_av.clamp(0, 51).long()
    bsc = bs.clamp(1, 3).long() - 1
    dev = bs.device
    return (constant("alpha", ALPHA, dev, torch.int32)[idx],
            constant("beta", BETA, dev, torch.int32)[idx],
            constant("tc0", TC0, dev, torch.int32)[bsc, idx])


def _rep2(a: torch.Tensor, f: int) -> torch.Tensor:
    return a.repeat_interleave(f, 0).repeat_interleave(f, 1)


def _mv_differ(a: torch.Tensor) -> torch.Tensor:
    """Across each edge of a per-block vector grid (bh, bw, 2): does a
    component differ by >= 4 (one luma sample)?"""
    return ((a[:, :-1] - a[:, 1:]).abs() >= 4).any(dim=-1)


def compute_bs_luma(intra_mb: torch.Tensor, nz_blk: torch.Tensor,
                    mvq, vertical: bool,
                    t8: torch.Tensor | None = None) -> torch.Tensor:
    """Boundary strengths of all internal luma edges in one direction.

    intra_mb (nMBy, nMBx) bool; nz_blk (H/4, W/4) bool (block has
    residual); mvq (nMBy, nMBx, 2) quarter-pel, or (2nMBy, 2nMBx, 2) for
    frames with partitions (one vector per 8x8 block; the granularity is
    read from the shape), or for B pictures a tuple (mv0, mv1, use) of
    per-list vectors (nMBy, nMBx, 2) and list-usage flags (nMBy, nMBx, 2)
    bool. bS is 4 on intra MB edges, 3 on intra internal edges, 2 where
    either side has residual, 1 where a MV component differs by >= 4
    (one luma sample) or, in B pictures, where the two sides use
    different lists (each list is one picture here) or a list both use
    has vectors that differ so (spec 8.7.2.1), else 0. ``t8`` (nMBy,
    nMBx) bool flags transform_size_8x8 MBs, whose interior 4-offset
    edges are not filtered (spec 8.7: luma edges fall on the
    transform-block grid). Returns (n_edges, H/4 or W/4) int32, edge j
    at offset 4*(j+1)."""
    two_list = isinstance(mvq, tuple)
    if not vertical:
        intra_mb = intra_mb.T
        nz_blk = nz_blk.T
        mvq = (tuple(a.transpose(0, 1) for a in mvq) if two_list
               else mvq.transpose(0, 1))
        if t8 is not None:
            t8 = t8.T
    bh, bw = nz_blk.shape
    intra_e4 = _rep2(intra_mb, 4)
    intra_e = intra_e4[:, :-1] | intra_e4[:, 1:]
    j = torch.arange(bw - 1, device=nz_blk.device)
    is_mb_edge = ((j + 1) % 4 == 0)[None, :]
    nz_e = nz_blk[:, :-1] | nz_blk[:, 1:]
    if two_list:
        m0, m1, use = (_rep2(a, 4) for a in mvq)
        both = use[:, :-1] & use[:, 1:]
        mv_diff = ((use[:, :-1] != use[:, 1:]).any(dim=-1)
                   | (both[..., 0] & _mv_differ(m0))
                   | (both[..., 1] & _mv_differ(m1)))
    else:
        mv_diff = _mv_differ(_rep2(mvq, bh // mvq.shape[0]))
    bs = torch.where(
        intra_e, torch.where(is_mb_edge, 4, 3),
        torch.where(nz_e, 2, torch.where(mv_diff, 1, 0)))
    if t8 is not None:
        # edge j (at x = 4(j+1)) is interior to an 8x8 block when j+1 is
        # odd, and then lies inside MB column (j+1) // 4
        interior_odd = ((j + 1) % 2 == 1)[None, :]
        bs = torch.where(_rep2(t8, 4)[:, :-1] & interior_odd, 0, bs)
    return bs.T.to(torch.int32).contiguous()


def compute_qp_edges(qp_mb: torch.Tensor, vertical: bool,
                     chroma: bool) -> torch.Tensor:
    """Per-edge averaged QP, expanded per block row: (n_edges, Hb)."""
    if not vertical:
        qp_mb = qp_mb.T
    if chroma:
        qp_mb = constant("chroma_qp", CHROMA_QP_FULL, qp_mb.device,
                         torch.int32)[qp_mb.clamp(0, 51).long()]
    qp_e = _rep2(qp_mb, 2 if chroma else 4)
    return ((qp_e[:, :-1] + qp_e[:, 1:] + 1) >> 1).T.to(torch.int32)


def chroma_bs(bs_v: torch.Tensor, bs_h: torch.Tensor):
    """Chroma edges lie on the 8-px luma grid (every other luma edge); a
    luma block row covers 2 chroma rows. Returns (bs_cv (wc/4-1, hc),
    bs_ch (hc/4-1, wc))."""
    return (bs_v[1::2].repeat_interleave(2, dim=1),
            bs_h[1::2].repeat_interleave(2, dim=1))


def _pad_edges(e: torch.Tensor) -> torch.Tensor:
    """Prepend the frame-edge row (value 0) to (n_edges, blkrows)."""
    pad = torch.zeros((1, e.shape[1]), dtype=torch.int32, device=e.device)
    return torch.cat([pad, e.to(torch.int32)], dim=0)


def _stack_grid(bs, alpha, beta, tc0, rep: int, transpose: bool):
    """Padded (n_edges+1, blkrows) channels → (4, blkrows*rep, n_edges+1)
    keyed by the edge's own block column (column 0 = frame edge, bS 0),
    or its transpose (4, n_edges+1, blkrows*rep) for horizontal edges."""
    thr = torch.stack([bs, alpha, beta, tc0]).to(torch.int32) \
        .transpose(1, 2)
    if rep > 1:
        thr = thr.repeat_interleave(rep, dim=1)
    return (thr.transpose(1, 2) if transpose else thr).contiguous()


def threshold_grids(bs_v, bs_h, qp_mb):
    """General-form per-edge (bS, alpha, beta, tc0) grids from the bS
    grids and the per-MB QP: vthr (4, H, W/4), hthr (4, H/4, W), cvthr
    (4, hc, wc/4), chthr (4, hc/4, wc)."""
    def grid(bs_e, qp_e, rep, transpose):
        bs, qp = _pad_edges(bs_e), _pad_edges(qp_e)
        return _stack_grid(bs, *lookup_tables(bs, qp), rep, transpose)

    bs_cv, bs_ch = chroma_bs(bs_v, bs_h)
    return (
        grid(bs_v, compute_qp_edges(qp_mb, True, False), 4, False),
        grid(bs_h, compute_qp_edges(qp_mb, False, False), 4, True),
        grid(bs_cv, compute_qp_edges(qp_mb, True, True)
             .repeat_interleave(4, dim=1), 1, False),
        grid(bs_ch, compute_qp_edges(qp_mb, False, True)
             .repeat_interleave(4, dim=1), 1, True))


def deblock_scalars(qp: int) -> tuple[int, ...]:
    """The ten thresholds of the uniform-QP form: alpha, beta, tc0 for
    bS 1..3 at the luma QP, then the same at the chroma QP."""
    qi = int(np.clip(qp, 0, 51))
    qc = int(CHROMA_QP_FULL[qi])
    return tuple(int(x) for x in (
        ALPHA[qi], BETA[qi], TC0[0, qi], TC0[1, qi], TC0[2, qi],
        ALPHA[qc], BETA[qc], TC0[0, qc], TC0[1, qc], TC0[2, qc]))


def fast_grids(bs_v, bs_h, scal):
    """The general-form grids that the ten scalars stand for."""
    def grid(bs_e, s, rep, transpose):
        bs = _pad_edges(bs_e)
        tc = torch.where(bs == 1, s[2], torch.where(bs == 2, s[3], s[4]))
        return _stack_grid(bs, torch.full_like(bs, s[0]),
                           torch.full_like(bs, s[1]), tc, rep, transpose)

    bs_cv, bs_ch = chroma_bs(bs_v, bs_h)
    return (grid(bs_v, scal[:5], 4, False), grid(bs_h, scal[:5], 4, True),
            grid(bs_cv, scal[5:], 1, False), grid(bs_ch, scal[5:], 1, True))


# ---------------------------------------------------------------------------
# Spec-order wavefront (plain versions of the kernels)
# ---------------------------------------------------------------------------

def _skew(a: torch.Tensor, band: int, shift: int,
          extra: int = 0) -> torch.Tensor:
    """Shift row band b right by ``b*shift`` columns, so the diagonals
    d = mbx + 2*mby become contiguous column strips."""
    h, w = a.shape
    nb = h // band
    out = a.new_zeros((h, w + shift * (nb - 1) + extra))
    for b in range(nb):
        out[b * band:(b + 1) * band, b * shift:b * shift + w] = \
            a[b * band:(b + 1) * band]
    return out


def _unskew(a: torch.Tensor, band: int, shift: int, w: int) -> torch.Tensor:
    return torch.cat([a[b * band:(b + 1) * band, b * shift:b * shift + w]
                      for b in range(a.shape[0] // band)], dim=0)


def _wavefront_luma(y, vthr, hthr, n_mby, n_mbx, strong):
    h, w = y.shape
    d_steps = n_mbx + 2 * (n_mby - 1)
    ys = torch.cat([y.new_zeros((h, 32)), _skew(y, 16, 32, extra=16)],
                   dim=1)
    vs = torch.stack([_skew(vthr[i], 16, 8, extra=8) for i in range(4)])
    hs = torch.stack([_skew(hthr[i], 4, 32, extra=16) for i in range(4)])
    for d in range(d_steps):
        win = ys[:, 16 * d:16 * d + 48]
        vt = vs[:, :, 4 * d:4 * d + 4]
        ht = hs[:, :, 16 * d:16 * d + 16].reshape(4, n_mby, 4, 16)
        # vertical edges of the diagonal's MBs, left to right
        for k in range(4):
            c = 32 + 4 * k
            out = filter_core_luma(*(win[:, c - 4 + i] for i in range(8)),
                                   vt[0, :, k], vt[1, :, k], vt[2, :, k],
                                   vt[3, :, k], strong=strong)
            win[:, c - 3:c + 3] = torch.stack(out, dim=1)
        # horizontal edges; the MB-top edge's p rows live in the top
        # neighbor's band, at window columns 0:16 (the skew offset)
        r = win.view(n_mby, 16, 48)
        p = r[:-1, 12:16, 0:16]
        q = r[1:, 0:4, 32:48]
        out = filter_core_luma(
            p[:, 0], p[:, 1], p[:, 2], p[:, 3],
            q[:, 0], q[:, 1], q[:, 2], q[:, 3],
            ht[0, 1:, 0], ht[1, 1:, 0], ht[2, 1:, 0], ht[3, 1:, 0],
            strong=strong)
        sp, sq = torch.stack(out[:3], dim=1), torch.stack(out[3:], dim=1)
        r[:-1, 13:16, 0:16] = sp
        r[1:, 0:3, 32:48] = sq
        for k in range(1, 4):
            seg = r[:, 4 * k - 4:4 * k + 4, 32:48]
            out = filter_core_luma(
                *(seg[:, i] for i in range(8)),
                ht[0, :, k], ht[1, :, k], ht[2, :, k], ht[3, :, k],
                strong=strong)
            r[:, 4 * k - 3:4 * k + 3, 32:48] = torch.stack(out, dim=1)
    return _unskew(ys[:, 32:], 16, 32, w)


def _wavefront_chroma(u, v, vthr, hthr, n_mby, n_mbx):
    """Chroma wavefront (8-px MBs, 2 edges per direction); u and v ride
    the same steps stacked along rows."""
    hc, wc = u.shape
    d_steps = n_mbx + 2 * (n_mby - 1)
    ys = torch.cat([_skew(u, 8, 16, extra=8), _skew(v, 8, 16, extra=8)],
                   dim=0)
    ys = torch.cat([ys.new_zeros((2 * hc, 16)), ys], dim=1)
    vs = torch.stack([torch.cat([_skew(vthr[i], 8, 4, extra=4)] * 2, dim=0)
                      for i in range(4)])
    hs = torch.stack([torch.cat([_skew(hthr[i], 2, 16, extra=8)] * 2, dim=0)
                      for i in range(4)])
    for d in range(d_steps):
        win = ys[:, 8 * d:8 * d + 24]
        vt = vs[:, :, 2 * d:2 * d + 2]
        ht = hs[:, :, 8 * d:8 * d + 8].reshape(4, 2 * n_mby, 2, 8)
        for k in range(2):
            c = 16 + 4 * k
            op0, oq0 = filter_core_chroma(
                win[:, c - 2], win[:, c - 1], win[:, c], win[:, c + 1],
                vt[0, :, k], vt[1, :, k], vt[2, :, k], vt[3, :, k])
            win[:, c - 1:c + 1] = torch.stack([op0, oq0], dim=1)
        # MB-top edge: the v plane's first band has bS 0, so the
        # cross-plane pairing at band n_mby is a no-op
        r = win.view(2 * n_mby, 8, 24)
        p = r[:-1, 6:8, 0:8]
        q = r[1:, 0:2, 16:24]
        op0, oq0 = filter_core_chroma(
            p[:, 0], p[:, 1], q[:, 0], q[:, 1],
            ht[0, 1:, 0], ht[1, 1:, 0], ht[2, 1:, 0], ht[3, 1:, 0])
        r[:-1, 7, 0:8] = op0
        r[1:, 0, 16:24] = oq0
        seg = r[:, 2:6, 16:24]
        op0, oq0 = filter_core_chroma(
            seg[:, 0], seg[:, 1], seg[:, 2], seg[:, 3],
            ht[0, :, 1], ht[1, :, 1], ht[2, :, 1], ht[3, :, 1])
        r[:, 3, 16:24] = op0
        r[:, 4, 16:24] = oq0
    ys = ys[:, 16:]
    return _unskew(ys[:hc], 8, 16, wc), _unskew(ys[hc:], 8, 16, wc)


def deblock_general_plain(y, u, v, vthr, hthr, cvthr, chthr,
                          strong: bool = True):
    """Plain version of the ``deblock_general`` kernel: spec-order filter
    of (H, W) / (H/2, W/2) int32 planes with per-edge threshold grids."""
    n_mby, n_mbx = y.shape[0] // 16, y.shape[1] // 16
    y = _wavefront_luma(y.to(torch.int32).clone(), vthr, hthr, n_mby,
                        n_mbx, strong)
    u, v = _wavefront_chroma(u.to(torch.int32), v.to(torch.int32), cvthr,
                             chthr, n_mby, n_mbx)
    return y, u, v


def deblock_fast_plain(y, u, v, bs_v, bs_h, scal):
    """Plain version of the ``deblock_fast`` kernel: uniform-QP all-inter
    filter (bS <= 3) from the two bS grids and the ten scalars."""
    return deblock_general_plain(y, u, v, *fast_grids(bs_v, bs_h, scal),
                                 strong=False)


def deblock_mb_plain(y, u, v, grids, mbx: int, mby: int,
                     strong: bool = True) -> None:
    """One macroblock step of the spec-order filter, in place on whole
    planes: exactly what one block step of the ``deblock_wave`` kernel
    filters. MB (mbx, mby)'s four vertical luma edges left to right, then
    its four horizontal ones top to bottom, and likewise the two and two
    chroma edges of each plane; frame-edge positions are no edges.
    ``grids`` are the general-form threshold grids (``threshold_grids``
    or ``fast_grids``). Applied to every MB in an order in which MB
    (x, y) comes after MB (x-1, y) and after MB (min(x+1, nMBx-1), y-1),
    it equals ``deblock_general_plain``."""
    vthr, hthr, cvthr, chthr = grids

    def step(plane, vt, ht, size, n_edges, core, taps):
        half = taps // 2
        r0, c0 = size * mby, size * mbx
        rows, cols = slice(r0, r0 + size), slice(c0, c0 + size)
        for k in range(n_edges):
            x = c0 + 4 * k
            if x == 0:
                continue
            out = core(*(plane[rows, x - half + i] for i in range(taps)),
                       *vt[:, rows, x // 4])
            plane[rows, x - len(out) // 2:x + len(out) // 2] = \
                torch.stack(out, dim=1)
        for k in range(n_edges):
            yy = r0 + 4 * k
            if yy == 0:
                continue
            out = core(*(plane[yy - half + i, cols] for i in range(taps)),
                       *ht[:, yy // 4, cols])
            plane[yy - len(out) // 2:yy + len(out) // 2, cols] = \
                torch.stack(out, dim=0)

    def luma(*a):
        return filter_core_luma(*a, strong=strong)

    step(y, vthr, hthr, 16, 4, luma, 8)
    step(u, cvthr, chthr, 8, 2, filter_core_chroma, 4)
    step(v, cvthr, chthr, 8, 2, filter_core_chroma, 4)


def deblock_frame(y, u, v, qp_mb, intra_mb, nz_y, mvq,
                  no_strong: bool = False, qp_scalar: int | None = None,
                  t8: torch.Tensor | None = None):
    """Full in-loop filter of one reconstructed frame in spec order.

    y (H, W) int32; u, v (H/2, W/2); qp_mb (nMBy, nMBx) int32; intra_mb
    bool; nz_y (H/4, W/4) bool; mvq and t8 (nMBy, nMBx) bool or None as
    for ``compute_bs_luma``.
    ``no_strong=True`` with ``qp_scalar`` (every qp_mb entry equal to it,
    no intra MB) takes the uniform-QP form; otherwise the general form,
    with the strong filter unless ``no_strong``."""
    from . import deblock_cuda
    bs_v = compute_bs_luma(intra_mb, nz_y, mvq, vertical=True, t8=t8)
    bs_h = compute_bs_luma(intra_mb, nz_y, mvq, vertical=False, t8=t8)
    if no_strong and qp_scalar is not None:
        return deblock_cuda.deblock_fast(y, u, v, bs_v, bs_h,
                                         deblock_scalars(qp_scalar))
    return deblock_cuda.deblock_general(
        y, u, v, *threshold_grids(bs_v, bs_h, qp_mb), strong=not no_strong)
