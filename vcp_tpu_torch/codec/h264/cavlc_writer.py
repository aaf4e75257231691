"""The CAVLC slice writers in Python: P slices with the 8x8 transform or
with partitioned MBs, and B slices.

Copies of ``_write_pslice_py`` and ``_write_bslice_py`` of
``vcp_tpu/codec/h264/pframe.py`` and ``bframe.py``, which are the only
CAVLC writers for those slices there (the native CAVLC writers in
``native/entropy.cpp`` cover the IDR and P slices of 16x16 MBs with the
4x4 transform). Each writes one complete slice NAL from the entropy dict
of the device step, with the encoder's MV predictors (spec 8.4.1.3: a
P slice here has no intra MB, so "not inter" and "unavailable" are one
case) and, for B slices, the decoder-semantics predictor and the
spatial-direct derivation that decide B_Skip / B_Direct_16x16.

Syntax per ITU-T H.264 7.3.5 (macroblock_layer), 7.4.5, 9.1-9.2.
"""

from __future__ import annotations

import numpy as np

from ...utils.bitstream import BitWriter, nal_unit
from . import headers as H
from .cavlc import encode_residual_block
from .frame_ops import LUMA_BLK_ORDER
from .tables import CBP_INTER_TO_CODE

# chroma 4x4 block order inside an MB's 8x8 chroma plane
CHROMA_BLK_ORDER = np.array([(0, 0), (0, 1), (1, 0), (1, 1)], dtype=np.int32)

MB_TYPE_P16x16 = 0
# P mb_type -> its partitions (dy, dx, width, height) on the 8x8 grid
_P_PARTS = {
    1: ((0, 0, 2, 1), (1, 0, 2, 1)),           # P_L0_L0_16x8
    2: ((0, 0, 1, 2), (0, 1, 1, 2)),           # P_L0_L0_8x16
}
# CAVLC ue(v) B mb_type per mode (Table 7-14): L0 = 1, L1 = 2, Bi = 3
_B_MBTYPE_FROM_MODE = (1, 2, 3)


class NzContext:
    """Per-4x4-block TotalCoeff context for nC prediction (spec 9.2.1)."""

    def __init__(self, blocks_h: int, blocks_w: int):
        self.nz = np.full((blocks_h, blocks_w), -1, np.int16)

    def set(self, by: int, bx: int, total: int) -> None:
        self.nz[by, bx] = total

    def nc(self, by: int, bx: int) -> int:
        na = self.nz[by, bx - 1] if bx > 0 else -1
        nb = self.nz[by - 1, bx] if by > 0 else -1
        if na >= 0 and nb >= 0:
            return (int(na) + int(nb) + 1) >> 1
        if na >= 0:
            return int(na)
        if nb >= 0:
            return int(nb)
        return 0


def _contexts(n_mby: int, n_mbx: int):
    return (NzContext(4 * n_mby, 4 * n_mbx), NzContext(2 * n_mby, 2 * n_mbx),
            NzContext(2 * n_mby, 2 * n_mbx))


def _zero_ctx(nz_y, nz_cb, nz_cr, mbx, mby):
    """A skipped MB: every block of it has TotalCoeff 0."""
    nz_y.nz[4 * mby:4 * mby + 4, 4 * mbx:4 * mbx + 4] = 0
    nz_cb.nz[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = 0
    nz_cr.nz[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = 0


def _cbp_grids(luma, cb_dc, cb_ac, cr_dc, cr_ac):
    """(cbp_luma, cbp_chroma) per MB from the level arrays."""
    n_mby, n_mbx = luma.shape[:2]
    quad_nz = np.any(luma != 0, axis=-1).reshape(n_mby, n_mbx, 4, 4) \
        .any(axis=-1)
    cbp_luma = (quad_nz * np.array([1, 2, 4, 8])).sum(axis=-1)
    any_cac = np.any(cb_ac[..., 1:] != 0, axis=(-1, -2)) | \
        np.any(cr_ac[..., 1:] != 0, axis=(-1, -2))
    any_cdc = np.any(cb_dc != 0, axis=-1) | np.any(cr_dc != 0, axis=-1)
    return cbp_luma, np.where(any_cac, 2, np.where(any_cdc, 1, 0))


# ---------------------------------------------------------------------------
# P-slice MV prediction on the 8x8 block grid (encoder semantics). Spec
# 8.4.1.3 works in 4x4 units; with every partition >= 8x8 the 8x8 grid
# carries the same information, and for 16x16 MBs it reduces to the
# per-MB rule.
# ---------------------------------------------------------------------------

def _blk8_before(by, bx, cby, cbx):
    """Is 8x8 block (cby, cbx) decoded before the partition whose top-left
    block is (by, bx)? MB raster order; partitions 0..3 raster within an
    MB."""
    mb = (by >> 1, bx >> 1)
    cmb = (cby >> 1, cbx >> 1)
    if cmb != mb:
        return cmb < mb
    return (2 * (cby & 1) + (cbx & 1)) < (2 * (by & 1) + (bx & 1))


def _neighbor8(mv8, valid8, by, bx, pw, nbx2):
    """(mvA, refA, mvB, refB, mvC, refC) for the partition with top-left
    8x8 block (by, bx), width ``pw`` blocks (2 = 16x16, 1 = 8x8); ref -1
    for an unavailable neighbour. C is the block above-right of the
    partition, substituted by D (above-left) when not available in
    decode order."""
    def get(cby, cbx):
        if cbx < 0 or cby < 0 or cbx >= nbx2:
            return (0, 0), -1
        if not valid8[cby, cbx]:
            return (0, 0), -1
        return (int(mv8[cby, cbx, 0]), int(mv8[cby, cbx, 1])), 0

    a, ra = get(by, bx - 1)
    b, rb = get(by - 1, bx)
    c_exists = (by - 1 >= 0 and bx + pw < nbx2
                and _blk8_before(by, bx, by - 1, bx + pw))
    if c_exists:
        c, rc = get(by - 1, bx + pw)
    else:
        c, rc = (0, 0), -1
    if not c_exists or rc < 0:
        d, rd = get(by - 1, bx - 1)
        if rc < 0:
            c, rc = d, rd
    return a, ra, b, rb, c, rc


def mv_pred8(mv8, valid8, by, bx, pw, nbx2, ph=None, part_idx=0):
    """Median MV predictor for a partition on the 8x8 grid, with the
    16x8 / 8x16 directional rules (8.4.1.3.1)."""
    if ph is None:
        ph = pw
    a, ra, b, rb, c, rc = _neighbor8(mv8, valid8, by, bx, pw, nbx2)
    if (pw, ph) == (2, 1):                     # 16x8
        if part_idx == 0 and rb == 0:
            return b
        if part_idx == 1 and ra == 0:
            return a
    elif (pw, ph) == (1, 2):                   # 8x16
        if part_idx == 0 and ra == 0:
            return a
        if part_idx == 1 and rc == 0:
            return c
    b_exists = by - 1 >= 0 and rb >= 0
    if not b_exists and rc < 0 and ra >= 0:
        return a
    hits = [i for i, r in enumerate((ra, rb, rc)) if r == 0]
    if len(hits) == 1:
        return (a, b, c)[hits[0]]
    xs = sorted((a[0], b[0], c[0]))
    ys = sorted((a[1], b[1], c[1]))
    return (xs[1], ys[1])


def skip_mv8(mv8, valid8, mbx, mby, nbx2):
    """P_Skip MV (spec 8.4.1.1) on the 8x8 grid."""
    by, bx = 2 * mby, 2 * mbx
    if bx - 1 < 0 or by - 1 < 0:
        return (0, 0)
    a, ra, b, rb, _, _ = _neighbor8(mv8, valid8, by, bx, 2, nbx2)
    if (ra == 0 and a == (0, 0)) or (rb == 0 and b == (0, 0)):
        return (0, 0)
    if ra < 0 or rb < 0:
        return (0, 0)
    return mv_pred8(mv8, valid8, by, bx, 2, nbx2)


# ---------------------------------------------------------------------------
# P slice
# ---------------------------------------------------------------------------

def _write_p_residual(bw, mbx, mby, cbp, z_luma, chroma_dc, chroma_ac,
                      nz_y, nz_cb, nz_cr, t8: bool = False):
    """An inter MB's residual: luma in coding order (an 8x8-transform MB's
    rows 4b..4b+3 hold 8x8 block b's 64-scan, sent as four interleaved
    4x4 scans, sub-block k = scan positions 4i + k), then chroma DC and
    AC."""
    cbp_luma = cbp & 15
    cbp_chroma = cbp >> 4
    if t8:
        for b8 in range(4):
            subs = np.asarray(z_luma[4 * b8:4 * b8 + 4]).reshape(16, 4).T
            for k in range(4):
                blk = 4 * b8 + k
                by = 4 * mby + int(LUMA_BLK_ORDER[blk, 0])
                bx = 4 * mbx + int(LUMA_BLK_ORDER[blk, 1])
                total = 0
                if cbp_luma & (1 << b8):
                    total = encode_residual_block(
                        bw, [int(x) for x in subs[k]], nz_y.nc(by, bx))
                nz_y.set(by, bx, total)
    else:
        for blk in range(16):
            by = 4 * mby + int(LUMA_BLK_ORDER[blk, 0])
            bx = 4 * mbx + int(LUMA_BLK_ORDER[blk, 1])
            total = 0
            if cbp_luma & (1 << (blk // 4)):
                total = encode_residual_block(
                    bw, [int(x) for x in z_luma[blk]], nz_y.nc(by, bx))
            nz_y.set(by, bx, total)
    if cbp_chroma:
        for c in range(2):
            encode_residual_block(bw, [int(x) for x in chroma_dc[c]], -1)
    for c, nzc in ((0, nz_cb), (1, nz_cr)):
        for blk in range(4):
            by = 2 * mby + int(CHROMA_BLK_ORDER[blk, 0])
            bx = 2 * mbx + int(CHROMA_BLK_ORDER[blk, 1])
            total = 0
            if cbp_chroma == 2:
                total = encode_residual_block(
                    bw, [int(x) for x in chroma_ac[c][blk, 1:]],
                    nzc.nc(by, bx))
            nzc.set(by, bx, total)


def write_pslice(sp: H.SeqParams, pp: H.PicParams, *, frame_num: int,
                 qp: int, data: dict, mv8_xy: np.ndarray,
                 parts: np.ndarray, deblock: bool = False,
                 poc_lsb: int = 0) -> bytes:
    """One CAVLC P slice NAL of P_L0_16x16 / 16x8 / 8x16 / P_8x8 and
    P_Skip MBs: ``mv8_xy`` (2nMBy, 2nMBx, 2) [x, y] quarter-pel vectors on
    the 8x8 grid and ``parts`` (nMBy, nMBx) partition types from
    ``entropy.mv8_grid_xy``; ``data`` holds the level arrays, optionally
    the "t8" flags (a transform_size_8x8_flag is written where the PPS
    has the 8x8 transform on) and the "active" mask of a sparse chunk
    (inactive MBs are P_Skip, their vectors re-derived here)."""
    n_mby, n_mbx = sp.mb_height, sp.mb_width
    nbx2 = 2 * n_mbx
    bw = BitWriter()
    H.write_slice_header(bw, sp, pp, is_idr=False, frame_num=frame_num,
                         slice_qp=qp, disable_deblocking=not deblock,
                         poc_lsb=poc_lsb)
    luma = np.asarray(data["luma"])            # (nMBy, nMBx, 16, 16)
    cb_dc, cb_ac = np.asarray(data["cb_dc"]), np.asarray(data["cb_ac"])
    cr_dc, cr_ac = np.asarray(data["cr_dc"]), np.asarray(data["cr_ac"])
    nz_y, nz_cb, nz_cr = _contexts(n_mby, n_mbx)
    t8 = data.get("t8")
    active = data.get("active")
    valid8 = np.ones((2 * n_mby, nbx2), bool)  # every MB is inter here
    mv8_xy = np.array(mv8_xy)                  # skips write theirs back
    cbp_luma, cbp_chroma = _cbp_grids(luma, cb_dc, cb_ac, cr_dc, cr_ac)

    skip_run = 0
    for mby in range(n_mby):
        for mbx in range(n_mbx):
            if active is not None and not active[mby, mbx]:
                mv8_xy[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = \
                    skip_mv8(mv8_xy, valid8, mbx, mby, nbx2)
                skip_run += 1
                _zero_ctx(nz_y, nz_cb, nz_cr, mbx, mby)
                continue
            cbp = int(cbp_luma[mby, mbx]) | (int(cbp_chroma[mby, mbx]) << 4)
            pt = int(parts[mby, mbx])
            by0, bx0 = 2 * mby, 2 * mbx
            m = (int(mv8_xy[by0, bx0, 0]), int(mv8_xy[by0, bx0, 1]))
            if pt == 0 and cbp == 0 \
                    and m == skip_mv8(mv8_xy, valid8, mbx, mby, nbx2):
                skip_run += 1
                _zero_ctx(nz_y, nz_cb, nz_cr, mbx, mby)
                continue
            bw.ue(skip_run)
            skip_run = 0
            if pt == 3:
                bw.ue(3)                    # mb_type P_8x8
                for _ in range(4):
                    bw.ue(0)                # sub_mb_type P_L0_8x8
                geo = [(q >> 1, q & 1, 1, 1) for q in range(4)]
            elif pt in _P_PARTS:
                bw.ue(pt)                   # P_L0_L0_16x8 / 8x16
                geo = _P_PARTS[pt]
            else:
                bw.ue(MB_TYPE_P16x16)
                geo = [(0, 0, 2, 2)]
            for i, (dy, dx, pw, ph) in enumerate(geo):
                by, bx = by0 + dy, bx0 + dx
                pred = mv_pred8(mv8_xy, valid8, by, bx, pw, nbx2, ph=ph,
                                part_idx=i)
                bw.se(int(mv8_xy[by, bx, 0]) - pred[0])
                bw.se(int(mv8_xy[by, bx, 1]) - pred[1])
            bw.ue(CBP_INTER_TO_CODE[cbp])
            t8f = bool(t8[mby, mbx]) if t8 is not None else False
            if (cbp & 15) > 0 and pp.transform_8x8:
                bw.u(1, 1 if t8f else 0)    # transform_size_8x8_flag
            if cbp:
                bw.se(0)                    # mb_qp_delta
            _write_p_residual(bw, mbx, mby, cbp, luma[mby, mbx],
                              (cb_dc[mby, mbx], cr_dc[mby, mbx]),
                              (cb_ac[mby, mbx], cr_ac[mby, mbx]),
                              nz_y, nz_cb, nz_cr, t8=t8f)
    if skip_run:
        bw.ue(skip_run)
    bw.rbsp_trailing_bits()
    return nal_unit(H.NAL_SLICE_NONIDR, bw.to_bytes(), nal_ref_idc=2)


# ---------------------------------------------------------------------------
# B slice: per-MB MV prediction with the spec's availability semantics (an
# MB that does not use list X is available with refIdxLX -1), spatial
# direct
# ---------------------------------------------------------------------------

def _mv_neighbors_dec(mvs, inter, mbx, mby, n_mbx):
    """(A, B, C) of an MB, each None when outside the picture, else (mv,
    refIdx) with refIdx -1 for an MB that does not use the list; C is
    substituted by D (above-left) when outside."""
    def get(x, y):
        if x < 0 or y < 0 or x >= n_mbx:
            return None
        if not inter[y, x]:
            return ((0, 0), -1)
        return ((int(mvs[y, x, 0]), int(mvs[y, x, 1])), 0)

    a = get(mbx - 1, mby)
    b = get(mbx, mby - 1)
    c = get(mbx + 1, mby - 1) if mby > 0 and mbx + 1 < n_mbx else None
    if c is None:
        c = get(mbx - 1, mby - 1)
    return a, b, c


def mv_pred_dec(mvs, inter, mbx, mby, n_mbx):
    """Spec 8.4.1.3 median MV prediction (decoder semantics)."""
    a, b, c = _mv_neighbors_dec(mvs, inter, mbx, mby, n_mbx)
    if b is None and c is None and a is not None:
        return a[0]
    matches = [n for n in (a, b, c) if n is not None and n[1] == 0]
    if len(matches) == 1:
        return matches[0][0]
    vals = [(n[0] if n is not None else (0, 0)) for n in (a, b, c)]
    return tuple(sorted(v[k] for v in vals)[1] for k in range(2))


def direct_spatial(mvs0, mvs1, use0, use1, mbx, mby, n_mbx, col_zero):
    """Spatial-direct motion of one MB (8.4.1.2.2, MB level; exact where
    the colocated MB's four 8x8 blocks share colZeroFlag ``col_zero``).
    Returns (use_l0, use_l1, mv0, mv1) with mv None for an unused list."""
    a0, b0, c0 = _mv_neighbors_dec(mvs0, use0, mbx, mby, n_mbx)
    a1, b1, c1 = _mv_neighbors_dec(mvs1, use1, mbx, mby, n_mbx)
    r0 = 0 if any(n is not None and n[1] == 0 for n in (a0, b0, c0)) else -1
    r1 = 0 if any(n is not None and n[1] == 0 for n in (a1, b1, c1)) else -1
    if r0 < 0 and r1 < 0:
        # directZeroPredictionFlag: both refs 0, both MVs zero
        return True, True, (0, 0), (0, 0)
    mv0 = mv1 = None
    if r0 >= 0:
        mv0 = (0, 0) if col_zero \
            else mv_pred_dec(mvs0, use0, mbx, mby, n_mbx)
    if r1 >= 0:
        mv1 = (0, 0) if col_zero \
            else mv_pred_dec(mvs1, use1, mbx, mby, n_mbx)
    return r0 >= 0, r1 >= 0, mv0, mv1


def _mode_of(use_l0: bool, use_l1: bool) -> int:
    return 2 if (use_l0 and use_l1) else (1 if use_l1 else 0)


def _skippable(mvs_xy, use, mbx, mby, n_mbx, col_zero, md) -> bool:
    """An MB may be B_Skip / B_Direct_16x16 iff the spatial-direct
    derivation reproduces the device step's mode and MVs exactly."""
    u0, u1, dmv0, dmv1 = direct_spatial(
        mvs_xy[0], mvs_xy[1], use[0], use[1], mbx, mby, n_mbx, col_zero)
    if _mode_of(u0, u1) != md:
        return False
    for u, dmv, lst in ((u0, dmv0, 0), (u1, dmv1, 1)):
        if u and tuple(dmv) != (int(mvs_xy[lst][mby, mbx, 0]),
                                int(mvs_xy[lst][mby, mbx, 1])):
            return False
    return True


def write_bslice(sp: H.SeqParams, pp: H.PicParams, *, frame_num: int,
                 qp: int, data: dict, deblock: bool = False,
                 poc_lsb: int = 0) -> bytes:
    """One CAVLC B slice NAL (non-reference) of B_L0 / B_L1 / B_Bi_16x16,
    B_Direct_16x16 and B_Skip MBs, from the dict of ``bframe.write_bslice``
    (4x4 transform only)."""
    n_mby, n_mbx = sp.mb_height, sp.mb_width
    bw = BitWriter()
    H.write_slice_header(bw, sp, pp, is_idr=False, frame_num=frame_num,
                         slice_qp=qp, disable_deblocking=not deblock,
                         slice_type="B", poc_lsb=poc_lsb, is_ref=False)
    mode = np.asarray(data["mode"])
    mvs_xy = []
    for k in ("mv0", "mv1"):
        mv = np.asarray(data[k])
        mvs_xy.append(np.stack([mv[..., 1], mv[..., 0]], axis=-1))
    use = [mode != 1, mode != 0]
    luma = np.asarray(data["luma"])
    cb_dc, cb_ac = np.asarray(data["cb_dc"]), np.asarray(data["cb_ac"])
    cr_dc, cr_ac = np.asarray(data["cr_dc"]), np.asarray(data["cr_ac"])
    nz_y, nz_cb, nz_cr = _contexts(n_mby, n_mbx)
    cbp_luma, cbp_chroma = _cbp_grids(luma, cb_dc, cb_ac, cr_dc, cr_ac)
    col_zero = np.asarray(data["col_zero"]) if "col_zero" in data \
        else np.zeros((n_mby, n_mbx), bool)
    # B_Skip / direct only where the colocated MB's four 8x8 blocks agree
    col_safe = np.asarray(data["col_safe"]) if "col_safe" in data \
        else np.ones((n_mby, n_mbx), bool)

    skip_run = 0
    for mby in range(n_mby):
        for mbx in range(n_mbx):
            md = int(mode[mby, mbx])
            cbp = int(cbp_luma[mby, mbx]) | (int(cbp_chroma[mby, mbx]) << 4)
            direct_ok = bool(col_safe[mby, mbx]) \
                and _skippable(mvs_xy, use, mbx, mby, n_mbx,
                               bool(col_zero[mby, mbx]), md)
            if cbp == 0 and direct_ok:
                skip_run += 1
                _zero_ctx(nz_y, nz_cb, nz_cr, mbx, mby)
                continue
            bw.ue(skip_run)                 # mb_skip_run
            skip_run = 0
            if direct_ok:
                bw.ue(0)                    # B_Direct_16x16: no ref / mvd
            else:
                bw.ue(_B_MBTYPE_FROM_MODE[md])
                for lst in range(2):
                    if not use[lst][mby, mbx]:
                        continue
                    pred = mv_pred_dec(mvs_xy[lst], use[lst], mbx, mby,
                                       n_mbx)
                    bw.se(int(mvs_xy[lst][mby, mbx, 0]) - pred[0])
                    bw.se(int(mvs_xy[lst][mby, mbx, 1]) - pred[1])
            bw.ue(CBP_INTER_TO_CODE[cbp])
            if cbp:
                bw.se(0)                    # mb_qp_delta
            _write_p_residual(bw, mbx, mby, cbp, luma[mby, mbx],
                              (cb_dc[mby, mbx], cr_dc[mby, mbx]),
                              (cb_ac[mby, mbx], cr_ac[mby, mbx]),
                              nz_y, nz_cb, nz_cr)
    if skip_run:
        bw.ue(skip_run)
    bw.rbsp_trailing_bits()
    return nal_unit(H.NAL_SLICE_NONIDR, bw.to_bytes(), nal_ref_idc=0)
