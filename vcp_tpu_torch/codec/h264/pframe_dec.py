"""The decode half of P slices for the host H.264 decoder (numpy);
copy of the decoder functions of ``vcp_tpu/codec/h264/pframe.py``.

The general CAVLC P macroblock parse (any partitioning down to 8x8,
multi-reference) and the CAVLC inter residual walk shared with B
slices. Parse fills the decoder's per-frame defer arrays; the native
reconstruction (``native_recon``) reads them for the whole picture.
"""

from __future__ import annotations

import numpy as np

from .cavlc import decode_residual_block
from .cavlc_writer import CHROMA_BLK_ORDER
from .frame_ops import LUMA_BLK_ORDER
from .tables import CBP_TABLE


def set_part(ctx, by, bx, pw, ph, ref, mv, lst=0):
    """Record one partition's (refIdx, mv) over its 8x8-block footprint
    and mark the blocks decoded."""
    sfx = "_l0" if lst == 0 else "_l1"
    ctx["mv8" + sfx][by:by + ph, bx:bx + pw] = mv
    ctx["ref8" + sfx][by:by + ph, bx:bx + pw] = ref
    ctx["dec8"][by:by + ph, bx:bx + pw] = True


def read_ref_idx(br, n_active: int) -> int:
    """ref_idx_lX as te(v): single bit inverted when two refs are
    active, ue(v) beyond (9.1.1)."""
    if n_active <= 1:
        return 0
    if n_active == 2:
        return 1 - br.u(1)
    return br.ue()


def decode_pskip(dec, ctx, mbx, mby):
    """Parse-time half of a skipped MB: derive the skip MV (refIdx 0)
    and zero the nC context. Recon is deferred (order-independent)."""
    from . import mvpred
    sp = ctx["sp"]
    mv = mvpred.p_skip_mv(ctx["mv8_l0"], ctx["ref8_l0"], ctx["dec8"],
                          mby, mbx, 2 * sp.mb_width)
    set_part(ctx, 2 * mby, 2 * mbx, 2, 2, 0, mv)
    ctx["mvs"][mby, mbx] = mv
    ctx["mv_valid"][mby, mbx] = True
    ctx["qp_mb"][mby, mbx] = ctx["cur_qp"]
    ctx["nz_y"].nz[4 * mby:4 * mby + 4, 4 * mbx:4 * mbx + 4] = 0
    ctx["nz_cb"].nz[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = 0
    ctx["nz_cr"].nz[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = 0


# (pw, ph, part positions) per P mb_type 0..2 on the 8x8 grid
_P_PARTS = {
    0: ((0, 0, 2, 2),),                        # P_L0_16x16
    1: ((0, 0, 2, 1), (1, 0, 2, 1)),           # P_L0_L0_16x8
    2: ((0, 0, 1, 2), (0, 1, 1, 2)),           # P_L0_L0_8x16
}


def decode_inter_mb(dec, ctx, mbx, mby, mb_type):
    """Parse-time half of a P macroblock (any partitioning down to 8x8,
    multi-reference): ref_idx + MVD + residual levels into the per-frame
    defer arrays; recon runs for the whole picture in native_recon."""
    from . import mvpred
    from .decoder import DecodeError
    br = ctx["br"]
    sp = ctx["sp"]
    pp = ctx["pp"]
    nbx2 = 2 * sp.mb_width
    st = (ctx["mv8_l0"], ctx["ref8_l0"], ctx["dec8"])
    n0 = ctx.get("n_ref0", 1)
    by0, bx0 = 2 * mby, 2 * mbx
    if mb_type in (3, 4):                     # P_8x8 / P_8x8ref0
        for _ in range(4):
            sub = br.ue()
            if sub != 0:
                raise DecodeError(f"sub_mb_type {sub} (sub-8x8 "
                                  "partitions) unsupported")
        refs = [0] * 4
        if mb_type == 3:
            refs = [read_ref_idx(br, n0) for _ in range(4)]
        for q in range(4):
            by, bx = by0 + (q >> 1), bx0 + (q & 1)
            mvd_x, mvd_y = br.se(), br.se()
            pred = mvpred.mv_pred(*st, by, bx, 1, 1, refs[q], nbx2)
            set_part(ctx, by, bx, 1, 1, refs[q],
                     (pred[0] + mvd_x, pred[1] + mvd_y))
    elif mb_type in _P_PARTS:
        parts = _P_PARTS[mb_type]
        refs = [read_ref_idx(br, n0) for _ in parts]
        for i, (dy, dx, pw, ph) in enumerate(parts):
            mvd_x, mvd_y = br.se(), br.se()
            pred = mvpred.mv_pred(*st, by0 + dy, bx0 + dx, pw, ph,
                                  refs[i], nbx2, part_idx=i)
            set_part(ctx, by0 + dy, bx0 + dx, pw, ph, refs[i],
                     (pred[0] + mvd_x, pred[1] + mvd_y))
    else:
        raise DecodeError(f"P mb_type {mb_type} unsupported")
    ctx["mvs"][mby, mbx] = ctx["mv8_l0"][by0, bx0]
    ctx["mv_valid"][mby, mbx] = True
    code = br.ue()
    cbp = CBP_TABLE[code][1]
    cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
    t8 = False
    if cbp_luma and pp.transform_8x8:
        t8 = bool(br.u(1))                    # transform_size_8x8_flag
        if "p_t8" in ctx:
            ctx["p_t8"][mby, mbx] = t8
    if cbp:
        delta = br.se()
        ctx["cur_qp"] = (ctx["cur_qp"] + delta + 52) % 52
    ctx["qp_mb"][mby, mbx] = ctx["cur_qp"]
    parse_inter_residual_cavlc(ctx, mbx, mby, cbp_luma, cbp_chroma, t8)


def parse_inter_residual_cavlc(ctx, mbx, mby, cbp_luma, cbp_chroma, t8):
    """CAVLC residual of one inter MB into the defer arrays (shared by
    P and B slices)."""
    br = ctx["br"]
    z_luma = ctx["p_z_luma"][mby, mbx]
    nz_y = ctx["nz_y"]
    if t8:
        # CAVLC 8x8 transport (spec 8.5.6): four interleaved 4x4 blocks
        # per 8x8; sub-block k carries scan positions 4*i + k. Each is a
        # normal CAVLC block at its 4x4 position (nC context included);
        # the merged 64-scan lands in z_luma rows 4*b8..4*b8+4.
        for b8 in range(4):
            subs = np.zeros((4, 16), np.int64)
            for k in range(4):
                blk = 4 * b8 + k
                oy = int(LUMA_BLK_ORDER[blk, 0])
                ox = int(LUMA_BLK_ORDER[blk, 1])
                by, bx = 4 * mby + oy, 4 * mbx + ox
                total = 0
                if cbp_luma & (1 << b8):
                    coeffs = decode_residual_block(br, nz_y.nc(by, bx), 16)
                    subs[k] = coeffs
                    total = int(np.count_nonzero(coeffs))
                nz_y.nz[by, bx] = total
            scan64 = subs.T.reshape(64)       # scan[4*i + k] = subs[k][i]
            z_luma[4 * b8:4 * b8 + 4] = scan64.reshape(4, 16)
    else:
        for blk in range(16):
            oy, ox = int(LUMA_BLK_ORDER[blk, 0]), int(LUMA_BLK_ORDER[blk, 1])
            by, bx = 4 * mby + oy, 4 * mbx + ox
            total = 0
            if cbp_luma & (1 << (blk // 4)):
                coeffs = decode_residual_block(br, nz_y.nc(by, bx), 16)
                z_luma[blk] = coeffs
                total = int(np.count_nonzero(coeffs))
            nz_y.nz[by, bx] = total
    cdc = ctx["p_cdc"][mby, mbx]
    cac = ctx["p_cac"][mby, mbx]
    if cbp_chroma:
        for c in range(2):
            cdc[c] = decode_residual_block(br, -1, 4)
    for c, nzc in ((0, ctx["nz_cb"]), (1, ctx["nz_cr"])):
        for blk in range(4):
            oy, ox = int(CHROMA_BLK_ORDER[blk, 0]), int(CHROMA_BLK_ORDER[blk, 1])
            by, bx = 2 * mby + oy, 2 * mbx + ox
            total = 0
            if cbp_chroma == 2:
                coeffs = decode_residual_block(br, nzc.nc(by, bx), 15)
                cac[c, blk, 1:] = coeffs
                total = int(np.count_nonzero(coeffs))
            nzc.nz[by, bx] = total


# raster (oy, ox) grid → coding-order block index, for scattering batched
# residuals back into plane layout
_BLK_GRID = np.zeros((4, 4), np.int64)
_BLK_GRID[LUMA_BLK_ORDER[:, 0], LUMA_BLK_ORDER[:, 1]] = np.arange(16)
