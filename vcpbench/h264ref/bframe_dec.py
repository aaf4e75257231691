"""The decode half of B slices for the host H.264 decoder (numpy);
copy of the decoder functions of ``vcp_tpu/codec/h264/bframe.py``:
spatial direct motion per 8x8 block (``b_direct_mb``) and B_Skip, into
the decoder's defer arrays (the CABAC parse is ``inter_cabac``'s).
"""

from __future__ import annotations


def _zero_nz(nz_y, nz_cb, nz_cr, mbx, mby):
    nz_y.nz[4 * mby:4 * mby + 4, 4 * mbx:4 * mbx + 4] = 0
    nz_cb.nz[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = 0
    nz_cr.nz[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = 0


# Table 7-14 two-partition B mb_types 4..21: (vertical split?, mode0,
# mode1) with modes as list-usage masks bit0=L0, bit1=L1
_B_TWO_PART = [
    (False, 1, 1), (True, 1, 1),     # B_L0_L0_16x8 / 8x16
    (False, 2, 2), (True, 2, 2),     # B_L1_L1
    (False, 1, 2), (True, 1, 2),     # B_L0_L1
    (False, 2, 1), (True, 2, 1),     # B_L1_L0
    (False, 1, 3), (True, 1, 3),     # B_L0_Bi
    (False, 2, 3), (True, 2, 3),     # B_L1_Bi
    (False, 3, 1), (True, 3, 1),     # B_Bi_L0
    (False, 3, 2), (True, 3, 2),     # B_Bi_L1
    (False, 3, 3), (True, 3, 3),     # B_Bi_Bi
]
# Table 7-18 B sub_mb_type 0..3 (sub-8x8 shapes 4..12 unsupported):
# list-usage mask; 0 = B_Direct_8x8
_B_SUB_MODE = (0, 1, 2, 3)


def b_direct_mb(ctx, mbx, mby, blocks=(0, 1, 2, 3)):
    """Spatial direct motion (8.4.1.2.2) for the given 8x8 blocks of one
    MB: MB-level refIdx/MV derivation + per-block colZero override from
    the colocated picture (RefPicList1[0], direct_8x8_inference
    granularity). Assigns the blocks' per-list state."""
    from . import mvpred
    from .pframe_dec import set_part
    sp = ctx["sp"]
    nbx2 = 2 * sp.mb_width
    st0 = (ctx["mv8_l0"], ctx["ref8_l0"], ctx["dec8"])
    st1 = (ctx["mv8_l1"], ctx["ref8_l1"], ctx["dec8"])
    ref0, ref1, mv0, mv1, zero = mvpred.direct_spatial_refs(
        st0, st1, mby, mbx, nbx2)
    col = ctx.get("col")
    for q in blocks:
        by, bx = 2 * mby + (q >> 1), 2 * mbx + (q & 1)
        m0, m1 = mv0, mv1
        if not zero and col is not None and col.col_ref0 is not None:
            colzero = (bool(col.col_ref0[by, bx])
                       and abs(int(col.col_mv8[by, bx, 0])) <= 1
                       and abs(int(col.col_mv8[by, bx, 1])) <= 1)
            if colzero:
                if ref0 == 0:
                    m0 = (0, 0)
                if ref1 == 0:
                    m1 = (0, 0)
        if ref0 >= 0:
            set_part(ctx, by, bx, 1, 1, ref0, m0, lst=0)
        if ref1 >= 0:
            set_part(ctx, by, bx, 1, 1, ref1, m1, lst=1)
        ctx["dec8"][by, bx] = True
    ctx["mv_valid"][mby, mbx] = True


def decode_b_skip(ctx, mbx, mby) -> None:
    """Parse-time half of a B_Skip MB: spatial-direct motion, zero
    residual. Recon is deferred (order-independent)."""
    b_direct_mb(ctx, mbx, mby)
    ctx["qp_mb"][mby, mbx] = ctx["cur_qp"]
    _zero_nz(ctx["nz_y"], ctx["nz_cb"], ctx["nz_cr"], mbx, mby)


