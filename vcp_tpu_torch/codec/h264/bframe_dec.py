"""The decode half of B slices for the host H.264 decoder (numpy);
copy of the decoder functions of ``vcp_tpu/codec/h264/bframe.py``:
spatial direct motion per 8x8 block (``b_direct_mb``), B_Skip, and the
CAVLC B macroblock parse (the full Table 7-14 tree with 8x8 subs,
multi-reference, per-MB qp_delta) into the decoder's defer arrays.
"""

from __future__ import annotations

from .tables import CBP_TABLE


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


def decode_b_mb_cavlc(ctx, mbx, mby, mb_type) -> None:
    """Parse one CAVLC B MB (full Table 7-14 incl. B_8x8 with 8x8 subs,
    multi-reference, per-MB qp_delta) into the defer arrays."""
    from . import mvpred
    from .decoder import DecodeError
    from .pframe_dec import parse_inter_residual_cavlc, read_ref_idx, set_part
    br = ctx["br"]
    sp = ctx["sp"]
    pp = ctx["pp"]
    nbx2 = 2 * sp.mb_width
    st = ((ctx["mv8_l0"], ctx["ref8_l0"], ctx["dec8"]),
          (ctx["mv8_l1"], ctx["ref8_l1"], ctx["dec8"]))
    n_act = (ctx.get("n_ref0", 1), ctx.get("n_ref1", 1))
    by0, bx0 = 2 * mby, 2 * mbx
    if mb_type == 0:                          # B_Direct_16x16
        b_direct_mb(ctx, mbx, mby)
        parts = []
    elif mb_type <= 3:                        # 16x16 L0/L1/Bi
        parts = [((by0, bx0, 2, 2, 0), mb_type)]
    elif mb_type <= 21:
        vert, m0, m1 = _B_TWO_PART[mb_type - 4]
        if vert:
            parts = [((by0, bx0, 1, 2, 0), m0), ((by0, bx0 + 1, 1, 2, 1), m1)]
        else:
            parts = [((by0, bx0, 2, 1, 0), m0), ((by0 + 1, bx0, 2, 1, 1), m1)]
    elif mb_type == 22:                       # B_8x8
        subs = []
        for q in range(4):
            s = br.ue()
            if s > 3:
                raise DecodeError(f"B sub_mb_type {s} (sub-8x8) "
                                  "unsupported")
            subs.append(s)
        parts = []
        for q, s in enumerate(subs):
            by, bx = by0 + (q >> 1), bx0 + (q & 1)
            if s == 0:
                b_direct_mb(ctx, mbx, mby, blocks=(q,))
            else:
                parts.append(((by, bx, 1, 1, q), _B_SUB_MODE[s]))
    else:
        raise DecodeError(f"B mb_type {mb_type} unsupported")

    if mb_type != 0:
        # syntax order (7.3.5.1): all ref_idx_l0, all ref_idx_l1, all
        # mvd_l0, all mvd_l1 — prediction/assignment happens per
        # partition in that per-list order
        refs = [[None, None] for _ in parts]
        for lst in range(2):
            for i, ((by, bx, pw, ph, pi), mode) in enumerate(parts):
                if mode & (1 << lst):
                    refs[i][lst] = read_ref_idx(br, n_act[lst])
        for lst in range(2):
            for i, ((by, bx, pw, ph, pi), mode) in enumerate(parts):
                if not mode & (1 << lst):
                    continue
                mvd_x, mvd_y = br.se(), br.se()
                pred = mvpred.mv_pred(*st[lst], by, bx, pw, ph,
                                      refs[i][lst], nbx2, part_idx=pi)
                set_part(ctx, by, bx, pw, ph, refs[i][lst],
                         (pred[0] + mvd_x, pred[1] + mvd_y), lst=lst)
        ctx["mv_valid"][mby, mbx] = True

    code = br.ue()
    cbp = CBP_TABLE[code][1]
    cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
    t8 = False
    # transform_size_8x8_flag presence (7.3.5): every partition >= 8x8
    # here by construction; direct MBs qualify via 8x8 inference
    if cbp_luma and pp.transform_8x8:
        t8 = bool(br.u(1))                    # transform_size_8x8_flag
        if "p_t8" in ctx:
            ctx["p_t8"][mby, mbx] = t8
    if cbp:
        delta = br.se()
        ctx["cur_qp"] = (ctx["cur_qp"] + delta + 52) % 52
    ctx["qp_mb"][mby, mbx] = ctx["cur_qp"]
    parse_inter_residual_cavlc(ctx, mbx, mby, cbp_luma, cbp_chroma, t8)
