"""General CABAC P / B slice parsing in Python; copy of
``vcp_tpu/codec/h264/inter_cabac.py``.

The Python twin of the inter half of the C++ parser
(``native/h264parse.cpp``), which the decoder runs under
``VCP_NO_NATIVE=1``. It parses every
macroblock shape libx264 emits at its default / medium presets: P
16x16 / 16x8 / 8x16 / P_8x8 with multi-reference ref_idx, the full B
mb_type tree (direct, all two-partition list combinations, B_8x8 with
per-sub direct / L0 / L1 / Bi), intra MBs inside P / B slices (I_NxN +
I16), per-MB mb_qp_delta, transform_size_8x8_flag and cabac_init_idc
0..2. Sub-8x8 partitions raise ``DecodeError``, as the C++ parser does.

It shares every context-increment derivation with ``cabac_syntax`` (one
``MbState``) and writes straight into the decoder's slice ctx (per-list
MVs and refIdx on the 8x8 grid, the deferred residual arrays, the cbf
grids the deblock reads). MV prediction and the direct derivation are
``mvpred``, ``pframe_dec`` and ``bframe_dec``, shared with the CAVLC
parser.
"""

from __future__ import annotations

import numpy as np

from .cabac import CabacDecoder
from . import bframe_dec as BF
from . import cabac_syntax as CS
from . import mvpred
from . import pframe_dec as PF
from .bframe_dec import _B_SUB_MODE, _B_TWO_PART
from .decoder import DecodeError


class _ParseError(DecodeError):
    pass


def _read_ref_idx(dec, cx, st, by, bx, lst):
    """ref_idx_lX: unary bins, ctx 54+inc / 58 / 59 (9.3.3.1.1.6)."""
    if not dec.decode(cx["ref_idx", st.ref_idx_ctx(by, bx, lst)]):
        return 0
    v = 1
    while dec.decode(cx["ref_idx", 4 if v == 1 else 5]):
        v += 1
        if v >= 32:
            raise _ParseError("ref_idx out of range")
    return v


def _parse_intra_mb(dec, cx, st, ctx, mbx, mby, i4g):
    """Intra MB inside a P/B slice, after the intra-prefix mb_type bin:
    I_NxN or Intra_16x16 (suffix contexts per slice type). Returns the
    parsed dict for the decoder's deferred intra recon queue."""
    pp = ctx["pp"]
    if dec.decode(cx["mbt_i", 0]) == 0:         # I_NxN
        parsed, delta = CS._parse_i_nxn(dec, cx, st, mbx, mby, i4g,
                                        pp.transform_8x8)
        ctx["cur_qp"] = (ctx["cur_qp"] + delta + 52) % 52
        parsed["qp"] = ctx["cur_qp"]
    else:
        if dec.decode_terminate():
            raise _ParseError("I_PCM unsupported in CABAC slices")
        cbp_l15 = dec.decode(cx["mbt_i_tail", 0])
        cbp_c = 0
        if dec.decode(cx["mbt_i_tail", 1]):
            cbp_c = 2 if dec.decode(cx["mbt_i_tail", 2]) else 1
        pred_mode = (dec.decode(cx["mbt_i_tail", 3]) << 1) | \
            dec.decode(cx["mbt_i_tail", 4])
        chroma_mode = CS._decode_chroma_mode(dec, cx, st, mbx, mby)
        st.intra[mby, mbx] = True
        st.chroma_mode[mby, mbx] = chroma_mode
        st.cbp_luma8[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = \
            1 if cbp_l15 else 0
        st.cbp_chroma[mby, mbx] = cbp_c
        ctx["cur_qp"] = (ctx["cur_qp"]
                         + CS._decode_qp_delta(dec, cx, st) + 52) % 52
        dc_zz, ac, cdc, cac = CS._mb_i16_residual(
            dec, cx, st, mbx, mby, encode=False,
            cbp_luma15=bool(cbp_l15), cbp_chroma=cbp_c)
        parsed = dict(pred_mode=pred_mode, chroma_mode=chroma_mode,
                      dc_zz=dc_zz, ac=ac, cdc=cdc, cac=cac,
                      qp=ctx["cur_qp"])
    ctx["intra_mb"][mby, mbx] = True
    ctx["mv_valid"][mby, mbx] = False
    ctx["dec8"][2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = True
    ctx["qp_mb"][mby, mbx] = ctx["cur_qp"]
    return parsed


def _decode_p_mb_type(dec, cx, st, mbx, mby):
    """P mb_type tree (Table 9-37): returns 0..3 or -1 for intra."""
    if dec.decode(cx["mbt_p", 0]):
        return -1
    if dec.decode(cx["mbt_p", 1]):
        return 1 if dec.decode(cx["mbt_p_alt", 0]) else 2
    return 3 if dec.decode(cx["mbt_p", 2]) else 0


def _decode_b_mb_type(dec, cx, st, mbx, mby):
    """B mb_type tree (Table 9-37): 0..22 or -1 for intra."""
    if not dec.decode(cx["mbt_b", st.mbt_b_ctx(mbx, mby)]):
        return 0                                # B_Direct_16x16
    if not dec.decode(cx["mbt_b_fix", 0]):
        return 1 + dec.decode(cx["mbt_b_fix", 2])
    bits = dec.decode(cx["mbt_b_fix", 1]) << 3
    bits |= dec.decode(cx["mbt_b_fix", 2]) << 2
    bits |= dec.decode(cx["mbt_b_fix", 2]) << 1
    bits |= dec.decode(cx["mbt_b_fix", 2])
    if bits < 8:
        return bits + 3
    if bits == 13:
        return -1                               # intra suffix follows
    if bits == 14:
        return 11
    if bits == 15:
        return 22                               # B_8x8
    bits = (bits << 1) | dec.decode(cx["mbt_b_fix", 2])
    return bits - 4


def _decode_p_sub_type(dec, cx):
    if dec.decode(cx["submbt_p", 0]):
        return 0                                # P_L0_8x8
    if not dec.decode(cx["submbt_p", 1]):
        return 1
    return 2 if dec.decode(cx["submbt_p", 2]) else 3


def _decode_b_sub_type(dec, cx):
    if not dec.decode(cx["submbt_b", 0]):
        return 0                                # B_Direct_8x8
    if not dec.decode(cx["submbt_b", 1]):
        return 1 + dec.decode(cx["submbt_b", 3])
    t = 3
    if dec.decode(cx["submbt_b", 2]):
        if dec.decode(cx["submbt_b", 3]):
            return 11 + dec.decode(cx["submbt_b", 3])
        t += 4
    t += 2 * dec.decode(cx["submbt_b", 3])
    t += dec.decode(cx["submbt_b", 3])
    return t


def parse_inter_slice_cabac(ctx, payload: bytes, qp: int, is_b: bool,
                            init_idc: int, intra_queue: list) -> None:
    """Parse one CABAC P or B slice payload into the decoder ctx; intra
    MBs go to ``intra_queue`` as (mbx, mby, parsed) in parse order, for
    the decoder's ``_recon_intra_mb``."""
    sp, pp = ctx["sp"], ctx["pp"]
    n_mby, n_mbx = sp.mb_height, sp.mb_width
    nbx2 = 2 * n_mbx
    dec = CabacDecoder(payload)
    cx = CS.H264CabacContexts(qp, slice_type="B" if is_b else "P",
                              init_idc=init_idc)
    st = CS.MbState(n_mby, n_mbx)
    i4g = np.full((4 * n_mby, 4 * n_mbx), -1, np.int8)
    n_act = (ctx.get("n_ref0", 1), ctx.get("n_ref1", 1))
    sts = ((ctx["mv8_l0"], ctx["ref8_l0"], ctx["dec8"]),)
    if is_b:
        sts = sts + ((ctx["mv8_l1"], ctx["ref8_l1"], ctx["dec8"]),)

    def parse_parts(mbx, mby, parts):
        """parts: list of ((by, bx, pw, ph, part_idx), list_mask).
        Syntax order 7.3.5.1: all ref_idx per list, then all mvd per
        list, assignment interleaved per partition."""
        refs = [[0, 0] for _ in parts]
        for lst in range(2 if is_b else 1):
            for i, ((by, bx, pw, ph, pi), mask) in enumerate(parts):
                if not mask & (1 << lst):
                    continue
                if n_act[lst] > 1:
                    refs[i][lst] = _read_ref_idx(dec, cx, st, by, bx, lst)
                st.refgt0[by:by + ph, bx:bx + pw, lst] = \
                    refs[i][lst] > 0
        for lst in range(2 if is_b else 1):
            for i, ((by, bx, pw, ph, pi), mask) in enumerate(parts):
                if not mask & (1 << lst):
                    continue
                mvd_x = CS._decode_mvd_comp(dec, cx, st, by, bx, 0, lst)
                mvd_y = CS._decode_mvd_comp(dec, cx, st, by, bx, 1, lst)
                st.set_absmvd(by, bx, ph, pw, lst,
                              (abs(mvd_x), abs(mvd_y)))
                pred = mvpred.mv_pred(*sts[lst], by, bx, pw, ph,
                                      refs[i][lst], nbx2, part_idx=pi)
                PF.set_part(ctx, by, bx, pw, ph, refs[i][lst],
                            (pred[0] + mvd_x, pred[1] + mvd_y), lst=lst)
        if parts:
            ctx["mv_valid"][mby, mbx] = True

    for mby in range(n_mby):
        for mbx in range(n_mbx):
            is_skip = dec.decode(cx["skip", st.skip_ctx(mbx, mby)])
            st.avail[mby, mbx] = True
            st.skip[mby, mbx] = bool(is_skip)
            by0, bx0 = 2 * mby, 2 * mbx
            if is_skip:
                st.cbp_luma8[by0:by0 + 2, bx0:bx0 + 2] = 0
                st.cbp_chroma[mby, mbx] = 0
                st.last_qp_delta = 0
                if is_b:
                    BF.decode_b_skip(ctx, mbx, mby)
                else:
                    PF.decode_pskip(dec, ctx, mbx, mby)
            else:
                mb_type = (_decode_b_mb_type(dec, cx, st, mbx, mby)
                           if is_b else
                           _decode_p_mb_type(dec, cx, st, mbx, mby))
                if mb_type < 0:                     # intra suffix
                    parsed = _parse_intra_mb(dec, cx, st, ctx, mbx, mby,
                                             i4g)
                    intra_queue.append((mbx, mby, parsed))
                    last = mby == n_mby - 1 and mbx == n_mbx - 1
                    if dec.decode_terminate() != (1 if last else 0):
                        raise _ParseError("CABAC MB count mismatch")
                    continue
                if not is_b:
                    if mb_type == 3:
                        for _ in range(4):
                            if _decode_p_sub_type(dec, cx) != 0:
                                raise _ParseError(
                                    "sub-8x8 P partitions unsupported")
                        parts = [(by0 + (q >> 1), bx0 + (q & 1), 1, 1, q)
                                 for q in range(4)]
                        parts = [(p, 1) for p in parts]
                    else:
                        parts = [((by0 + dy, bx0 + dx, pw, ph, i), 1)
                                 for i, (dy, dx, pw, ph) in
                                 enumerate(PF._P_PARTS[mb_type])]
                elif mb_type == 0:                  # B_Direct_16x16
                    st.bdirect[mby, mbx] = True
                    BF.b_direct_mb(ctx, mbx, mby)
                    parts = []
                elif mb_type <= 3:
                    parts = [((by0, bx0, 2, 2, 0), mb_type)]
                elif mb_type <= 21:
                    vert, m0, m1 = _B_TWO_PART[mb_type - 4]
                    if vert:
                        parts = [((by0, bx0, 1, 2, 0), m0),
                                 ((by0, bx0 + 1, 1, 2, 1), m1)]
                    else:
                        parts = [((by0, bx0, 2, 1, 0), m0),
                                 ((by0 + 1, bx0, 2, 1, 1), m1)]
                else:                               # B_8x8
                    parts = []
                    for q in range(4):
                        s = _decode_b_sub_type(dec, cx)
                        if s > 3:
                            raise _ParseError(
                                "sub-8x8 B partitions unsupported")
                        by, bx = by0 + (q >> 1), bx0 + (q & 1)
                        if s == 0:
                            BF.b_direct_mb(ctx, mbx, mby, blocks=(q,))
                        else:
                            parts.append(((by, bx, 1, 1, q),
                                          _B_SUB_MODE[s]))
                parse_parts(mbx, mby, parts)
                if is_b and mb_type in (0, 22):
                    ctx["mv_valid"][mby, mbx] = True

                cbp = CS._decode_cbp(dec, cx, st, mbx, mby)
                cbp_l, cbp_c = cbp & 15, cbp >> 4
                t8f = False
                if cbp_l > 0 and pp.transform_8x8:
                    t8f = bool(dec.decode(cx["t8flag",
                                             st.t8_ctx(mbx, mby)]))
                st.t8[mby, mbx] = t8f
                ctx["p_t8"][mby, mbx] = t8f
                if cbp:
                    delta = CS._decode_qp_delta(dec, cx, st)
                    ctx["cur_qp"] = (ctx["cur_qp"] + delta + 52) % 52
                else:
                    st.last_qp_delta = 0
                ctx["qp_mb"][mby, mbx] = ctx["cur_qp"]
                luma, cdc, cac = CS._p_residual(
                    dec, cx, st, mbx, mby, encode=False,
                    cbp_l=cbp_l, cbp_c=cbp_c, t8=t8f)
                ctx["p_z_luma"][mby, mbx] = luma
                ctx["p_cdc"][mby, mbx] = cdc
                ctx["p_cac"][mby, mbx] = cac
            last = mby == n_mby - 1 and mbx == n_mbx - 1
            if dec.decode_terminate() != (1 if last else 0):
                raise _ParseError("CABAC MB count mismatch")

    # cbf grids double as the deblock residual-presence source (counts
    # are only needed for CAVLC nC contexts)
    ctx["nz_y"].nz[:, :] = st.cbf_l4
    ctx["nz_cb"].nz[:, :] = st.cbf_c4[0]
    ctx["nz_cr"].nz[:, :] = st.cbf_c4[1]
    ctx["p_t8"] |= st.t8          # covers I_NxN-8x8 MBs (deblock edges)
