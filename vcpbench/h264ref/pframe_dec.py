"""The decode half of P slices for the host H.264 decoder (numpy);
copy of the decoder functions of ``vcp_tpu/codec/h264/pframe.py``.

The P_Skip motion derivation and the partition bookkeeping that the
CABAC parse (``inter_cabac``) shares; parse fills the decoder's
per-frame defer arrays, which ``inter_recon`` reads for the picture.
"""

from __future__ import annotations

import numpy as np

from .consts import LUMA_BLK_ORDER


def set_part(ctx, by, bx, pw, ph, ref, mv, lst=0):
    """Record one partition's (refIdx, mv) over its 8x8-block footprint
    and mark the blocks decoded."""
    sfx = "_l0" if lst == 0 else "_l1"
    ctx["mv8" + sfx][by:by + ph, bx:bx + pw] = mv
    ctx["ref8" + sfx][by:by + ph, bx:bx + pw] = ref
    ctx["dec8"][by:by + ph, bx:bx + pw] = True


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


# raster (oy, ox) grid → coding-order block index, for scattering batched
# residuals back into plane layout
_BLK_GRID = np.zeros((4, 4), np.int64)
_BLK_GRID[LUMA_BLK_ORDER[:, 0], LUMA_BLK_ORDER[:, 1]] = np.arange(16)
