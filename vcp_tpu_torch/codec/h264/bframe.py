"""B slice host entropy.

Port of ``write_bslice`` of ``vcp_tpu/codec/h264/bframe.py``: B pictures
between P anchors, one reference per list (L0 = past anchor, L1 = future
anchor), mb types B_L0_16x16 / B_L1_16x16 / B_Bi_16x16 with explicit
MVs, B_Skip / B_Direct_16x16 by spatial direct prediction, non-reference
(nal_ref_idc 0). A CABAC slice runs the C++ writer
``vcp_write_bslice_cabac`` in ``vcp_tpu_torch.native`` (under
``VCP_NO_NATIVE=1`` its Python twin ``cabac_syntax.write_bslice_cabac``),
a CAVLC slice the Python writer ``cavlc_writer.write_bslice``, as in
``vcp_tpu``.
"""

from __future__ import annotations

import numpy as np

from ... import native
from . import cavlc_writer
from . import headers as H
from .entropy import _I32P, _U8P, _nal, _xy, levels


def write_bslice(sp: H.SeqParams, pp: H.PicParams, *, frame_num: int,
                 qp: int, data: dict, deblock: bool = False,
                 poc_lsb: int = 0) -> bytes:
    """One B slice NAL in the PPS's entropy mode. data: "mv0" / "mv1"
    (nMBy, nMBx, 2) [dy, dx] quarter-pel, "mode" (nMBy, nMBx) with 0 = L0
    / 1 = L1 / 2 = Bi, the level arrays as for P, and optionally the
    colocated anchor's "col_zero" grid (colZeroFlag, default all False)
    and "col_safe" grid (MBs where B_Skip may be chosen, default all
    True)."""
    if not pp.cabac:
        return cavlc_writer.write_bslice(sp, pp, frame_num=frame_num, qp=qp,
                                         data=data, deblock=deblock,
                                         poc_lsb=poc_lsb)
    if native.disabled():
        from .cabac_syntax import write_bslice_cabac
        return write_bslice_cabac(sp, pp, frame_num=frame_num, qp=qp,
                                  data=data, deblock=deblock,
                                  poc_lsb=poc_lsb)
    lib = native.get_lib()
    n_mby, n_mbx = sp.mb_height, sp.mb_width
    mode = np.ascontiguousarray(data["mode"], np.int32)
    mv0, mv1 = _xy(data["mv0"]), _xy(data["mv1"])
    col_zero = np.ascontiguousarray(
        data.get("col_zero", np.zeros((n_mby, n_mbx), bool)), np.uint8)
    col_safe = np.ascontiguousarray(
        data.get("col_safe", np.ones((n_mby, n_mbx), bool)), np.uint8)
    lv = levels(data)
    cap = n_mby * n_mbx * 2048 + 4096
    out = np.empty(cap, np.uint8)
    n = lib.vcp_write_bslice_cabac(
        n_mby, n_mbx, qp, pp.init_qp, sp.log2_max_frame_num, frame_num,
        0 if deblock else 1,
        sp.log2_max_poc_lsb if sp.poc_type == 0 else 0, poc_lsb,
        1 if pp.transform_8x8 else 0,
        mv0.ctypes.data_as(_I32P), mv1.ctypes.data_as(_I32P),
        mode.ctypes.data_as(_I32P),
        col_zero.ctypes.data_as(_U8P), col_safe.ctypes.data_as(_U8P),
        *[a.ctypes.data_as(_I32P) for a in lv],
        out.ctypes.data_as(_U8P), cap)
    if n < 0:
        raise RuntimeError("native cabac bslice buffer overflow")
    return _nal(lib, out, int(n), H.NAL_SLICE_NONIDR, 0)
