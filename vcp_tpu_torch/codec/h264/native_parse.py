"""ctypes bridge to the native CABAC slice parser (native/h264parse.cpp);
copy of ``vcp_tpu/codec/h264/native_parse.py``.

The C++ parser fills the decoder's defer arrays directly; this module
owns the buffer plumbing. A stream that uses what the parser rejects
(sub-8x8 partitions, I_PCM in a CABAC slice) or that is corrupt raises
``DecodeError``."""

from __future__ import annotations

import ctypes

import numpy as np

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I8P = ctypes.POINTER(ctypes.c_int8)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _p(arr, ptr_t):
    return arr.ctypes.data_as(ptr_t)


# the parser's negative return codes (native/h264parse.cpp)
_ERRORS = {
    -1: "sub-8x8 partitions unsupported in CABAC slices",
    -2: "I_PCM unsupported in CABAC slices",
    -3: "CABAC MB count mismatch",
    -4: "ref_idx out of range",
}


def parse_slice_native(payload: bytes, qp: int, kind: int, init_idc: int,
                       n_mby: int, n_mbx: int, pps_t8: bool,
                       n_ref0: int = 1, n_ref1: int = 1,
                       col_ref0=None, col_mv8=None):
    """Run the native parser. kind: 0=P, 1=B, 2=I.

    Returns a dict of output arrays plus ``_iq_raw``, the intra queue in
    parse order for ``native_recon.recon_intra_native``; raises
    ``DecodeError`` on a slice the parser rejects.
    """
    from ...native import get_lib
    lib = get_lib()

    n_mb = n_mby * n_mbx
    nby2, nbx2 = 2 * n_mby, 2 * n_mbx
    out = dict(
        mv8_l0=np.zeros((nby2, nbx2, 2), np.int32),
        ref8_l0=np.full((nby2, nbx2), -1, np.int8),
        mv8_l1=np.zeros((nby2, nbx2, 2), np.int32),
        ref8_l1=np.full((nby2, nbx2), -1, np.int8),
        dec8=np.zeros((nby2, nbx2), np.uint8),
        intra_mb=np.zeros((n_mby, n_mbx), np.uint8),
        mv_valid=np.zeros((n_mby, n_mbx), np.uint8),
        qp_mb=np.zeros((n_mby, n_mbx), np.int32),
        p_t8=np.zeros((n_mby, n_mbx), np.uint8),
        z_luma=np.zeros((n_mby, n_mbx, 16, 16), np.int32),
        cdc=np.zeros((n_mby, n_mbx, 2, 4), np.int32),
        cac=np.zeros((n_mby, n_mbx, 2, 4, 16), np.int32),
        cbf_l4=np.zeros((4 * n_mby, 4 * n_mbx), np.int8),
        cbf_cb=np.zeros((nby2, nbx2), np.int8),
        cbf_cr=np.zeros((nby2, nbx2), np.int8),
    )
    iq_mb = np.zeros(n_mb, np.int32)
    iq_info = np.zeros((n_mb, 4), np.int32)
    iq_modes = np.zeros((n_mb, 16), np.int8)
    iq_dc = np.zeros((n_mb, 16), np.int32)

    if col_ref0 is not None:
        cr0 = np.ascontiguousarray(col_ref0, np.uint8)
        cmv = np.ascontiguousarray(col_mv8, np.int32)
        cr0_p, cmv_p = _p(cr0, _U8P), _p(cmv, _I32P)
    else:
        cr0_p = ctypes.cast(None, _U8P)
        cmv_p = ctypes.cast(None, _I32P)

    buf = np.frombuffer(payload, np.uint8)
    rc = lib.vcp_parse_slice_cabac(
        _p(buf, _U8P), len(payload),
        kind, qp, init_idc, n_mby, n_mbx,
        1 if pps_t8 else 0, n_ref0, n_ref1,
        cr0_p, cmv_p,
        _p(out["mv8_l0"], _I32P), _p(out["ref8_l0"], _I8P),
        _p(out["mv8_l1"], _I32P), _p(out["ref8_l1"], _I8P),
        _p(out["dec8"], _U8P),
        _p(out["intra_mb"], _U8P), _p(out["mv_valid"], _U8P),
        _p(out["qp_mb"], _I32P), _p(out["p_t8"], _U8P),
        _p(out["z_luma"], _I32P), _p(out["cdc"], _I32P),
        _p(out["cac"], _I32P),
        _p(out["cbf_l4"], _I8P), _p(out["cbf_cb"], _I8P),
        _p(out["cbf_cr"], _I8P),
        _p(iq_mb, _I32P), _p(iq_info, _I32P), _p(iq_modes, _I8P),
        _p(iq_dc, _I32P))
    if rc < 0:
        from .decoder import DecodeError
        raise DecodeError(_ERRORS.get(int(rc), f"CABAC parse error {rc}"))
    out["_iq_raw"] = (int(rc), iq_mb, iq_info, iq_modes, iq_dc)
    return out


def parse_inter_slice(ctx, payload: bytes, qp: int, is_b: bool,
                      init_idc: int) -> dict:
    """Parse one CABAC P or B slice payload into the decoder's slice
    ctx. Returns the parse result, whose raw intra queue the native
    intra recon reads."""
    sp, pp = ctx["sp"], ctx["pp"]
    col = ctx.get("col")
    use_col = is_b and col is not None and col.col_ref0 is not None
    res = parse_slice_native(
        payload, qp, 1 if is_b else 0, init_idc,
        sp.mb_height, sp.mb_width, pp.transform_8x8,
        ctx.get("n_ref0", 1), ctx.get("n_ref1", 1),
        col.col_ref0 if use_col else None,
        col.col_mv8 if use_col else None)
    ctx["mv8_l0"][:] = res["mv8_l0"]
    ctx["ref8_l0"][:] = res["ref8_l0"]
    if is_b:
        ctx["mv8_l1"][:] = res["mv8_l1"]
        ctx["ref8_l1"][:] = res["ref8_l1"]
    ctx["dec8"][:] = res["dec8"].astype(bool)
    ctx["intra_mb"][:] = res["intra_mb"].astype(bool)
    ctx["mv_valid"][:] = res["mv_valid"].astype(bool)
    ctx["qp_mb"][:] = res["qp_mb"]
    ctx["p_z_luma"][:] = res["z_luma"]
    ctx["p_cdc"][:] = res["cdc"]
    ctx["p_cac"][:] = res["cac"]
    ctx["p_t8"][:] = res["p_t8"].astype(bool)
    ctx["nz_y"].nz[:, :] = res["cbf_l4"]
    ctx["nz_cb"].nz[:, :] = res["cbf_cb"]
    ctx["nz_cr"].nz[:, :] = res["cbf_cr"]
    return res
