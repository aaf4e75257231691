"""ctypes bridge to the native H.264 reconstruction engine
(native/h264recon.cpp): full-picture inter prediction + residual, and
the sequential intra-MB queue of a CABAC slice; copy of
``vcp_tpu/codec/h264/native_recon.py``."""

from __future__ import annotations

import ctypes

import numpy as np

_I32P = ctypes.POINTER(ctypes.c_int32)
_I8P = ctypes.POINTER(ctypes.c_int8)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_PPTR = ctypes.POINTER(_I32P)


def _ptr(arr):
    return arr.ctypes.data_as(_I32P)


def _plane_ptrs(pics, idx):
    """Array of per-picture plane pointers for one component."""
    arr = (_I32P * max(1, len(pics)))()
    for i, planes in enumerate(pics):
        arr[i] = _ptr(planes[idx])
    return arr


def _pack_wt(wt, n):
    """Flatten a refpic.WeightTable: [llog2, clog2, (lw,lo,cw0,co0,
    cw1,co1) per ref]."""
    a = np.zeros(2 + 6 * n, np.int32)
    a[0], a[1] = wt.luma_log2, wt.chroma_log2
    for r in range(n):
        lw, lo = wt.luma[r]
        (cw0, co0), (cw1, co1) = wt.chroma[r]
        a[2 + 6 * r: 8 + 6 * r] = (lw, lo, cw0, co0, cw1, co1)
    return a


def recon_inter_native(ctx) -> None:
    """Reconstruct every inter MB of the current picture in place:
    per-list motion and reference indices on the 8x8 block grid,
    explicit (P) and implicit (B) weights, per-MB QP."""
    from ...native import get_lib
    lib = get_lib()
    y, u, v = ctx["y"], ctx["u"], ctx["v"]
    h, w = y.shape
    list0 = ctx["list0"]
    list1 = ctx.get("list1")
    n0, n1 = len(list0), len(list1) if list1 else 0
    is_b = list1 is not None

    inter = np.ascontiguousarray(ctx["mv_valid"]).view(np.uint8)
    t8g = ctx.get("p_t8")
    t8u = np.ascontiguousarray(t8g).view(np.uint8) if t8g is not None \
        else np.zeros(inter.shape, np.uint8)

    wt0, wt1 = ctx.get("wt0"), ctx.get("wt1")
    w0a = _pack_wt(wt0, n0) if wt0 is not None else None
    w1a = _pack_wt(wt1, n1) if (wt1 is not None and is_b) else None
    implicit = ctx.get("implicit_w")
    null_i32 = ctypes.cast(None, _I32P)
    null_pp = ctypes.cast(None, _PPTR)

    mv1 = ctx.get("mv8_l1")
    ref1 = ctx.get("ref8_l1")
    lib.vcp_recon_inter_frame(
        _plane_ptrs(list0, 0), _plane_ptrs(list0, 1), _plane_ptrs(list0, 2),
        n0,
        _plane_ptrs(list1, 0) if is_b else null_pp,
        _plane_ptrs(list1, 1) if is_b else null_pp,
        _plane_ptrs(list1, 2) if is_b else null_pp,
        n1,
        h, w,
        _ptr(ctx["mv8_l0"]),
        ctx["ref8_l0"].ctypes.data_as(_I8P),
        _ptr(mv1) if is_b else null_i32,
        ref1.ctypes.data_as(_I8P) if is_b else ctypes.cast(None, _I8P),
        inter.ctypes.data_as(_U8P),
        inter.shape[0], inter.shape[1],
        _ptr(ctx["p_z_luma"]), _ptr(ctx["p_cdc"]), _ptr(ctx["p_cac"]),
        t8u.ctypes.data_as(_U8P), _ptr(ctx["qp_mb"]),
        ctx["pp"].chroma_qp_index_offset,
        _ptr(w0a) if w0a is not None else null_i32,
        _ptr(w1a) if w1a is not None else null_i32,
        _ptr(implicit[0]) if implicit is not None else null_i32,
        _ptr(implicit[1]) if implicit is not None else null_i32,
        _ptr(y), _ptr(u), _ptr(v))


def recon_intra_native(y, u, v, n_mbx, res, chroma_qp_off) -> None:
    """Reconstruct the intra MBs of a native parse result
    (``res['_iq_raw']``) in parse order; raises ``DecodeError`` when a
    prediction mode needs a neighbour the picture lacks."""
    from ...native import get_lib
    lib = get_lib()
    count, iq_mb, iq_info, iq_modes, iq_dc = res["_iq_raw"]
    if count == 0:
        return
    h, w = y.shape
    rc = lib.vcp_recon_intra_mbs(
        _ptr(y), _ptr(u), _ptr(v), h, w, n_mbx,
        count, _ptr(iq_mb), _ptr(iq_info),
        iq_modes.ctypes.data_as(_I8P), _ptr(iq_dc),
        _ptr(res["z_luma"]), _ptr(res["cdc"]), _ptr(res["cac"]),
        chroma_qp_off)
    if rc != 0:
        from .decoder import DecodeError
        raise DecodeError("intra prediction from an unavailable neighbour")
