"""Host entropy coding: CABAC slice writers for the main path.

Copies of ``vcp_tpu``'s native CABAC routes: ``write_islice`` for an IDR
of I16x16 MBs, with the row pattern or with per-MB modes, or of I16x16
mixed with I_NxN / transform-8x8 MBs (``vcp_tpu/codec/h264/entropy.py``
with ``cabac=True``), and ``write_pslice`` for a P slice of P_L0_16x16 +
P_Skip MBs, with the per-MB transform_size_8x8 flag when the PPS turns
the 8x8 transform on (``vcp_tpu/codec/h264/pframe.py`` with
``cabac=True``, no partitions, no intra MBs). Both run the C++ writers
in ``vcp_tpu_torch.native`` and wrap the RBSP into an Annex-B NAL.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ... import native
from . import headers as H

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _nal(lib, rbsp_buf: np.ndarray, rbsp_len: int, nal_type: int,
         nal_ref_idc: int) -> bytes:
    out = np.empty(rbsp_len + rbsp_len // 2 + 16, np.uint8)
    n = lib.vcp_escape(rbsp_buf.ctypes.data_as(_U8P), rbsp_len,
                       out.ctypes.data_as(_U8P))
    return (b"\x00\x00\x01" + bytes([(nal_ref_idc << 5) | nal_type])
            + out[:n].tobytes())


def write_islice(sp: H.SeqParams, pp: H.PicParams, *, frame_num: int,
                 idr_pic_id: int, qp: int, data: dict,
                 deblock: bool = False, poc_lsb: int = 0) -> bytes:
    """One CABAC IDR slice NAL from the level arrays of ``encode_iframe``
    or ``encode_iframe_rd8``. Without "modes" in ``data`` MB row 0 is
    I16x16-DC and rows 1.. I16x16-V; with "modes" / "cmodes" every MB
    carries its own; with an "i8" grid that flags any MB, those MBs are
    I_NxN with the 8x8 transform ("i8_modes", "i8_luma")."""
    if not pp.cabac:
        raise ValueError("pp.cabac must match the slice entropy mode")
    lib = native.get_lib()
    n_mby, n_mbx = sp.mb_height, sp.mb_width
    cap = n_mby * n_mbx * 2048 + 4096
    out = np.empty(cap, np.uint8)
    head = (n_mby, n_mbx, qp, pp.init_qp, sp.log2_max_frame_num,
            frame_num, idr_pic_id, 0 if deblock else 1,
            sp.log2_max_poc_lsb if sp.poc_type == 0 else 0, poc_lsb)
    luma_ac = data["luma_ac"]
    i8 = data.get("i8")
    has_i8 = i8 is not None and bool(np.any(i8))
    if has_i8:
        # the writer reads an i8 MB's 4x64 scans from its luma_ac slot
        i8 = np.ascontiguousarray(i8, np.uint8)
        luma_ac = np.where(
            i8[..., None].astype(bool),
            np.asarray(data["i8_luma"]).reshape(n_mby, n_mbx, 256),
            np.asarray(luma_ac).reshape(n_mby, n_mbx, 256))
    arrs = [np.ascontiguousarray(a, np.int32) for a in
            (data["luma_dc"], luma_ac, data["cb_dc"], data["cb_ac"],
             data["cr_dc"], data["cr_ac"])]
    if data.get("modes") is not None:
        arrs += [np.ascontiguousarray(data[k], np.int32)
                 for k in ("modes", "cmodes")]
    ptrs = [a.ctypes.data_as(_I32P) for a in arrs]
    tail = (out.ctypes.data_as(_U8P), cap)
    if has_i8:
        i8_modes = np.ascontiguousarray(data["i8_modes"], np.int32)
        n = lib.vcp_write_islice_cabac_i8(
            *head, *ptrs, i8.ctypes.data_as(_U8P),
            i8_modes.ctypes.data_as(_I32P), *tail)
    else:
        if len(ptrs) == 6:
            ptrs += [_I32P(), _I32P()]
        n = lib.vcp_write_islice_cabac(*head, *ptrs, *tail)
    if n < 0:
        raise RuntimeError("native cabac islice buffer overflow")
    return _nal(lib, out, int(n), H.NAL_SLICE_IDR, 3)


def write_pslice(sp: H.SeqParams, pp: H.PicParams, *, frame_num: int,
                 qp: int, data: dict, deblock: bool = False,
                 poc_lsb: int = 0) -> bytes:
    """One CABAC P slice NAL from an ``unpack_sparse_chunk`` dict (mv in
    quarter-pel [dy, dx]; ``active`` marks the MBs present in the dense
    arrays, the rest are P_Skip). When the PPS has the 8x8 transform on,
    every MB with luma residual codes its transform_size_8x8 flag from
    the optional ``t8`` grid (absent = all 4x4)."""
    if not pp.cabac:
        raise ValueError("pp.cabac must match the slice entropy mode")
    lib = native.get_lib()
    n_mby, n_mbx = sp.mb_height, sp.mb_width
    mv = np.asarray(data["mv"])
    mv_xy = np.ascontiguousarray(
        np.stack([mv[..., 1], mv[..., 0]], axis=-1), np.int32)
    arrs = [np.ascontiguousarray(data[k], np.int32)
            for k in ("luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")]
    act = data.get("active")
    act = None if act is None else np.ascontiguousarray(act, np.uint8)
    cap = n_mby * n_mbx * 2048 + 4096
    out = np.empty(cap, np.uint8)
    head = (n_mby, n_mbx, qp, pp.init_qp, sp.log2_max_frame_num, frame_num,
            0 if deblock else 1,
            sp.log2_max_poc_lsb if sp.poc_type == 0 else 0, poc_lsb,
            _U8P() if act is None else act.ctypes.data_as(_U8P))
    tail = (*[a.ctypes.data_as(_I32P) for a in (mv_xy, *arrs)],
            out.ctypes.data_as(_U8P), cap)
    if pp.transform_8x8:
        t8 = data.get("t8")
        t8 = np.ascontiguousarray(
            np.zeros((n_mby, n_mbx), bool) if t8 is None else t8, np.uint8)
        n = lib.vcp_write_pslice_cabac_t8(
            *head, t8.ctypes.data_as(_U8P), *tail)
    else:
        if data.get("t8") is not None:
            raise ValueError("t8 macroblocks need pp.transform_8x8")
        n = lib.vcp_write_pslice_cabac(*head, *tail)
    if n < 0:
        raise RuntimeError("native cabac pslice buffer overflow")
    return _nal(lib, out, int(n), H.NAL_SLICE_NONIDR, 2)
