"""Host entropy coding: the I and P slice writers of the main path.

Copies of ``vcp_tpu``'s routes, chosen by the PPS's entropy mode.
``write_islice`` writes an IDR of I16x16 MBs, with the row pattern or
with per-MB modes, or (CABAC) of I16x16 mixed with I_NxN /
transform-8x8 MBs (``vcp_tpu/codec/h264/entropy.py``), and
``write_pslice`` a P slice (``vcp_tpu/codec/h264/pframe.py``):
P_L0_16x16 + P_Skip MBs, with the per-MB transform_size_8x8 flag when
the PPS turns the 8x8 transform on, partitioned MBs (16x8 / 8x16 /
P_8x8) on the 8x8 MV grid, and (CABAC) intra MBs (I16x16 / I_NxN) among
them. The CABAC slices and the CAVLC IDR and P slices of 16x16 MBs with
the 4x4 transform run the C++ writers in ``vcp_tpu_torch.native``; the
other CAVLC P slices run the Python writer of ``cavlc_writer``, as in
``vcp_tpu``. Under ``VCP_NO_NATIVE=1`` every slice takes its Python
writer instead, as in ``vcp_tpu``: ``cabac_syntax`` for CABAC,
``_write_islice_py`` for the CAVLC IDR and ``cavlc_writer`` for every
CAVLC P slice. Each returns an Annex-B NAL.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ... import native
from ...utils.bitstream import BitWriter, emulation_prevent, nal_unit
from . import cavlc_writer
from . import headers as H
from .cavlc import encode_residual_block
from .frame_ops import LUMA_BLK_ORDER

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)

# the I_PCM mb_type (the host decoder's syntax walks read it)
MB_TYPE_I_PCM = 25


def _nal(lib, rbsp_buf: np.ndarray, rbsp_len: int, nal_type: int,
         nal_ref_idc: int) -> bytes:
    """Annex-B NAL of an RBSP: the native escape, or under
    ``VCP_NO_NATIVE=1`` the Python one (``lib`` is then unused)."""
    if native.disabled():
        body = emulation_prevent(rbsp_buf[:rbsp_len].tobytes())
    else:
        out = np.empty(rbsp_len + rbsp_len // 2 + 16, np.uint8)
        n = lib.vcp_escape(rbsp_buf.ctypes.data_as(_U8P), rbsp_len,
                           out.ctypes.data_as(_U8P))
        body = out[:n].tobytes()
    return (b"\x00\x00\x01" + bytes([(nal_ref_idc << 5) | nal_type])
            + body)


def write_islice(sp: H.SeqParams, pp: H.PicParams, *, frame_num: int,
                 idr_pic_id: int, qp: int, data: dict,
                 deblock: bool = False, poc_lsb: int = 0) -> bytes:
    """One IDR slice NAL from the level arrays of ``encode_iframe``,
    ``encode_iframe_rd`` or ``encode_iframe_rd8``, in the PPS's entropy
    mode. Without "modes" in ``data`` MB row 0 is I16x16-DC and rows 1..
    I16x16-V; with "modes" / "cmodes" every MB carries its own; with an
    "i8" grid that flags any MB (CABAC only), those MBs are I_NxN with
    the 8x8 transform ("i8_modes", "i8_luma")."""
    i8 = data.get("i8")
    has_i8 = i8 is not None and bool(np.any(i8))
    if has_i8 and not pp.cabac:
        raise ValueError("I_NxN macroblocks need the CABAC writer")
    kw = dict(frame_num=frame_num, idr_pic_id=idr_pic_id, qp=qp,
              deblock=deblock, poc_lsb=poc_lsb)
    if native.disabled():
        if pp.cabac:
            from .cabac_syntax import write_islice_cabac
            return write_islice_cabac(sp, pp, data=data, **kw)
        return _write_islice_py(sp, pp, data=data, **kw)
    lib = native.get_lib()
    n_mby, n_mbx = sp.mb_height, sp.mb_width
    cap = n_mby * n_mbx * 2048 + 4096
    out = np.empty(cap, np.uint8)
    head = (n_mby, n_mbx, qp, pp.init_qp, sp.log2_max_frame_num,
            frame_num, idr_pic_id, 0 if deblock else 1,
            sp.log2_max_poc_lsb if sp.poc_type == 0 else 0, poc_lsb)
    luma_ac = data["luma_ac"]
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
        writer = lib.vcp_write_islice_cabac if pp.cabac \
            else lib.vcp_write_islice
        n = writer(*head, *ptrs, *tail)
    if n < 0:
        raise RuntimeError("native islice buffer overflow")
    return _nal(lib, out, int(n), H.NAL_SLICE_IDR, 3)


def _write_islice_py(sp: H.SeqParams, pp: H.PicParams, *, frame_num: int,
                     idr_pic_id: int, qp: int, data: dict,
                     deblock: bool = False, poc_lsb: int = 0) -> bytes:
    """The CAVLC IDR writer in Python (``vcp_tpu``'s ``_write_islice_py``),
    the twin of the native ``vcp_write_islice``: every MB I16x16, with
    the row pattern or the per-MB "modes" / "cmodes"."""
    n_mby, n_mbx = sp.mb_height, sp.mb_width
    bw = BitWriter()
    H.write_slice_header(bw, sp, pp, is_idr=True, frame_num=frame_num,
                         slice_qp=qp, idr_pic_id=idr_pic_id,
                         disable_deblocking=not deblock, poc_lsb=poc_lsb)
    nz_y, nz_cb, nz_cr = cavlc_writer._contexts(n_mby, n_mbx)
    luma_dc, luma_ac = data["luma_dc"], data["luma_ac"]
    cb_dc, cb_ac = data["cb_dc"], data["cb_ac"]
    cr_dc, cr_ac = data["cr_dc"], data["cr_ac"]
    modes, cmodes = data.get("modes"), data.get("cmodes")
    for mby in range(n_mby):
        # row 0 has no top neighbours: DC luma + DC chroma; rows 1..
        # Vertical
        pred_mode, chroma_mode = (2, 0) if mby == 0 else (0, 2)
        for mbx in range(n_mbx):
            if modes is not None:
                pred_mode = int(modes[mby, mbx])
                chroma_mode = int(cmodes[mby, mbx])
            _write_i16_mb(bw, mbx, mby, luma_dc[mby, mbx], luma_ac[mby, mbx],
                          (cb_dc[mby, mbx], cr_dc[mby, mbx]),
                          (cb_ac[mby, mbx], cr_ac[mby, mbx]),
                          nz_y, nz_cb, nz_cr, pred_mode, chroma_mode)
    bw.rbsp_trailing_bits()
    return nal_unit(H.NAL_SLICE_IDR, bw.to_bytes(), nal_ref_idc=3)


def _write_i16_mb(bw, mbx, mby, z_dc, z_ac, chroma_dc, chroma_ac,
                  nz_y, nz_cb, nz_cr, pred_mode: int, chroma_mode: int):
    """One Intra_16x16 MB: mb_type, chroma pred mode, mb_qp_delta 0, then
    the DC, the AC (when any), the chroma DC and AC blocks."""
    cbp_luma15 = bool(np.any(z_ac[:, 1:]))
    any_cac = bool(np.any(chroma_ac[0][:, 1:])) or \
        bool(np.any(chroma_ac[1][:, 1:]))
    any_cdc = bool(np.any(chroma_dc[0])) or bool(np.any(chroma_dc[1]))
    cbp_chroma = 2 if any_cac else (1 if any_cdc else 0)
    # the I slice mb_type of an I16x16 MB (Table 7-11)
    bw.ue(1 + pred_mode + 4 * cbp_chroma + 12 * int(cbp_luma15))
    bw.ue(chroma_mode)             # intra_chroma_pred_mode
    bw.se(0)                       # mb_qp_delta
    # Intra16x16DCLevel: nC from luma block (0, 0)'s neighbours
    encode_residual_block(bw, [int(v) for v in z_dc],
                          nz_y.nc(4 * mby, 4 * mbx))
    for blk in range(16):
        oy, ox = int(LUMA_BLK_ORDER[blk, 0]), int(LUMA_BLK_ORDER[blk, 1])
        by, bx = 4 * mby + oy, 4 * mbx + ox
        total = encode_residual_block(
            bw, [int(v) for v in z_ac[blk, 1:]], nz_y.nc(by, bx)) \
            if cbp_luma15 else 0
        nz_y.set(by, bx, total)
    if cbp_chroma:
        for c in range(2):
            encode_residual_block(bw, [int(v) for v in chroma_dc[c]], -1)
    for c, nzc in ((0, nz_cb), (1, nz_cr)):
        for blk in range(4):
            oy = int(cavlc_writer.CHROMA_BLK_ORDER[blk, 0])
            ox = int(cavlc_writer.CHROMA_BLK_ORDER[blk, 1])
            by, bx = 2 * mby + oy, 2 * mbx + ox
            total = encode_residual_block(
                bw, [int(v) for v in chroma_ac[c][blk, 1:]], nzc.nc(by, bx)) \
                if cbp_chroma == 2 else 0
            nzc.set(by, bx, total)


def _any(data: dict, key: str) -> bool:
    a = data.get(key)
    return a is not None and bool(np.any(a))


def _u8(data: dict, key: str, default=None) -> np.ndarray | None:
    a = data.get(key, default)
    return None if a is None else np.ascontiguousarray(a, np.uint8)


def _ptr(a: np.ndarray | None, kind=_I32P):
    """ctypes pointer to ``a`` (NULL for None); the caller keeps ``a``."""
    return kind() if a is None else a.ctypes.data_as(kind)


def mv8_grid_xy(data: dict, n_mby: int, n_mbx: int):
    """(mv8_xy (2nMBy, 2nMBx, 2) [x, y] grid, ptype (nMBy, nMBx) int32)
    from an entropy dict: the 8x8-grid field "mv8" when present, else the
    per-MB "mv" replicated. The partition type (0 = 16x16, 1 = 16x8, 2 =
    8x16, 3 = P_8x8) is canonicalised from the MV field itself, the
    cheapest mb_type that expresses it (MC depends only on the per-8x8
    vectors, so the decoder rebuilds the same grid either way)."""
    mv8 = data.get("mv8")
    if mv8 is None:
        mv = np.asarray(data["mv"])
        mv8 = np.repeat(np.repeat(mv, 2, 0), 2, 1)
        ptype = np.zeros((n_mby, n_mbx), np.int32)
    else:
        mv8 = np.asarray(mv8)
        quads = mv8.reshape(n_mby, 2, n_mbx, 2, 2)  # (mby, sy, mbx, sx, 2)
        uniform = (quads == quads[:, :1, :, :1]).all(axis=(1, 3, 4))
        rows_u = (quads[:, :, :, 0] == quads[:, :, :, 1]).all(
            axis=-1).all(axis=1)                    # both rows left==right
        cols_u = (quads[:, 0] == quads[:, 1]).all(
            axis=-1).all(axis=-1)                   # both cols top==bottom
        ptype = np.where(uniform, 0,
                         np.where(rows_u, 1, np.where(cols_u, 2, 3)))
    return (_xy(mv8), np.ascontiguousarray(ptype, np.int32))


def _xy(mv) -> np.ndarray:
    """[dy, dx] vectors -> the writers' [x, y] order, int32."""
    mv = np.asarray(mv)
    return np.ascontiguousarray(np.stack([mv[..., 1], mv[..., 0]], axis=-1),
                                np.int32)


def levels(data: dict) -> list[np.ndarray]:
    """The level arrays every inter slice writer takes, in its order."""
    return [np.ascontiguousarray(data[k], np.int32)
            for k in ("luma", "cb_dc", "cb_ac", "cr_dc", "cr_ac")]


def write_pslice(sp: H.SeqParams, pp: H.PicParams, *, frame_num: int,
                 qp: int, data: dict, deblock: bool = False,
                 poc_lsb: int = 0) -> bytes:
    """One P slice NAL from an ``unpack_sparse_chunk`` dict or the dict of
    ``pframe.encode_pframe`` (mv in quarter-pel [dy, dx]; ``active``
    marks the MBs present in the dense arrays, the rest are P_Skip), in
    the PPS's entropy mode. When the PPS has the 8x8 transform on, every
    MB with luma residual codes its transform_size_8x8 flag from the
    optional ``t8`` grid (absent = all 4x4). As in ``vcp_tpu``, a CABAC
    frame with intra MBs ("intra", with "i8", I16 modes "imodes", chroma
    modes "icmodes", I16 DC levels "luma_dc", i8 block modes "i8_modes";
    an intra MB's "luma" row holds its I16 AC blocks or its four i8
    scans) goes to the intra writer, one with partitioned MBs ("parts",
    vectors "mv8" on the 8x8 grid) to the partition writer, the rest to
    the 16x16 writer. A CAVLC frame takes the native writer when it has
    neither partitions nor the 8x8 transform, else the Python writer
    (intra MBs need CABAC). Under ``VCP_NO_NATIVE=1`` a CABAC frame
    goes to ``cabac_syntax``'s intra writer or its partition / 16x16
    writer, a CAVLC frame to the Python writer."""
    n_mby, n_mbx = sp.mb_height, sp.mb_width
    kw = dict(frame_num=frame_num, qp=qp, deblock=deblock, poc_lsb=poc_lsb)
    if not pp.cabac:
        if _any(data, "intra"):
            raise ValueError("intra macroblocks in a P slice need CABAC")
        if native.disabled() or _any(data, "parts") or _any(data, "t8") \
                or pp.transform_8x8:
            mv8_xy, parts = mv8_grid_xy(data, n_mby, n_mbx)
            return cavlc_writer.write_pslice(
                sp, pp, data=data, mv8_xy=mv8_xy, parts=parts, **kw)
    elif native.disabled():
        from . import cabac_syntax
        writer = cabac_syntax.write_pslice_cabac_intra \
            if _any(data, "intra") else cabac_syntax.write_pslice_cabac
        return writer(sp, pp, data=data, **kw)
    lib = native.get_lib()
    cap = n_mby * n_mbx * 2048 + 4096
    out = np.empty(cap, np.uint8)
    head = (n_mby, n_mbx, qp, pp.init_qp, sp.log2_max_frame_num, frame_num,
            0 if deblock else 1,
            sp.log2_max_poc_lsb if sp.poc_type == 0 else 0, poc_lsb)
    lv = levels(data)
    tail = (*[_ptr(a) for a in lv], out.ctypes.data_as(_U8P), cap)
    act, t8 = _u8(data, "active"), _u8(data, "t8")
    if _any(data, "intra") or _any(data, "parts"):
        mv8_xy, parts = mv8_grid_xy(data, n_mby, n_mbx)
        grid = (_ptr(mv8_xy), _ptr(parts))
        if _any(data, "intra"):
            flags = [_u8(data, k) for k in ("intra", "i8")]
            ints = [np.ascontiguousarray(data[k], np.int32)
                    for k in ("imodes", "icmodes", "luma_dc", "i8_modes")]
            n = lib.vcp_write_pslice_cabac_intra(
                *head, _ptr(t8, _U8P), int(pp.transform_8x8),
                *[_ptr(a, _U8P) for a in flags], *[_ptr(a) for a in ints],
                *grid, *tail)
        else:
            n = lib.vcp_write_pslice_cabac_parts(
                *head, _ptr(act, _U8P), _ptr(t8, _U8P),
                int(pp.transform_8x8), *grid, *tail)
    else:
        mv_xy = _xy(data["mv"])
        if pp.transform_8x8:
            if t8 is None:
                t8 = np.zeros((n_mby, n_mbx), np.uint8)
            n = lib.vcp_write_pslice_cabac_t8(
                *head, _ptr(act, _U8P), _ptr(t8, _U8P), _ptr(mv_xy), *tail)
        else:
            if t8 is not None:
                raise ValueError("t8 macroblocks need pp.transform_8x8")
            writer = lib.vcp_write_pslice_cabac if pp.cabac \
                else lib.vcp_write_pslice
            n = writer(*head, _ptr(act, _U8P), _ptr(mv_xy), *tail)
    if n < 0:
        raise RuntimeError("native pslice buffer overflow")
    return _nal(lib, out, int(n), H.NAL_SLICE_NONIDR, 2)
