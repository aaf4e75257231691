"""H.264 in-loop deblocking for the host decoder (spec 8.7).

Copy of ``deblock_frame_host`` / ``_deblock_host_native`` of
``vcp_tpu/ops/deblock.py``: the C++ direct-threshold filter
(``native/deblock.cpp``, ``vcp_deblock_frame_direct``) filters a decoded
picture in spec order, computing bS / alpha / beta / tc0 inline per edge
segment. This is host code: it launches no device kernel and is not a
port of the deblock kernels (``ops/deblock_cuda.py``), which filter the
encoder's recon on the card. The motion argument takes the decoder's two
forms: an (nMBy, nMBx, 2) or (2nMBy, 2nMBx, 2) quarter-pel grid (I
slices pass their all-zero grid), or the general 8x8-grid dict of
per-list vectors and reference-picture ids ``{"mv0", "id0"[, "mv1",
"id1"]}`` (bS 1 on differing reference pictures, 8.7.2.1).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import native

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def deblock_frame_host(y, u, v, qp_mb, intra_mb, nz_y, mvq,
                       chroma_qp_table, t8=None):
    """Filter the planes (H, W) / (H/2, W/2) in spec order; returns new
    int32 (y, u, v). ``qp_mb`` / ``intra_mb`` per MB, ``nz_y`` (H/4, W/4)
    residual presence per transform block, ``chroma_qp_table`` (52,) with
    the PPS chroma offset folded in, ``t8`` the per-MB 8x8-transform
    flags (their interior 4-offset edges are not filtered)."""
    lib = native.get_lib()
    null = ctypes.cast(None, _I32P)
    h, w = np.shape(y)
    yi = np.ascontiguousarray(y, np.int32)
    ui = np.ascontiguousarray(u, np.int32)
    vi = np.ascontiguousarray(v, np.int32)
    qp = np.ascontiguousarray(qp_mb, np.int32)
    intra = np.ascontiguousarray(intra_mb, bool).view(np.uint8)
    nz = np.ascontiguousarray(nz_y, bool).view(np.uint8)
    t8u = (np.ascontiguousarray(t8, bool).view(np.uint8)
           if t8 is not None else None)
    cq = np.ascontiguousarray(chroma_qp_table, np.int32)

    if isinstance(mvq, dict):
        mv_mode = 2
        mv0 = np.ascontiguousarray(mvq["mv0"], np.int32)
        id0 = np.ascontiguousarray(mvq["id0"], np.int32)
        mv1 = (np.ascontiguousarray(mvq["mv1"], np.int32)
               if "mv1" in mvq else None)
        id1 = (np.ascontiguousarray(mvq["id1"], np.int32)
               if "mv1" in mvq else None)
        gh = gw = 0
    else:
        mv_mode = 1
        mv0 = np.ascontiguousarray(mvq, np.int32)
        id0 = mv1 = id1 = None
        gh, gw = mv0.shape[:2]

    def p(a):
        return a.ctypes.data_as(_I32P) if a is not None else null
    lib.vcp_deblock_frame_direct(
        p(yi), p(ui), p(vi), h, w,
        intra.ctypes.data_as(_U8P), nz.ctypes.data_as(_U8P), p(qp),
        t8u.ctypes.data_as(_U8P) if t8u is not None
        else ctypes.cast(None, _U8P),
        mv_mode, p(mv0), p(id0), p(mv1), p(id1), gh, gw, p(cq))
    return yi, ui, vi
