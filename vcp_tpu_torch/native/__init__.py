"""Host C++ library: the encoder's CABAC and CAVLC slice writers and NAL
escaping, its changed-tile pass of the delta upload, and the host
decoder's deblocking filter, CABAC slice parser and reconstruction.

``get_lib()`` builds the sources (``build.SOURCES``) with g++ on first
use into ``vcp_tpu_torch/_build/`` and returns the loaded library. These
are host code, not device kernels. A failed build raises. The first use
builds and loads under a lock, so threads that reach it together (a
consumer's workers) share one build and one handle.

``VCP_NO_NATIVE=1``, read on every call as in ``vcp_tpu``, turns the
library off: no g++ runs, and every caller takes its Python or NumPy
path (the CABAC and CAVLC writers of ``codec.h264.cabac_syntax`` and
``entropy``, the decoder's ``inter_cabac`` / ``inter_recon``, the NumPy
deblock of ``ops.deblock_host``, the tile pair of ``gop_ops``).
``get_lib()`` raises while the switch is set, so a caller that missed it
fails instead of building. Without the switch nothing falls back."""

from __future__ import annotations

import ctypes
import functools
import os
import threading

_lock = threading.Lock()


def disabled() -> bool:
    """``VCP_NO_NATIVE`` is set (to anything but the empty string)."""
    return bool(os.environ.get("VCP_NO_NATIVE"))


def get_lib() -> ctypes.CDLL:
    if disabled():
        raise RuntimeError("the host library is off (VCP_NO_NATIVE is set); "
                           "this caller has no Python path")
    with _lock:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    from .build import build
    lib = ctypes.CDLL(build())
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.vcp_escape.restype = i64
    lib.vcp_escape.argtypes = [u8p, i64, u8p]
    # CAVLC writers (entropy.cpp)
    lib.vcp_write_islice.restype = i64
    lib.vcp_write_islice.argtypes = [
        i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        i32p, i32p, i32p, i32p, i32p, i32p,   # level arrays
        i32p, i32p,                     # modes, cmodes (nullable)
        u8p, i64]
    lib.vcp_write_pslice.restype = i64
    lib.vcp_write_pslice.argtypes = [
        i32, i32, i32, i32, i32, i32, i32, i32, i32,
        u8p, i32p,                      # active (nullable), mv_xy
        i32p, i32p, i32p, i32p, i32p,   # luma + chroma arrays
        u8p, i64]
    lib.vcp_write_islice_cabac.restype = i64
    lib.vcp_write_islice_cabac.argtypes = [
        i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, u8p, i64]
    lib.vcp_write_pslice_cabac.restype = i64
    lib.vcp_write_pslice_cabac.argtypes = [
        i32, i32, i32, i32, i32, i32, i32, i32, i32,
        u8p, i32p, i32p, i32p, i32p, i32p, i32p, u8p, i64]
    lib.vcp_write_pslice_cabac_t8.restype = i64
    lib.vcp_write_pslice_cabac_t8.argtypes = [
        i32, i32, i32, i32, i32, i32, i32, i32, i32,
        u8p, u8p, i32p, i32p, i32p, i32p, i32p, i32p, u8p, i64]
    lib.vcp_write_islice_cabac_i8.restype = i64
    lib.vcp_write_islice_cabac_i8.argtypes = [
        i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, u8p, i32p,
        u8p, i64]
    lib.vcp_write_pslice_cabac_parts.restype = i64
    lib.vcp_write_pslice_cabac_parts.argtypes = [
        i32, i32, i32, i32, i32, i32, i32, i32, i32,
        u8p, u8p, i32,                  # active, t8, transform_8x8
        i32p, i32p,                     # mv8_xy, parts
        i32p, i32p, i32p, i32p, i32p,   # luma + chroma arrays
        u8p, i64]
    lib.vcp_write_pslice_cabac_intra.restype = i64
    lib.vcp_write_pslice_cabac_intra.argtypes = [
        i32, i32, i32, i32, i32, i32, i32, i32, i32,
        u8p, i32,                       # t8, transform_8x8
        u8p, u8p, i32p, i32p,           # intra, i8, imodes, icmodes
        i32p, i32p,                     # luma_dc, i8_modes
        i32p, i32p,                     # mv8_xy, parts
        i32p, i32p, i32p, i32p, i32p,   # luma + chroma arrays
        u8p, i64]
    lib.vcp_write_bslice_cabac.restype = i64
    lib.vcp_write_bslice_cabac.argtypes = [
        i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        i32p, i32p, i32p,               # mv0_xy, mv1_xy, mode
        u8p, u8p,                       # col_zero, col_safe
        i32p, i32p, i32p, i32p, i32p,   # luma + chroma arrays
        u8p, i64]
    # the delta upload's changed-tile pass (tiles.cpp)
    lib.vcp_tile_delta.restype = i32
    lib.vcp_tile_delta.argtypes = [
        u8p, u8p, u8p, i32, i32,        # y, u, v planes, H, W
        u8p, i32p, u8p, i32]            # prev (in place), idx, tiles, full
    # host decoder (deblock.cpp, h264parse.cpp, h264recon.cpp)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.vcp_parse_slice_cabac.restype = i64
    lib.vcp_parse_slice_cabac.argtypes = [
        u8p, i64,                       # payload
        i32, i32, i32, i32, i32,        # kind, qp, init_idc, n_mby, n_mbx
        i32, i32, i32,                  # pps_t8, n_ref0, n_ref1
        u8p, i32p,                      # col_ref0, col_mv8 (nullable)
        i32p, i8p, i32p, i8p,           # mv8/ref8 l0, l1
        u8p, u8p, u8p, i32p, u8p,       # dec8, intra, mv_valid, qp_mb, t8
        i32p, i32p, i32p,               # z_luma, cdc, cac
        i8p, i8p, i8p,                  # cbf grids
        i32p, i32p, i8p, i32p]          # intra queue
    pp = ctypes.POINTER(i32p)
    lib.vcp_recon_inter_frame.restype = i64
    lib.vcp_recon_inter_frame.argtypes = [
        pp, pp, pp, i32,                # list0 planes + count
        pp, pp, pp, i32,                # list1 planes + count (0 for P)
        i32, i32,                       # H, W
        i32p, i8p, i32p, i8p,           # mv8/ref8 l0, l1 (l1 nullable)
        u8p, i32, i32,                  # inter_mb, n_mby, n_mbx
        i32p, i32p, i32p,               # z_luma, cdc, cac
        u8p, i32p, i32,                 # t8, qp_mb, chroma_qp_off
        i32p, i32p, i32p, i32p,         # wt0, wt1, impl_w0, impl_w1
        i32p, i32p, i32p]               # y, u, v
    lib.vcp_deblock_frame_direct.restype = None
    lib.vcp_deblock_frame_direct.argtypes = [
        i32p, i32p, i32p, i32, i32,     # y, u, v, H, W
        u8p, u8p, i32p, u8p,            # intra, nz, qp_mb, t8
        i32, i32p, i32p, i32p, i32p,    # mv_mode, mv0, id0, mv1, id1
        i32, i32, i32p]                 # gh, gw, chroma qp table
    lib.vcp_recon_intra_mbs.restype = i64
    lib.vcp_recon_intra_mbs.argtypes = [
        i32p, i32p, i32p, i32, i32, i32,   # y, u, v, H, W, n_mbx
        i64, i32p, i32p, i8p, i32p,     # count + iq arrays
        i32p, i32p, i32p, i32]          # z_luma, cdc, cac, chroma_off
    return lib


get_lib.cache_clear = _load.cache_clear   # the next get_lib() loads anew
