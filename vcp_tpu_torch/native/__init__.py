"""Host C++ entropy writers (CABAC slice writers + NAL escaping).

``get_lib()`` builds ``cabac.cpp`` and ``entropy.cpp`` with g++ on first
use into ``vcp_tpu_torch/_build/`` and returns the loaded library. These
are host code, not device kernels. A failed build raises."""

from __future__ import annotations

import ctypes
import functools


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    from .build import build
    lib = ctypes.CDLL(build())
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.vcp_escape.restype = i64
    lib.vcp_escape.argtypes = [u8p, i64, u8p]
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
    return lib
