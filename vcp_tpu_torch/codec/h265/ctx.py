"""HEVC CABAC context sets and scan orders (spec 9.3.2, 6.5.3).

Copy of ``vcp_tpu/codec/h265/ctx.py`` (host code).
"""

from __future__ import annotations

import functools

from ..cabac import Context

# Number of contexts per syntax element set.
CTX_SETS = {
    "split_cu": 3,          # ctxInc from neighbor depths
    "cu_skip": 3,
    "pred_mode": 1,
    "part_mode": 4,
    "prev_intra": 1,        # prev_intra_luma_pred_flag
    "intra_chroma": 1,      # first bin of intra_chroma_pred_mode
    "rqt_root_cbf": 1,
    "merge_flag": 1,
    "merge_idx": 1,
    "inter_pred_idc": 5,
    "ref_idx": 2,
    "mvp_flag": 1,
    "mvd_gr0": 1,           # abs_mvd_greater0_flag
    "mvd_gr1": 1,           # abs_mvd_greater1_flag
    "split_tr": 3,          # split_transform_flag
    "cbf_luma": 2,          # ctxInc = (trafoDepth == 0)
    "cbf_chroma": 5,        # ctxInc = trafoDepth
    "last_x": 18,           # 15 luma + 3 chroma
    "last_y": 18,
    "csbf": 4,              # coded_sub_block_flag: 2 luma + 2 chroma
    "sig_luma": 27,
    "sig_chroma": 15,
    "gr1_luma": 16,         # coeff_abs_level_greater1: 4 sets x 4
    "gr1_chroma": 8,        # 2 sets x 4
    "gr2_luma": 4,
    "gr2_chroma": 2,
}

# Normative initValue per set and initType (spec 9.3.2.2, Tables
# 9-5..9-42; initType 0 = I slices, 1/2 = P/B with cabac_init_flag 0/1).
INIT_VALUES = {
    "split_cu": ((139, 141, 157), (107, 139, 126), (107, 139, 126)),
    "cu_skip": ((154, 154, 154), (197, 185, 201), (197, 185, 201)),
    "pred_mode": ((154,), (149,), (134,)),
    "part_mode": ((184, 154, 154, 154), (154, 139, 154, 154),
                  (154, 139, 154, 154)),
    "prev_intra": ((184,), (154,), (183,)),
    "intra_chroma": ((63,), (152,), (152,)),
    "rqt_root_cbf": ((79,), (79,), (79,)),
    "merge_flag": ((154,), (110,), (154,)),
    "merge_idx": ((154,), (122,), (137,)),
    "inter_pred_idc": ((95, 79, 63, 31, 31), (95, 79, 63, 31, 31),
                       (95, 79, 63, 31, 31)),
    "ref_idx": ((153, 153), (153, 153), (153, 153)),
    "mvp_flag": ((168,), (168,), (168,)),
    "mvd_gr0": ((140,), (140,), (169,)),
    "mvd_gr1": ((198,), (198,), (198,)),
    "split_tr": ((153, 138, 138), (124, 138, 94), (224, 167, 122)),
    "cbf_luma": ((111, 141), (153, 111), (153, 111)),
    "cbf_chroma": ((94, 138, 182, 154, 154), (149, 107, 167, 154, 154),
                   (149, 92, 167, 154, 154)),
    "last_x": ((110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111,
                143, 127, 111, 79, 108, 123, 63),
               (125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111,
                111, 95, 94, 108, 123, 108),
               (125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126,
                111, 111, 79, 108, 123, 93)),
    "last_y": ((110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111,
                143, 127, 111, 79, 108, 123, 63),
               (125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111,
                111, 95, 94, 108, 123, 108),
               (125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126,
                111, 111, 79, 108, 123, 93)),
    "csbf": ((91, 171, 134, 141), (121, 140, 61, 154),
             (121, 140, 61, 154)),
    "sig_luma": ((111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125,
                  141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 107,
                  125, 141, 179, 153, 125),
                 (155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183,
                  140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 166,
                  183, 140, 136, 153, 154),
                 (170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183,
                  140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 166,
                  183, 140, 136, 153, 154)),
    "sig_chroma": ((140, 139, 182, 182, 152, 136, 152, 136, 153, 136,
                    139, 111, 136, 139, 111),
                   (170, 153, 123, 123, 107, 121, 107, 121, 167, 151,
                    183, 140, 151, 183, 140),
                   (170, 153, 138, 138, 122, 121, 122, 121, 167, 151,
                    183, 140, 151, 183, 140)),
    "gr1_luma": ((140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149,
                  92, 139, 107, 122, 152),
                 (154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149,
                  136, 153, 121, 136, 137),
                 (154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149,
                  136, 153, 121, 136, 122)),
    "gr1_chroma": ((140, 179, 166, 182, 140, 227, 122, 197),
                   (169, 194, 166, 167, 154, 167, 137, 182),
                   (169, 208, 166, 167, 154, 152, 167, 182)),
    "gr2_luma": ((138, 153, 136, 167), (107, 167, 91, 122),
                 (107, 167, 91, 107)),
    "gr2_chroma": ((152, 152), (107, 167), (107, 167)),
}


class HevcContexts:
    """All adaptive contexts for one slice, spec-initialized."""

    def __init__(self, slice_qp: int, init_type: int = 0):
        self.qp = slice_qp
        self.init_type = init_type
        self.c = {}
        for name, n in CTX_SETS.items():
            ivs = INIT_VALUES[name][init_type]
            assert len(ivs) == n, name
            self.c[name] = [Context.from_init_hevc(v, slice_qp)
                            for v in ivs]

    def __getitem__(self, key):
        name, idx = key
        return self.c[name][idx]


# ---------------------------------------------------------------------------
# Scan orders (spec 6.5.3, up-right diagonal).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def diag_scan(n: int):
    """Up-right diagonal scan for an n x n array: tuple of (x, y) in
    scan-position order, starting at DC."""
    order = []
    for d in range(2 * n - 1):
        y = min(d, n - 1)
        while y >= 0 and d - y < n:
            order.append((d - y, y))
            y -= 1
    return tuple(order)


@functools.lru_cache(maxsize=None)
def scan_pos_of(n: int):
    """Inverse map: dict (x, y) -> scan position."""
    return {xy: i for i, xy in enumerate(diag_scan(n))}


@functools.lru_cache(maxsize=None)
def coeff_scan(log2: int):
    """Full hierarchical coefficient scan for an N x N TB: 4x4 subblocks
    in diagonal order, coefficients within each subblock in diagonal
    order. Tuple of (x, y), scan position 16*sbPos + posInSb."""
    n = 1 << log2
    if n == 4:
        return diag_scan(4)
    order = []
    for sx, sy in diag_scan(n // 4):
        for px, py in diag_scan(4):
            order.append((sx * 4 + px, sy * 4 + py))
    return tuple(order)
