"""H.264 CABAC slice syntax (spec 7.3.5 / 9.3) in Python, encode and
decode; copy of ``vcp_tpu/codec/h264/cabac_syntax.py``.

The Python twins of the C++ CABAC writers of ``native/cabac.cpp`` and of
the I-slice half of the parser of ``native/h264parse.cpp``: they run
under ``VCP_NO_NATIVE=1`` (the writers through ``entropy`` and
``bframe``, the parser through the decoder), and they are the port's
own reference for the C++ copies.

Both directions share every context-increment derivation (neighbour
cbf, |mvd| sums, cbp bits, skip flags) through one ``MbState``, so the
encoder and the decoder cannot drift. Context initialization follows
the normative Tables 9-12..9-33 (``cabac_tables``). The general P / B
slice parser lives in ``inter_cabac``, built on the same primitives.
"""

from __future__ import annotations

import numpy as np

from .cabac import CabacDecoder, Context
from .cabac_tables import CTX_INIT_I, CTX_INIT_PB
from .consts import CHROMA_BLK_ORDER, LUMA_BLK_ORDER

# Residual block categories (spec 9.3.3.1.3 ctxBlockCat)
CAT_I16_DC = 0      # Intra16x16DCLevel, 16 coeffs
CAT_I16_AC = 1      # Intra16x16ACLevel, 15
CAT_LUMA4 = 2       # LumaLevel4x4, 16
CAT_CHROMA_DC = 3   # ChromaDCLevel, 4
CAT_CHROMA_AC = 4   # ChromaACLevel, 15

# Named slot → global ctxIdx (spec Table 9-11 ctxIdxOffsets + the
# binIdx-dependent ctxIdxInc sharing of 9.3.3.1). Slots that the spec
# maps to one context (e.g. both Intra16x16 pred-mode bins) alias the
# same global index, so sharing falls out of the mapping.
_SIG_OFF = (0, 15, 29, 44, 47)      # ctxBlockCat offsets, frame-coded
_ABS_OFF = (0, 10, 20, 30, 39)

# ctxBlockCat 5 (LumaLevel8x8, High profile): significant/last ctxIdxInc
# per scan position (spec Table 9-43, frame-coded) and its own offsets
# — sig base 402, last base 417, abs base 426; no coded_block_flag.
CAT_LUMA8 = 5
_SIG8_MAP = (
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12,
)
_LAST8_MAP = (
    (0,) + (1,) * 15 + (2,) * 16 + (3,) * 8 + (4,) * 8 + (5,) * 4
    + (6,) * 4 + (7,) * 4 + (8,) * 3
)
assert len(_SIG8_MAP) == 63 and len(_LAST8_MAP) == 63


def _ctx_index_map(slice_type: str) -> dict:
    m = {
        # I slice: mb_type ctxIdxOffset 3; b0 inc 0..2, tail bins 6..9
        # (both pred bins share 9). P slice: the intra suffix re-uses
        # base 17 with NO neighbor inc and tail 18,19,19,20,20. B slice:
        # intra suffix base 32 (shared with the mb_type '11xxxx' bins),
        # tail 33,34,34,35,35.
        "mbt_i": {"I": (3, 4, 5), "P": (17, 17, 17),
                  "B": (32, 32, 32)}[slice_type],
        "mbt_i_tail": {"I": (6, 7, 8, 9, 10), "P": (18, 19, 19, 20, 20),
                       "B": (33, 34, 34, 35, 35)}[slice_type],
        "mbt_p": (14, 15, 16),
        # P mb_type binIdx2 when b1 == 1 (16x8 vs 8x16): ctx 17
        "mbt_p_alt": (17,),
        # P sub_mb_type (ctxIdxOffset 21, one ctx per binIdx)
        "submbt_p": (21, 22, 23),
        # B sub_mb_type (ctxIdxOffset 36)
        "submbt_b": (36, 37, 38, 39),
        # ref_idx_lX (ctxIdxOffset 54): bin0 inc 0..3, bin1 -> 4, 2+ -> 5
        "ref_idx": (54, 55, 56, 57, 58, 59),
        # B mb_type (9.3.3.1.1.3): bin0 ctx 27+inc(0..2), bin1 ctx 30,
        # then 31 for the first '11'-suffix bin and 32 for the rest
        "mbt_b": (27, 28, 29),
        "mbt_b_fix": (30, 31, 32),
        "skip": (24, 25, 26) if slice_type == "B" else (11, 12, 13),
        "chroma_mode": (64, 65, 66, 67),
        "qp_delta": (60,),
        "cbp_l": tuple(range(73, 77)),
        "cbp_c": tuple(range(77, 85)),
        "mvd_x": tuple(range(40, 47)),
        "mvd_y": tuple(range(47, 54)),
    }
    for cat in range(5):
        m[f"cbf{cat}"] = tuple(85 + 4 * cat + i for i in range(4))
        m[f"sig{cat}"] = tuple(105 + _SIG_OFF[cat] + i for i in range(15))
        m[f"last{cat}"] = tuple(166 + _SIG_OFF[cat] + i for i in range(15))
        m[f"abs{cat}"] = tuple(227 + _ABS_OFF[cat] + i for i in range(10))
    m["sig5"] = tuple(402 + i for i in range(15))
    m["last5"] = tuple(417 + i for i in range(9))
    m["abs5"] = tuple(426 + i for i in range(10))
    m["t8flag"] = (399, 400, 401)
    return m


_CTX_MAP = {t: _ctx_index_map(t) for t in ("I", "P", "B")}


class H264CabacContexts:
    """All adaptive contexts for one slice, spec-initialized (9.3.1.1,
    Tables 9-12..9-33; cabac_init_idc=0 for P/B slices) and addressed by
    (named-slot, index) through the global ctxIdx map above."""

    def __init__(self, slice_qp: int, pslice: bool = False,
                 slice_type: str | None = None, init_idc: int = 0):
        st = slice_type or ("P" if pslice else "I")
        tab = CTX_INIT_I if st == "I" else CTX_INIT_PB[init_idc]
        self.g = [Context.from_init(m, n, slice_qp) for (m, n) in tab]
        self.map = _CTX_MAP[st]

    def __getitem__(self, key):
        name, idx = key
        return self.g[self.map[name][idx]]


class MbState:
    """Per-slice neighbor state for context derivations. Kept identical
    on both sides by construction (one code path fills it)."""

    def __init__(self, n_mby: int, n_mbx: int):
        self.n_mby, self.n_mbx = n_mby, n_mbx
        self.avail = np.zeros((n_mby, n_mbx), bool)
        self.skip = np.zeros((n_mby, n_mbx), bool)
        self.intra = np.zeros((n_mby, n_mbx), bool)
        self.t8 = np.zeros((n_mby, n_mbx), bool)   # transform_size_8x8
        self.i_nxn = np.zeros((n_mby, n_mbx), bool)  # I_NxN mb_type
        self.bdirect = np.zeros((n_mby, n_mbx), bool)  # B_Direct_16x16
        # per-8x8-block per-list "explicit refIdx > 0" for the ref_idx
        # ctxIdxInc (9.3.3.1.1.6; skip/intra/direct blocks stay False)
        self.refgt0 = np.zeros((2 * n_mby, 2 * n_mbx, 2), bool)
        self.last_qp_delta = 0
        self.chroma_mode = np.zeros((n_mby, n_mbx), np.int32)
        self.cbp_luma8 = np.zeros((2 * n_mby, 2 * n_mbx), np.int32)
        self.cbp_chroma = np.zeros((n_mby, n_mbx), np.int32)
        # per-list |mvd| for the mvd ctxIdxInc (9.3.3.1.1.7), kept on the
        # 8x8 block grid so P_8x8 partitions address their true neighbor
        # partitions; P uses list 0 only. For 16x16 MBs all four blocks
        # carry the MB's mvd — neighbor lookups then match the per-MB
        # derivation exactly.
        self.absmvd = np.zeros((2 * n_mby, 2 * n_mbx, 2, 2), np.int32)
        # coded_block_flag grids
        self.cbf_l4 = np.zeros((4 * n_mby, 4 * n_mbx), np.int8)
        self.cbf_i16dc = np.zeros((n_mby, n_mbx), np.int8)
        self.cbf_cdc = np.zeros((2, n_mby, n_mbx), np.int8)
        self.cbf_c4 = np.zeros((2, 2 * n_mby, 2 * n_mbx), np.int8)

    # -- neighbor helpers ---------------------------------------------
    def _nb(self, mbx, mby):
        a = (mbx - 1, mby) if mbx > 0 else None
        b = (mbx, mby - 1) if mby > 0 else None
        return a, b

    def mbt_i_ctx(self, mbx, mby):
        a, b = self._nb(mbx, mby)
        # condTerm = 1 when neighbor exists, is intra and not I_NxN
        ca = 1 if (a and self.avail[a[1], a[0]]
                   and self.intra[a[1], a[0]]
                   and not self.i_nxn[a[1], a[0]]) else 0
        cb = 1 if (b and self.avail[b[1], b[0]]
                   and self.intra[b[1], b[0]]
                   and not self.i_nxn[b[1], b[0]]) else 0
        return ca + cb

    def skip_ctx(self, mbx, mby):
        a, b = self._nb(mbx, mby)
        ca = 1 if (a and self.avail[a[1], a[0]]
                   and not self.skip[a[1], a[0]]) else 0
        cb = 1 if (b and self.avail[b[1], b[0]]
                   and not self.skip[b[1], b[0]]) else 0
        return ca + cb

    def chroma_mode_ctx(self, mbx, mby):
        a, b = self._nb(mbx, mby)
        ca = 1 if (a and self.avail[a[1], a[0]]
                   and self.chroma_mode[a[1], a[0]] != 0) else 0
        cb = 1 if (b and self.avail[b[1], b[0]]
                   and self.chroma_mode[b[1], b[0]] != 0) else 0
        return ca + cb

    def cbp_luma_ctx(self, mbx, mby, b8: int):
        """b8 in raster 0..3 within the MB; cond = neighbor 8x8 bit == 0."""
        gy, gx = 2 * mby + b8 // 2, 2 * mbx + b8 % 2
        ca = 1 if gx > 0 and self.cbp_luma8[gy, gx - 1] == 0 else 0
        if gx == 0:
            ca = 0
        cb = 1 if gy > 0 and self.cbp_luma8[gy - 1, gx] == 0 else 0
        if gy == 0:
            cb = 0
        return ca + 2 * cb

    def cbp_chroma_ctx(self, mbx, mby, binidx: int):
        a, b = self._nb(mbx, mby)
        if binidx == 0:
            ca = 1 if (a and self.cbp_chroma[a[1], a[0]] != 0) else 0
            cb = 1 if (b and self.cbp_chroma[b[1], b[0]] != 0) else 0
            return ca + 2 * cb
        ca = 1 if (a and self.cbp_chroma[a[1], a[0]] == 2) else 0
        cb = 1 if (b and self.cbp_chroma[b[1], b[0]] == 2) else 0
        return 4 + ca + 2 * cb

    def t8_ctx(self, mbx, mby):
        a, b = self._nb(mbx, mby)
        ca = 1 if (a and self.avail[a[1], a[0]]
                   and self.t8[a[1], a[0]]) else 0
        cb = 1 if (b and self.avail[b[1], b[0]]
                   and self.t8[b[1], b[0]]) else 0
        return ca + cb

    def mbt_b_ctx(self, mbx, mby):
        """ctxIdxInc for B mb_type bin 0 (9.3.3.1.1.3): neighbor counts
        unless it is skipped or B_Direct_16x16."""
        a, b = self._nb(mbx, mby)
        ca = 1 if (a and self.avail[a[1], a[0]]
                   and not self.skip[a[1], a[0]]
                   and not self.bdirect[a[1], a[0]]) else 0
        cb = 1 if (b and self.avail[b[1], b[0]]
                   and not self.skip[b[1], b[0]]
                   and not self.bdirect[b[1], b[0]]) else 0
        return ca + cb

    def ref_idx_ctx(self, by, bx, lst: int):
        """ctxIdxInc for ref_idx bin 0 (9.3.3.1.1.6) from the left/above
        8x8 blocks' explicit-refIdx>0 flags."""
        ca = 1 if bx > 0 and self.refgt0[by, bx - 1, lst] else 0
        cb = 1 if by > 0 and self.refgt0[by - 1, bx, lst] else 0
        return ca + 2 * cb

    def mvd_ctx(self, by, bx, comp: int, lst: int = 0):
        """ctxIdxInc for mvd bin 0 (9.3.3.1.1.7); (by, bx) address the
        current PARTITION's top-left 8x8 block. A = block to the left,
        B = block above (availability via the containing MB)."""
        s = 0
        if bx > 0 and self.avail[by >> 1, (bx - 1) >> 1]:
            s += int(self.absmvd[by, bx - 1, lst, comp])
        if by > 0 and self.avail[(by - 1) >> 1, bx >> 1]:
            s += int(self.absmvd[by - 1, bx, lst, comp])
        return 0 if s < 3 else (1 if s <= 32 else 2)

    def set_absmvd(self, by, bx, ph: int, pw: int, lst: int, vals):
        """Record a partition's |mvd| over its ``ph`` x ``pw``
        8x8-block footprint (2x2 = 16x16 MB, 1x1 = one 8x8)."""
        self.absmvd[by:by + ph, bx:bx + pw, lst] = vals

    def cbf_ctx(self, cat: int, mbx, mby, blk: int, cur_intra: bool,
                c: int = 0):
        """ctxInc = condA + 2*condB from the neighboring block's cbf.
        Unavailable neighbor -> (1 if current MB is intra else 0),
        following spec 9.3.3.1.1.9's intra rule."""
        miss = 1 if cur_intra else 0
        if cat == CAT_I16_DC:
            # an AVAILABLE neighbor without an I16 DC block contributes
            # 0 (9.3.3.1.1.9); the grid is only ever set for I16 MBs,
            # so indexing it covers both cases. Out of picture -> miss.
            ca = int(self.cbf_i16dc[mby, mbx - 1]) if mbx > 0 else miss
            cb = int(self.cbf_i16dc[mby - 1, mbx]) if mby > 0 else miss
        elif cat in (CAT_I16_AC, CAT_LUMA4):
            oy, ox = int(LUMA_BLK_ORDER[blk, 0]), int(LUMA_BLK_ORDER[blk, 1])
            gy, gx = 4 * mby + oy, 4 * mbx + ox
            ca = int(self.cbf_l4[gy, gx - 1]) if gx > 0 else miss
            cb = int(self.cbf_l4[gy - 1, gx]) if gy > 0 else miss
        elif cat == CAT_CHROMA_DC:
            ca = int(self.cbf_cdc[c, mby, mbx - 1]) if mbx > 0 else miss
            cb = int(self.cbf_cdc[c, mby - 1, mbx]) if mby > 0 else miss
        else:  # CAT_CHROMA_AC
            oy, ox = (int(CHROMA_BLK_ORDER[blk, 0]),
                      int(CHROMA_BLK_ORDER[blk, 1]))
            gy, gx = 2 * mby + oy, 2 * mbx + ox
            ca = int(self.cbf_c4[c, gy, gx - 1]) if gx > 0 else miss
            cb = int(self.cbf_c4[c, gy - 1, gx]) if gy > 0 else miss
        return ca + 2 * cb

    def set_cbf(self, cat, mbx, mby, blk, val, c=0):
        if cat == CAT_I16_DC:
            self.cbf_i16dc[mby, mbx] = val
        elif cat in (CAT_I16_AC, CAT_LUMA4):
            oy, ox = int(LUMA_BLK_ORDER[blk, 0]), int(LUMA_BLK_ORDER[blk, 1])
            self.cbf_l4[4 * mby + oy, 4 * mbx + ox] = val
        elif cat == CAT_CHROMA_DC:
            self.cbf_cdc[c, mby, mbx] = val
        else:
            oy, ox = (int(CHROMA_BLK_ORDER[blk, 0]),
                      int(CHROMA_BLK_ORDER[blk, 1]))
            self.cbf_c4[c, 2 * mby + oy, 2 * mbx + ox] = val


# ---------------------------------------------------------------------------
# Bypass Exp-Golomb helpers
# ---------------------------------------------------------------------------

def _write_egk(enc, v: int, k: int) -> None:
    while v >= (1 << k):
        enc.encode_bypass(1)
        v -= 1 << k
        k += 1
    enc.encode_bypass(0)
    if k:
        enc.encode_bypass_bits(v, k)


def _read_egk(dec, k: int) -> int:
    v = 0
    while dec.decode_bypass():
        v += 1 << k
        k += 1
    if k:
        v += dec.decode_bypass_bits(k)
    return v


# ---------------------------------------------------------------------------
# Residual block (spec 9.3.2.7 residual_block_cabac, frame-coded)
# ---------------------------------------------------------------------------

def _encode_block(enc, cx, st: MbState, coeffs, cat, mbx, mby, blk,
                  cur_intra, c=0):
    """cbf + significance map + levels for one scan-ordered block."""
    nz = [i for i, v in enumerate(coeffs) if v]
    cbf = 1 if nz else 0
    enc.encode(cx[f"cbf{cat}", st.cbf_ctx(cat, mbx, mby, blk,
                                          cur_intra, c)], cbf)
    st.set_cbf(cat, mbx, mby, blk, cbf, c)
    if not cbf:
        return
    n = len(coeffs)
    last = nz[-1]
    for i in range(n - 1):
        sig = 1 if coeffs[i] else 0
        enc.encode(cx[f"sig{cat}", i], sig)
        if sig:
            enc.encode(cx[f"last{cat}", i], 1 if i == last else 0)
            if i == last:
                break
    neq1 = ngt1 = 0
    for i in reversed(nz):
        v = abs(int(coeffs[i])) - 1
        ctx0 = 0 if ngt1 > 0 else min(4, 1 + neq1)
        ctx1 = 5 + min(4, ngt1)
        prefix = min(v, 14)
        for b in range(prefix):
            enc.encode(cx[f"abs{cat}", ctx0 if b == 0 else ctx1], 1)
        if prefix < 14:
            enc.encode(cx[f"abs{cat}", ctx0 if prefix == 0 else ctx1], 0)
        else:
            _write_egk(enc, v - 14, 0)
        enc.encode_bypass(1 if coeffs[i] < 0 else 0)
        if v == 0:
            neq1 += 1
        else:
            ngt1 += 1


def _decode_block(dec, cx, st: MbState, n, cat, mbx, mby, blk,
                  cur_intra, c=0):
    """Returns an n-length int32 scan-ordered array (zeros if cbf=0)."""
    out = np.zeros(n, np.int32)
    cbf = dec.decode(cx[f"cbf{cat}", st.cbf_ctx(cat, mbx, mby, blk,
                                                cur_intra, c)])
    st.set_cbf(cat, mbx, mby, blk, cbf, c)
    if not cbf:
        return out
    sig = [0] * n
    found_last = False
    for i in range(n - 1):
        sig[i] = dec.decode(cx[f"sig{cat}", i])
        if sig[i] and dec.decode(cx[f"last{cat}", i]):
            found_last = True
            break
    if not found_last:
        # every earlier significant coeff said "not last" (or none were
        # significant), so the final scan position is significant
        sig[n - 1] = 1
    nz = [i for i in range(n) if sig[i]]
    neq1 = ngt1 = 0
    for i in reversed(nz):
        ctx0 = 0 if ngt1 > 0 else min(4, 1 + neq1)
        ctx1 = 5 + min(4, ngt1)
        v = 0
        while v < 14 and dec.decode(cx[f"abs{cat}",
                                       ctx0 if v == 0 else ctx1]):
            v += 1
        if v == 14:
            v += _read_egk(dec, 0)
        sign = dec.decode_bypass()
        out[i] = -(v + 1) if sign else (v + 1)
        if v == 0:
            neq1 += 1
        else:
            ngt1 += 1
    return out


def _encode_block8(enc, cx, coeffs):
    """LumaLevel8x8 (ctxBlockCat 5): significance map over the 8x8 scan
    with the Table 9-43 context maps; no coded_block_flag (presence is
    the CBP bit). ``coeffs``: 64 scan-ordered levels, at least one != 0."""
    nz = [i for i, v in enumerate(coeffs) if v]
    last = nz[-1]
    for i in range(63):
        sig = 1 if coeffs[i] else 0
        enc.encode(cx["sig5", _SIG8_MAP[i]], sig)
        if sig:
            enc.encode(cx["last5", _LAST8_MAP[i]], 1 if i == last else 0)
            if i == last:
                break
    neq1 = ngt1 = 0
    for i in reversed(nz):
        v = abs(int(coeffs[i])) - 1
        ctx0 = 0 if ngt1 > 0 else min(4, 1 + neq1)
        ctx1 = 5 + min(4, ngt1)
        prefix = min(v, 14)
        for b in range(prefix):
            enc.encode(cx["abs5", ctx0 if b == 0 else ctx1], 1)
        if prefix < 14:
            enc.encode(cx["abs5", ctx0 if prefix == 0 else ctx1], 0)
        else:
            _write_egk(enc, v - 14, 0)
        enc.encode_bypass(1 if coeffs[i] < 0 else 0)
        if v == 0:
            neq1 += 1
        else:
            ngt1 += 1


def _decode_block8(dec, cx):
    """Inverse of _encode_block8; returns 64 scan-ordered levels."""
    out = np.zeros(64, np.int32)
    sig = [0] * 64
    found_last = False
    for i in range(63):
        sig[i] = dec.decode(cx["sig5", _SIG8_MAP[i]])
        if sig[i] and dec.decode(cx["last5", _LAST8_MAP[i]]):
            found_last = True
            break
    if not found_last:
        sig[63] = 1
    nz = [i for i in range(64) if sig[i]]
    neq1 = ngt1 = 0
    for i in reversed(nz):
        ctx0 = 0 if ngt1 > 0 else min(4, 1 + neq1)
        ctx1 = 5 + min(4, ngt1)
        v = 0
        while v < 14 and dec.decode(cx["abs5", ctx0 if v == 0 else ctx1]):
            v += 1
        if v == 14:
            v += _read_egk(dec, 0)
        sign = dec.decode_bypass()
        out[i] = -(v + 1) if sign else (v + 1)
        if v == 0:
            neq1 += 1
        else:
            ngt1 += 1
    return out


# ---------------------------------------------------------------------------
# MB-layer syntax pieces
# ---------------------------------------------------------------------------


def _decode_qp_delta(dec, cx, st) -> int:
    """mb_qp_delta (9.3.2.7 + 9.3.3.1.1.5): unary bins, ctx 60+last!=0,
    61, 62...; code k → (-1)^(k+1) * ceil(k/2)."""
    b0 = 1 if getattr(st, "last_qp_delta", 0) != 0 else 0
    k = 0
    if dec.decode(cx.g[60 + b0]):
        k = 1
        if dec.decode(cx.g[62]):
            k = 2
            while dec.decode(cx.g[63]):
                k += 1
    st.last_qp_delta = k
    if k == 0:
        return 0
    return (k + 1) // 2 if k % 2 else -(k // 2)


def _decode_intra_nxn_modes(dec, cx, n_blocks: int):
    """prev_intra_pred_mode_flag (ctx 68) + rem (3 bypass-free bins,
    ctx 69) per block; returns list of (prev_flag, rem or None)."""
    out = []
    for _ in range(n_blocks):
        if dec.decode(cx.g[68]):
            out.append(None)                # use predicted mode
        else:
            rem = (dec.decode(cx.g[69])
                   | (dec.decode(cx.g[69]) << 1)
                   | (dec.decode(cx.g[69]) << 2))
            out.append(rem)
    return out


def _decode_mvd_comp(dec, cx, st, by, bx, comp, lst=0):
    """(by, bx) = the partition's top-left 8x8 block coordinates."""
    name = "mvd_x" if comp == 0 else "mvd_y"
    b0 = st.mvd_ctx(by, bx, comp, lst)
    ctx_of = lambda b: b0 if b == 0 else min(6, 2 + b)  # noqa: E731
    v = 0
    while v < 9 and dec.decode(cx[name, ctx_of(v)]):
        v += 1
    if v == 9:
        v += _read_egk(dec, 3)
    if v and dec.decode_bypass():
        return -v
    return v


def _mb_i16_residual(enc_or_dec, cx, st, mbx, mby, *, encode,
                     cbp_luma15, cbp_chroma, dc_zz=None, ac=None,
                     cdc=None, cac=None):
    """Shared block-order walk for an I16x16 MB's residual."""
    if encode:
        _encode_block(enc_or_dec, cx, st, [int(x) for x in dc_zz],
                      CAT_I16_DC, mbx, mby, 0, True)
    else:
        dc_zz = _decode_block(enc_or_dec, cx, st, 16, CAT_I16_DC,
                              mbx, mby, 0, True)
        ac = np.zeros((16, 16), np.int32)
        cdc = np.zeros((2, 4), np.int32)
        cac = np.zeros((2, 4, 16), np.int32)
    for blk in range(16):
        if cbp_luma15:
            if encode:
                _encode_block(enc_or_dec, cx, st,
                              [int(x) for x in ac[blk, 1:]],
                              CAT_I16_AC, mbx, mby, blk, True)
            else:
                ac[blk, 1:] = _decode_block(enc_or_dec, cx, st, 15,
                                            CAT_I16_AC, mbx, mby, blk, True)
        else:
            st.set_cbf(CAT_I16_AC, mbx, mby, blk, 0)
    if cbp_chroma:
        for c in range(2):
            if encode:
                _encode_block(enc_or_dec, cx, st, [int(x) for x in cdc[c]],
                              CAT_CHROMA_DC, mbx, mby, 0, True, c)
            else:
                cdc[c] = _decode_block(enc_or_dec, cx, st, 4,
                                       CAT_CHROMA_DC, mbx, mby, 0, True, c)
    else:
        for c in range(2):
            st.set_cbf(CAT_CHROMA_DC, mbx, mby, 0, 0, c)
    for c in range(2):
        for blk in range(4):
            if cbp_chroma == 2:
                if encode:
                    _encode_block(enc_or_dec, cx, st,
                                  [int(x) for x in cac[c][blk, 1:]],
                                  CAT_CHROMA_AC, mbx, mby, blk, True, c)
                else:
                    cac[c, blk, 1:] = _decode_block(
                        enc_or_dec, cx, st, 15, CAT_CHROMA_AC,
                        mbx, mby, blk, True, c)
            else:
                st.set_cbf(CAT_CHROMA_AC, mbx, mby, blk, 0, c)
    if not encode:
        return dc_zz, ac, cdc, cac


# ---------------------------------------------------------------------------
# Slice writers
# ---------------------------------------------------------------------------


def _p_residual(ed, cx, st, mbx, mby, *, encode, cbp_l, cbp_c,
                luma=None, cdc=None, cac=None, t8=False):
    """LumaLevel4x4 (or 8x8 when ``t8``) + chroma residual walk for an
    inter MB. With t8, luma rows 4b..4b+4 hold 8x8 block b's 64-scan."""
    if not encode:
        luma = np.zeros((16, 16), np.int32)
        cdc = np.zeros((2, 4), np.int32)
        cac = np.zeros((2, 4, 16), np.int32)
    if t8:
        for b8 in range(4):
            bit = (cbp_l >> b8) & 1
            if bit:
                if encode:
                    scan = [int(x)
                            for x in luma[4 * b8:4 * b8 + 4].reshape(64)]
                    _encode_block8(ed, cx, scan)
                else:
                    luma[4 * b8:4 * b8 + 4] = \
                        _decode_block8(ed, cx).reshape(4, 16)
            # neighbor cbf state: every 4x4 position of the 8x8 block
            # carries its coded_block_flag (spec 9.3.3.1.1.9 for t8
            # neighbors)
            gy, gx = 4 * mby + 2 * (b8 // 2), 4 * mbx + 2 * (b8 % 2)
            st.cbf_l4[gy:gy + 2, gx:gx + 2] = bit
    else:
        for blk in range(16):
            b8 = (blk // 4)            # LUMA_BLK_ORDER groups by 8x8
            if (cbp_l >> b8) & 1:
                if encode:
                    _encode_block(ed, cx, st, [int(x) for x in luma[blk]],
                                  CAT_LUMA4, mbx, mby, blk, False)
                else:
                    luma[blk] = _decode_block(ed, cx, st, 16, CAT_LUMA4,
                                              mbx, mby, blk, False)
            else:
                st.set_cbf(CAT_LUMA4, mbx, mby, blk, 0)
    if cbp_c:
        for c in range(2):
            if encode:
                _encode_block(ed, cx, st, [int(x) for x in cdc[c]],
                              CAT_CHROMA_DC, mbx, mby, 0, False, c)
            else:
                cdc[c] = _decode_block(ed, cx, st, 4, CAT_CHROMA_DC,
                                       mbx, mby, 0, False, c)
    else:
        for c in range(2):
            st.set_cbf(CAT_CHROMA_DC, mbx, mby, 0, 0, c)
    for c in range(2):
        for blk in range(4):
            if cbp_c == 2:
                if encode:
                    _encode_block(ed, cx, st,
                                  [int(x) for x in cac[c][blk, 1:]],
                                  CAT_CHROMA_AC, mbx, mby, blk, False, c)
                else:
                    cac[c, blk, 1:] = _decode_block(
                        ed, cx, st, 15, CAT_CHROMA_AC, mbx, mby, blk,
                        False, c)
            else:
                st.set_cbf(CAT_CHROMA_AC, mbx, mby, blk, 0, c)
    if not encode:
        return luma, cdc, cac


# ---------------------------------------------------------------------------
# Slice parsers (decoder side)
# ---------------------------------------------------------------------------

def _decode_chroma_mode(dec, cx, st, mbx, mby) -> int:
    cm_ctx = st.chroma_mode_ctx(mbx, mby)
    chroma_mode = 0
    if dec.decode(cx["chroma_mode", cm_ctx]):
        chroma_mode = 1
        while chroma_mode < 3 and dec.decode(cx["chroma_mode", 3]):
            chroma_mode += 1
    return chroma_mode


def _decode_cbp(dec, cx, st, mbx, mby) -> int:
    cbp_l = 0
    for b8 in range(4):
        bit = dec.decode(cx["cbp_l", st.cbp_luma_ctx(mbx, mby, b8)])
        cbp_l |= bit << b8
        st.cbp_luma8[2 * mby + b8 // 2, 2 * mbx + b8 % 2] = bit
    cbp_c = 0
    if dec.decode(cx["cbp_c", st.cbp_chroma_ctx(mbx, mby, 0)]):
        cbp_c = 2 if dec.decode(
            cx["cbp_c", st.cbp_chroma_ctx(mbx, mby, 1)]) else 1
    st.cbp_chroma[mby, mbx] = cbp_c
    return cbp_l | (cbp_c << 4)


def _parse_i_nxn(dec, cx, st, mbx, mby, i4g, transform_8x8: bool):
    """I_NxN macroblock after the mb_type prefix bin: transform flag,
    per-block intra modes (predicted against the 4x4 mode grid ``i4g``),
    chroma mode, CBP, residuals. Returns the parsed dict (qp filled by
    the caller)."""
    st.intra[mby, mbx] = True
    st.i_nxn[mby, mbx] = True
    t8f = False
    if transform_8x8:
        t8f = bool(dec.decode(cx["t8flag", st.t8_ctx(mbx, mby)]))
    st.t8[mby, mbx] = t8f
    raw = _decode_intra_nxn_modes(dec, cx, 4 if t8f else 16)
    modes = np.zeros(16, np.int8)
    if t8f:
        for b8 in range(4):
            oy, ox = 2 * (b8 // 2), 2 * (b8 % 2)
            by, bx = 4 * mby + oy, 4 * mbx + ox
            if bx == 0 or by == 0:
                # spec 8.3.1.1: an UNAVAILABLE neighbor forces DC
                pred = 2
            else:
                a = i4g[by, bx - 1]   # -1 = decoded but not I_NxN -> DC
                b = i4g[by - 1, bx]
                pred = min(a if a >= 0 else 2, b if b >= 0 else 2)
            rem = raw[b8]
            mode = pred if rem is None else (rem if rem < pred else rem + 1)
            modes[4 * b8:4 * b8 + 4] = mode
            i4g[by:by + 2, bx:bx + 2] = mode
    else:
        for blk in range(16):
            oy = int(LUMA_BLK_ORDER[blk, 0])
            ox = int(LUMA_BLK_ORDER[blk, 1])
            by, bx = 4 * mby + oy, 4 * mbx + ox
            if bx == 0 or by == 0:
                pred = 2             # unavailable neighbor -> DC (8.3.1.1)
            else:
                a = i4g[by, bx - 1]
                b = i4g[by - 1, bx]
                pred = min(a if a >= 0 else 2, b if b >= 0 else 2)
            rem = raw[blk]
            mode = pred if rem is None else (rem if rem < pred else rem + 1)
            modes[blk] = mode
            i4g[by, bx] = mode
    chroma_mode = _decode_chroma_mode(dec, cx, st, mbx, mby)
    st.chroma_mode[mby, mbx] = chroma_mode
    cbp = _decode_cbp(dec, cx, st, mbx, mby)
    cbp_l, cbp_c = cbp & 15, cbp >> 4
    if cbp:
        delta = _decode_qp_delta(dec, cx, st)
    else:
        delta = 0
        st.last_qp_delta = 0     # inferred mb_qp_delta = 0 (9.3.3.1.1.5)

    luma = np.zeros((16, 16), np.int32)
    if t8f:
        for b8 in range(4):
            bit = (cbp_l >> b8) & 1
            if bit:
                luma[4 * b8:4 * b8 + 4] = \
                    _decode_block8(dec, cx).reshape(4, 16)
            gy, gx = 4 * mby + 2 * (b8 // 2), 4 * mbx + 2 * (b8 % 2)
            st.cbf_l4[gy:gy + 2, gx:gx + 2] = bit
    else:
        for blk in range(16):
            b8 = blk // 4
            if (cbp_l >> b8) & 1:
                luma[blk] = _decode_block(dec, cx, st, 16, CAT_LUMA4,
                                          mbx, mby, blk, True)
            else:
                st.set_cbf(CAT_LUMA4, mbx, mby, blk, 0)
    cdc = np.zeros((2, 4), np.int32)
    cac = np.zeros((2, 4, 16), np.int32)
    if cbp_c:
        for c in range(2):
            cdc[c] = _decode_block(dec, cx, st, 4, CAT_CHROMA_DC,
                                   mbx, mby, 0, True, c)
    else:
        for c in range(2):
            st.set_cbf(CAT_CHROMA_DC, mbx, mby, 0, 0, c)
    for c in range(2):
        for blk in range(4):
            if cbp_c == 2:
                cac[c, blk, 1:] = _decode_block(dec, cx, st, 15,
                                                CAT_CHROMA_AC, mbx, mby,
                                                blk, True, c)
            else:
                st.set_cbf(CAT_CHROMA_AC, mbx, mby, blk, 0, c)
    return dict(kind="i8" if t8f else "i4", modes=modes, luma=luma,
                chroma_mode=chroma_mode, cdc=cdc, cac=cac), delta


def parse_islice_cabac(payload: bytes, qp: int, n_mby: int, n_mbx: int,
                       transform_8x8: bool = False):
    """Parse an I-slice CABAC payload: I_16x16 and I_NxN (4x4/8x8)
    macroblocks with per-MB mb_qp_delta. Returns rows of parsed-MB
    dicts compatible with H264Decoder's recon path, plus the MbState
    (cbf grids double as the deblock nz source)."""
    dec = CabacDecoder(payload)
    cx = H264CabacContexts(qp)
    st = MbState(n_mby, n_mbx)
    rows = [[None] * n_mbx for _ in range(n_mby)]
    i4g = np.full((4 * n_mby, 4 * n_mbx), -1, np.int8)
    cur_qp = qp
    for mby in range(n_mby):
        for mbx in range(n_mbx):
            b0 = st.mbt_i_ctx(mbx, mby)
            if dec.decode(cx["mbt_i", b0]) == 0:
                parsed, delta = _parse_i_nxn(dec, cx, st, mbx, mby, i4g,
                                             transform_8x8)
                cur_qp = (cur_qp + delta + 52) % 52
                parsed["qp"] = cur_qp
            else:
                if dec.decode_terminate():
                    raise ValueError("I_PCM unsupported in CABAC slices")
                cbp_l15 = dec.decode(cx["mbt_i_tail", 0])
                cbp_c = 0
                if dec.decode(cx["mbt_i_tail", 1]):
                    cbp_c = 2 if dec.decode(cx["mbt_i_tail", 2]) else 1
                pred_mode = (dec.decode(cx["mbt_i_tail", 3]) << 1) | \
                    dec.decode(cx["mbt_i_tail", 4])
                chroma_mode = _decode_chroma_mode(dec, cx, st, mbx, mby)
                st.intra[mby, mbx] = True
                st.chroma_mode[mby, mbx] = chroma_mode
                st.cbp_luma8[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = \
                    1 if cbp_l15 else 0
                st.cbp_chroma[mby, mbx] = cbp_c
                cur_qp = (cur_qp + _decode_qp_delta(dec, cx, st) + 52) % 52
                dc_zz, ac, cdc, cac = _mb_i16_residual(
                    dec, cx, st, mbx, mby, encode=False,
                    cbp_luma15=bool(cbp_l15), cbp_chroma=cbp_c)
                rows[mby][mbx] = dict(pred_mode=pred_mode,
                                      chroma_mode=chroma_mode,
                                      dc_zz=dc_zz, ac=ac, cdc=cdc,
                                      cac=cac, qp=cur_qp)
            if rows[mby][mbx] is None:
                rows[mby][mbx] = parsed
            st.avail[mby, mbx] = True
            last = mby == n_mby - 1 and mbx == n_mbx - 1
            term = dec.decode_terminate()
            if term != (1 if last else 0):
                raise ValueError("CABAC I-slice MB count mismatch")
    return rows, st


# ---------------------------------------------------------------------------
# B slices (B_L0_16x16 / B_L1_16x16 / B_Bi_16x16; no direct/skip MBs)
# ---------------------------------------------------------------------------


