"""Foreign HEVC decode: general intra (I-slice) reconstruction.

Copy of ``vcp_tpu/codec/h265/foreign.py`` (host code), the decoder
of HEVC inputs (``codec.ingest``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...utils.bitstream import BitReader
from ...ops import transform_hevc as th
from ..cabac import CabacDecoder, Context


class ForeignHevcError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Parameter sets (general parse, spec 7.3.2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FSps:
    width: int = 0
    height: int = 0
    conf_l: int = 0
    conf_r: int = 0
    conf_t: int = 0
    conf_b: int = 0
    log2_max_poc: int = 8
    log2_min_cb: int = 3
    log2_ctu: int = 6
    log2_min_tb: int = 2
    log2_max_tb: int = 5
    max_tdepth_inter: int = 0
    max_tdepth_intra: int = 0
    scaling_lists: bool = False
    amp: bool = False
    sao: bool = False
    pcm: bool = False
    temporal_mvp: bool = False
    strong_intra_smoothing: bool = False


@dataclasses.dataclass
class FPps:
    init_qp: int = 26
    sign_data_hiding: bool = False
    cabac_init_present: bool = False
    cu_qp_delta: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets: bool = False
    constrained_intra: bool = False
    transform_skip: bool = False
    transquant_bypass: bool = False
    tiles: bool = False
    entropy_sync: bool = False
    loop_filter_across_slices: bool = True
    deblocking_override_enabled: bool = False
    deblocking_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    output_flag_present: bool = False
    dependent_slices: bool = False
    num_extra_slice_bits: int = 0


def _skip_ptl(br, max_sub_layers: int = 0) -> None:
    br.u(2); br.u(1); br.u(5)
    br.u(32)
    br.u(1); br.u(1); br.u(1); br.u(1)
    br.u(32); br.u(12)                  # reserved 44 bits
    br.u(8)                              # level
    if max_sub_layers:
        raise ForeignHevcError("sub-layers unsupported")


def parse_sps_foreign(rbsp: bytes) -> FSps:
    br = BitReader(rbsp)
    br.u(4)                              # vps id
    max_sub = br.u(3)
    br.u(1)
    _skip_ptl(br, max_sub)
    s = FSps()
    br.ue()                              # sps id
    chroma = br.ue()
    if chroma != 1:
        raise ForeignHevcError(f"chroma_format_idc {chroma} unsupported")
    s.width = br.ue()
    s.height = br.ue()
    if br.u(1):                          # conformance window
        s.conf_l = br.ue() * 2
        s.conf_r = br.ue() * 2
        s.conf_t = br.ue() * 2
        s.conf_b = br.ue() * 2
    if br.ue() or br.ue():               # bit depths
        raise ForeignHevcError("only 8-bit streams supported")
    s.log2_max_poc = br.ue() + 4
    sub_order = br.u(1)
    for _ in range(max_sub + 1 if sub_order else 1):
        br.ue(); br.ue(); br.ue()
    s.log2_min_cb = br.ue() + 3
    s.log2_ctu = s.log2_min_cb + br.ue()
    s.log2_min_tb = br.ue() + 2
    s.log2_max_tb = s.log2_min_tb + br.ue()
    s.max_tdepth_inter = br.ue()
    s.max_tdepth_intra = br.ue()
    s.scaling_lists = bool(br.u(1))
    if s.scaling_lists:
        raise ForeignHevcError("scaling lists unsupported")
    s.amp = bool(br.u(1))
    s.sao = bool(br.u(1))
    s.pcm = bool(br.u(1))
    if s.pcm:
        raise ForeignHevcError("PCM unsupported")
    n_rps = br.ue()
    prev_deltas: list = []               # (delta_pocs, used) per set
    for i in range(n_rps):
        prev_deltas = _skip_st_rps(br, i, n_rps, prev_deltas)
    if br.u(1):                          # long_term_ref_pics_present
        for _ in range(br.ue()):
            br.u(s.log2_max_poc)
            br.u(1)
    s.temporal_mvp = bool(br.u(1))
    s.strong_intra_smoothing = bool(br.u(1))
    # VUI + extensions follow; nothing below is needed
    return s


def _skip_st_rps(br, idx: int, n_rps: int, prev):
    """Parse/skip one short-term RPS, tracking enough for the
    inter-prediction form (7.3.7)."""
    pred = br.u(1) if idx else 0
    if pred:
        # inter-RPS prediction against the previous set
        br.u(1)                          # delta_rps_sign
        br.ue()                          # abs_delta_rps_minus1
        n_prev = len(prev[-1]) if prev else 0
        for _ in range(n_prev + 1):
            if not br.u(1):              # used_by_curr_pic_flag
                br.u(1)                  # use_delta_flag
        return prev + [[0] * 1]          # count placeholder
    n_neg = br.ue()
    n_pos = br.ue()
    deltas = []
    for _ in range(n_neg + n_pos):
        br.ue()
        br.u(1)
        deltas.append(0)
    return prev + [deltas]


def parse_pps_foreign(rbsp: bytes) -> FPps:
    br = BitReader(rbsp)
    p = FPps()
    br.ue(); br.ue()                     # pps id, sps id
    p.dependent_slices = bool(br.u(1))
    p.output_flag_present = bool(br.u(1))
    p.num_extra_slice_bits = br.u(3)
    p.sign_data_hiding = bool(br.u(1))
    p.cabac_init_present = bool(br.u(1))
    br.ue(); br.ue()                     # num_ref_idx defaults
    p.init_qp = 26 + br.se()
    p.constrained_intra = bool(br.u(1))
    p.transform_skip = bool(br.u(1))
    p.cu_qp_delta = bool(br.u(1))
    if p.cu_qp_delta:
        p.diff_cu_qp_delta_depth = br.ue()
    p.cb_qp_offset = br.se()
    p.cr_qp_offset = br.se()
    p.slice_chroma_qp_offsets = bool(br.u(1))
    br.u(1); br.u(1)                     # weighted pred/bipred
    p.transquant_bypass = bool(br.u(1))
    p.tiles = bool(br.u(1))
    p.entropy_sync = bool(br.u(1))
    if p.tiles:
        raise ForeignHevcError("tiles unsupported")
    p.loop_filter_across_slices = bool(br.u(1))
    if br.u(1):                          # deblocking_filter_control_present
        p.deblocking_override_enabled = bool(br.u(1))
        p.deblocking_disabled = bool(br.u(1))
        if not p.deblocking_disabled:
            p.beta_offset_div2 = br.se()
            p.tc_offset_div2 = br.se()
    if br.u(1):                          # pps_scaling_list_data_present
        raise ForeignHevcError("PPS scaling lists unsupported")
    br.u(1)                              # lists_modification_present
    br.ue()                              # log2_parallel_merge_level_minus2
    br.u(1)                              # slice_header_extension
    return p


def parse_slice_header_foreign(br: BitReader, sps: FSps, pps: FPps,
                               nal_type: int):
    """I-slice header (7.3.6.1). Returns (slice_type, slice_qp)."""
    first = br.u(1)
    if not first:
        raise ForeignHevcError("multi-slice pictures unsupported")
    if 16 <= nal_type <= 23:             # IRAP
        br.u(1)                          # no_output_of_prior_pics
    br.ue()                              # slice_pic_parameter_set_id
    for _ in range(pps.num_extra_slice_bits):
        br.u(1)
    slice_type = br.ue()
    if slice_type != 2:
        raise ForeignHevcError("foreign HEVC inter slices unsupported")
    if pps.output_flag_present:
        br.u(1)
    if nal_type not in (19, 20):         # non-IDR intra (e.g. CRA)
        br.u(sps.log2_max_poc)           # poc lsb
        if not br.u(1):                  # short_term_ref_pic_set_sps_flag
            _skip_st_rps(br, 1, 2, [[0]])  # parse as explicit set
        # (num_short_term... index bits if sps sets exist — unsupported
        # combinations raise downstream via CABAC desync)
        if sps.temporal_mvp:
            br.u(1)
    sao_luma = sao_chroma = False
    if sps.sao:
        sao_luma = bool(br.u(1))
        sao_chroma = bool(br.u(1))
    slice_qp = pps.init_qp + br.se()
    if pps.slice_chroma_qp_offsets:
        br.se(); br.se()
    deblock_disabled = pps.deblocking_disabled
    if pps.deblocking_override_enabled and br.u(1):
        deblock_disabled = bool(br.u(1))
        if not deblock_disabled:
            br.se(); br.se()
    if pps.loop_filter_across_slices and not deblock_disabled:
        br.u(1)
    entry_points = []
    if pps.entropy_sync:
        n = br.ue()                      # num_entry_point_offsets
        if n:
            off_len = br.ue() + 1
            entry_points = [br.u(off_len) + 1 for _ in range(n)]
    br.u(1)                              # alignment bit
    br.byte_align()
    return (slice_type, slice_qp, deblock_disabled, entry_points,
            sao_luma, sao_chroma)


# ---------------------------------------------------------------------------
# CABAC contexts (9.3.2.2, initType 0 = I slices)
# ---------------------------------------------------------------------------

_INIT_I = {
    "split_cu": (139, 141, 157),
    "part_mode": (184,),
    "prev_intra": (184,),
    "chroma_mode": (63,),
    "split_tr": (153, 138, 138),
    "cbf_luma": (111, 141),
    "cbf_chroma": (94, 138, 182, 154),
    "qp_delta": (154, 154),
    "tskip": (139, 139),
    "last_x": (110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111,
               143, 127, 111, 79, 108, 123, 63),
    "last_y": (110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111,
               143, 127, 111, 79, 108, 123, 63),
    "csbf": (91, 171, 134, 141),
    "sig": (111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141,
            179, 153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141,
            179, 153, 125, 140, 139, 182, 182, 152, 136, 152, 136, 153,
            136, 139, 111, 136, 139, 111),
    "gt1": (140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92,
            139, 107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197),
    "gt2": (138, 153, 136, 167, 152, 152),
    "tq_bypass": (154,),
    "sao_merge": (153,),
    "sao_type": (200,),
}


class FCtx:
    def __init__(self, qp: int):
        self.t = {k: [Context.from_init_hevc(v, qp) for v in vals]
                  for k, vals in _INIT_I.items()}

    def __getitem__(self, key):
        name, i = key
        return self.t[name][i]


# ---------------------------------------------------------------------------
# Scan orders (6.5.3): diag (0), horizontal (1), vertical (2)
# ---------------------------------------------------------------------------

def _diag_scan(n: int):
    """Up-right diagonal scan order: list of (x, y)."""
    out = []
    x = y = 0
    stop = False
    while not stop:
        while y >= 0:
            if x < n and y < n:
                out.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
        if out and out[-1] == (n - 1, n - 1):
            stop = True
    return out


def _scan4(idx: int):
    if idx == 0:
        return _diag_scan(4)
    if idx == 1:                         # horizontal
        return [(x, y) for y in range(4) for x in range(4)]
    return [(x, y) for x in range(4) for y in range(4)]   # vertical


_SCAN4 = {i: _scan4(i) for i in (0, 1, 2)}


def _cg_scan(n_cg: int, idx: int):
    if idx == 0:
        return _diag_scan(n_cg)
    if idx == 1:
        return [(x, y) for y in range(n_cg) for x in range(n_cg)]
    return [(x, y) for x in range(n_cg) for y in range(n_cg)]


_SIG4_CTX = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)


# ---------------------------------------------------------------------------
# Residual coding (7.3.8.11 / 9.3.4.2.5-7), intra profile
# ---------------------------------------------------------------------------

def _decode_last_prefix(dec, cx, name, cmax, off, shift):
    v = 0
    while v < cmax and dec.decode(cx[name, off + (v >> shift)]):
        v += 1
    return v


def decode_residual(dec, cx, log2: int, c_idx: int, scan_idx: int,
                    sign_hiding: bool) -> np.ndarray:
    """One residual_coding() block → (n, n) int32 coefficients."""
    n = 1 << log2
    # ---- last significant coefficient position
    cmax = (log2 << 1) - 1
    if c_idx == 0:
        off, shift = 3 * (log2 - 2) + ((log2 - 1) >> 2), (log2 + 1) >> 2
    else:
        off, shift = 15, log2 - 2
    px = _decode_last_prefix(dec, cx, "last_x", cmax, off, shift)
    py = _decode_last_prefix(dec, cx, "last_y", cmax, off, shift)

    def suffix(prefix):
        if prefix <= 3:
            return prefix
        nbits = (prefix >> 1) - 1
        s = 0
        for _ in range(nbits):
            s = (s << 1) | dec.decode_bypass()
        return ((2 + (prefix & 1)) << nbits) + s

    last_x, last_y = suffix(px), suffix(py)
    if scan_idx == 2:
        last_x, last_y = last_y, last_x

    n_cg = n >> 2
    cg_order = _cg_scan(n_cg, scan_idx)
    pos_order = _SCAN4[scan_idx]
    # scan index of the last coefficient
    cg_of = {c: i for i, c in enumerate(cg_order)}
    pos_of = {p: i for i, p in enumerate(pos_order)}
    last_cg = cg_of[(last_x >> 2, last_y >> 2)]
    last_pos = pos_of[(last_x & 3, last_y & 3)]

    coeffs = np.zeros((n, n), np.int32)
    csbf = np.zeros((n_cg, n_cg), np.uint8)
    gt1_prev_cg = 0                      # greater1 seen in previous CG

    for cg_i in range(last_cg, -1, -1):
        sx, sy = cg_order[cg_i]
        infer_sb_dc = False
        if cg_i == last_cg or cg_i == 0:
            sb_coded = 1
        else:
            right = csbf[sy, sx + 1] if sx + 1 < n_cg else 0
            below = csbf[sy + 1, sx] if sy + 1 < n_cg else 0
            ctx = min(1, int(right) + int(below)) + (2 if c_idx else 0)
            sb_coded = dec.decode(cx["csbf", ctx])
            infer_sb_dc = True
        csbf[sy, sx] = sb_coded
        if not sb_coded:
            continue

        # ---- significance map (reverse scan within the CG)
        start = last_pos - 1 if cg_i == last_cg else 15
        sig_pos = [last_pos] if cg_i == last_cg else []
        decoded_any = bool(sig_pos)
        right = csbf[sy, sx + 1] if sx + 1 < n_cg else 0
        below = csbf[sy + 1, sx] if sy + 1 < n_cg else 0
        pattern = int(right) + 2 * int(below)
        for k in range(start, -1, -1):
            xp, yp = pos_order[k]
            if k == 0 and infer_sb_dc and not decoded_any:
                sig_pos.append(0)
                break
            xc, yc = (sx << 2) + xp, (sy << 2) + yp
            if log2 == 2:
                sig_ctx = _SIG4_CTX[(yp << 2) + xp]
            elif xc == 0 and yc == 0:
                sig_ctx = 0
            else:
                if pattern == 0:
                    s = xp + yp
                    sig_ctx = 2 if s == 0 else (1 if s < 3 else 0)
                elif pattern == 1:
                    sig_ctx = 2 if yp == 0 else (1 if yp == 1 else 0)
                elif pattern == 2:
                    sig_ctx = 2 if xp == 0 else (1 if xp == 1 else 0)
                else:
                    sig_ctx = 2
                if c_idx == 0:
                    if (sx, sy) != (0, 0):
                        sig_ctx += 3
                    if log2 == 3:
                        sig_ctx += 9 if scan_idx == 0 else 15
                    else:
                        sig_ctx += 21
                else:
                    sig_ctx += 9 if log2 == 3 else 12
            ctx_i = sig_ctx + (27 if c_idx else 0)
            if dec.decode(cx["sig", ctx_i]):
                sig_pos.append(k)
                decoded_any = True
        if not sig_pos:
            continue
        sig_pos.sort(reverse=True)       # reverse scan order

        # ---- levels
        n_flags = min(8, len(sig_pos))
        ctx_set = 0 if (cg_i == 0 or c_idx > 0) else 2
        if gt1_prev_cg:
            ctx_set += 1
        g1 = []
        g1_ctx = 1
        for k in range(n_flags):
            ci = ctx_set * 4 + min(3, g1_ctx)
            if c_idx:
                ci = 16 + ctx_set * 4 + min(3, g1_ctx)
            f = dec.decode(cx["gt1", ci])
            g1.append(f)
            if f:
                g1_ctx = 0
            elif g1_ctx:
                g1_ctx = min(3, g1_ctx + 1)
        gt1_prev_cg = 1 if any(g1) else 0
        first_g1 = g1.index(1) if 1 in g1 else -1
        g2 = 0
        if first_g1 >= 0:
            ci = ctx_set if c_idx == 0 else 4 + ctx_set
            g2 = dec.decode(cx["gt2", ci])

        # ---- signs (bypass), possibly hiding the last one
        first_scan = sig_pos[-1]
        last_scan = sig_pos[0]
        hide = sign_hiding and (last_scan - first_scan > 3)
        n_signs = len(sig_pos) - (1 if hide else 0)
        signs = [dec.decode_bypass() for _ in range(n_signs)]

        # ---- remainders (Rice)
        rice = 0
        levels = []
        for k, pos in enumerate(sig_pos):
            base = 1 + (g1[k] if k < n_flags else 0) \
                + (g2 if k == first_g1 else 0)
            thr = (3 if k == first_g1 else 2) if k < n_flags else 1
            lvl = base
            if base == thr:
                prefix = 0
                while dec.decode_bypass():
                    prefix += 1
                    if prefix > 40:
                        raise ForeignHevcError("rice prefix runaway")
                if prefix <= 3:
                    s = 0
                    for _ in range(rice):
                        s = (s << 1) | dec.decode_bypass()
                    rem = (prefix << rice) + s
                else:
                    nbits = prefix - 3 + rice
                    s = 0
                    for _ in range(nbits):
                        s = (s << 1) | dec.decode_bypass()
                    rem = (((1 << (prefix - 3)) + 3 - 1) << rice) + s
                lvl = base + rem
            if lvl > (3 << rice):
                rice = min(rice + 1, 4)
            levels.append(lvl)

        if hide:
            total = sum(levels)
            hidden_neg = total & 1
        for k, pos in enumerate(sig_pos):
            xp, yp = pos_order[pos]
            xc, yc = (sx << 2) + xp, (sy << 2) + yp
            if hide and k == len(sig_pos) - 1:
                neg = hidden_neg
            else:
                neg = signs[k]
            coeffs[yc, xc] = -levels[k] if neg else levels[k]
    return coeffs


# ---------------------------------------------------------------------------
# Intra prediction (8.4.4.2)
# ---------------------------------------------------------------------------

ANGLE = {2: 32, 3: 26, 4: 21, 5: 17, 6: 13, 7: 9, 8: 5, 9: 2, 10: 0,
         11: -2, 12: -5, 13: -9, 14: -13, 15: -17, 16: -21, 17: -26,
         18: -32, 19: -26, 20: -21, 21: -17, 22: -13, 23: -9, 24: -5,
         25: -2, 26: 0, 27: 2, 28: 5, 29: 9, 30: 13, 31: 17, 32: 21,
         33: 26, 34: 32}
INV_ANGLE = {-2: -4096, -5: -1638, -9: -910, -13: -630, -17: -482,
             -21: -390, -26: -315, -32: -256}


def _z_before(xa: int, ya: int, xb: int, yb: int, log2_ctu: int,
              ctus_w: int) -> bool:
    """True when position a is decoded before b (CTU raster + z-order
    within the CTU)."""
    ca = (ya >> log2_ctu) * ctus_w + (xa >> log2_ctu)
    cb = (yb >> log2_ctu) * ctus_w + (xb >> log2_ctu)
    if ca != cb:
        return ca < cb
    za = _z_index(xa & ((1 << log2_ctu) - 1), ya & ((1 << log2_ctu) - 1))
    zb = _z_index(xb & ((1 << log2_ctu) - 1), yb & ((1 << log2_ctu) - 1))
    return za < zb


def _z_index(x: int, y: int) -> int:
    z = 0
    for b in range(16):
        z |= ((x >> b) & 1) << (2 * b)
        z |= ((y >> b) & 1) << (2 * b + 1)
    return z


def intra_refs(plane: np.ndarray, x0: int, y0: int, n: int,
               log2_ctu: int, ctus_w: int, pw: int, ph: int):
    # pw/ph are the PICTURE dims (coded size, not the CTU-padded plane):
    # pad-region samples are never coded and must read as unavailable.
    """Reference arrays (left[2n], corner, top[2n]) with availability
    substitution (8.4.4.2.2). Coordinates are in the plane's units."""
    left = np.zeros(2 * n, np.int32)
    top = np.zeros(2 * n, np.int32)
    avail_l = np.zeros(2 * n, bool)
    avail_t = np.zeros(2 * n, bool)
    corner = 0
    avail_c = False

    def avail(xn, yn):
        if xn < 0 or yn < 0 or xn >= pw or yn >= ph:
            return False
        return _z_before(xn, yn, x0, y0, log2_ctu, ctus_w)

    for i in range(2 * n):
        yn = y0 + i
        if avail(x0 - 1, yn):
            left[i] = plane[yn, x0 - 1]
            avail_l[i] = True
        xn = x0 + i
        if avail(xn, y0 - 1):
            top[i] = plane[y0 - 1, xn]
            avail_t[i] = True
    if avail(x0 - 1, y0 - 1):
        corner = int(plane[y0 - 1, x0 - 1])
        avail_c = True

    if not avail_l.any() and not avail_t.any() and not avail_c:
        left[:] = 128
        top[:] = 128
        corner = 128
        return left, corner, top

    # substitution: scan from p[-1][2N-1] (bottom of left) upward, then
    # corner, then top left->right; unavailable samples copy the
    # previous scanned value (the first scanned, if unavailable, takes
    # the next available one)
    seq_vals = []
    seq_avail = []
    for i in range(2 * n - 1, -1, -1):
        seq_vals.append(int(left[i]))
        seq_avail.append(bool(avail_l[i]))
    seq_vals.append(corner)
    seq_avail.append(avail_c)
    for i in range(2 * n):
        seq_vals.append(int(top[i]))
        seq_avail.append(bool(avail_t[i]))
    if not seq_avail[0]:
        j = next(i for i, a in enumerate(seq_avail) if a)
        seq_vals[0] = seq_vals[j]
        seq_avail[0] = True
    for i in range(1, len(seq_vals)):
        if not seq_avail[i]:
            seq_vals[i] = seq_vals[i - 1]
    for i in range(2 * n):
        left[2 * n - 1 - i] = seq_vals[i]
    corner = seq_vals[2 * n]
    for i in range(2 * n):
        top[i] = seq_vals[2 * n + 1 + i]
    return left, corner, top


def _filter_refs(left, corner, top, n, mode, strong_ok: bool):
    """Reference smoothing (8.4.4.2.3), luma only."""
    if mode == 1 or n == 4:              # DC / 4x4: never filtered
        return left, corner, top
    min_dist = min(abs(mode - 26), abs(mode - 10))
    thres = {8: 7, 16: 1, 32: 0}.get(n, 8)
    if mode != 0 and min_dist <= thres:  # planar always filters (n>4)
        return left, corner, top
    if n == 32 and strong_ok:
        bi_l = abs(corner + int(left[2 * n - 1]) - 2 * int(left[n - 1])) \
            < 8
        bi_t = abs(corner + int(top[2 * n - 1]) - 2 * int(top[n - 1])) < 8
        if bi_l and bi_t:
            fl = np.zeros_like(left)
            ft = np.zeros_like(top)
            for i in range(2 * n):
                fl[i] = ((63 - i) * corner
                         + (i + 1) * int(left[2 * n - 1]) + 32) >> 6
                ft[i] = ((63 - i) * corner
                         + (i + 1) * int(top[2 * n - 1]) + 32) >> 6
            fl[2 * n - 1] = left[2 * n - 1]
            ft[2 * n - 1] = top[2 * n - 1]
            return fl, corner, ft
    fl = left.copy()
    ft = top.copy()
    fl[0] = (int(left[1]) + 2 * int(left[0]) + corner + 2) >> 2
    for i in range(1, 2 * n - 1):
        fl[i] = (int(left[i + 1]) + 2 * int(left[i])
                 + int(left[i - 1]) + 2) >> 2
        ft[i] = (int(top[i - 1]) + 2 * int(top[i])
                 + int(top[i + 1]) + 2) >> 2
    ft[0] = (corner + 2 * int(top[0]) + int(top[1]) + 2) >> 2
    fc = (int(left[0]) + 2 * corner + int(top[0]) + 2) >> 2
    return fl, fc, ft


def intra_pred(left, corner, top, n: int, mode: int,
               luma: bool) -> np.ndarray:
    """One prediction block from (possibly filtered) references."""
    out = np.zeros((n, n), np.int32)
    if mode == 0:                        # planar
        l_ = left[:n].astype(np.int64)
        t_ = top[:n].astype(np.int64)
        tr = int(top[n])
        bl = int(left[n])
        xs = np.arange(n)
        log2 = n.bit_length() - 1
        out = ((n - 1 - xs[None, :]) * l_[:, None]
               + (xs[None, :] + 1) * tr
               + (n - 1 - xs[:, None]) * t_[None, :]
               + (xs[:, None] + 1) * bl + n) >> (log2 + 1)
        return out.astype(np.int32)
    if mode == 1:                        # DC
        dc = (int(left[:n].sum()) + int(top[:n].sum()) + n) >> \
            (n.bit_length())
        out[:] = dc
        if luma and n < 32:
            out[0, 0] = (int(left[0]) + 2 * dc + int(top[0]) + 2) >> 2
            out[0, 1:] = (top[1:n] + 3 * dc + 2) >> 2
            out[1:, 0] = (left[1:n] + 3 * dc + 2) >> 2
        return out
    ang = ANGLE[mode]
    if mode >= 18:                       # vertical family
        ref = np.zeros(3 * n + 2, np.int32)   # ref[base + k] = p[k-1][-1]
        base = n
        ref[base] = corner
        ref[base + 1: base + 2 * n + 1] = top[:2 * n]
        ref[base + 2 * n + 1] = top[2 * n - 1]
        if ang < 0:
            inv = INV_ANGLE[ang]
            last = (n * ang) >> 5
            for x in range(-1, last - 1, -1):
                idx = min(2 * n - 1, max(0, ((x * inv + 128) >> 8) - 1))
                ref[base + x] = left[idx]
        for y in range(n):
            off = ((y + 1) * ang) >> 5
            frac = ((y + 1) * ang) & 31
            i0 = base + 1 + off
            a = ref[i0: i0 + n].astype(np.int64)
            b = ref[i0 + 1: i0 + n + 1].astype(np.int64)
            out[y] = ((32 - frac) * a + frac * b + 16) >> 5
        if mode == 26 and luma and n < 32:
            out[:, 0] = np.clip(
                int(top[0]) + ((left[:n].astype(np.int64) - corner) >> 1),
                0, 255)
        return out
    # horizontal family (2..17): transpose of the vertical logic
    ref = np.zeros(3 * n + 2, np.int32)
    base = n
    ref[base] = corner
    ref[base + 1: base + 2 * n + 1] = left[:2 * n]
    ref[base + 2 * n + 1] = left[2 * n - 1]
    if ang < 0:
        inv = INV_ANGLE[ang]
        last = (n * ang) >> 5
        for x in range(-1, last - 1, -1):
            idx = min(2 * n - 1, max(0, ((x * inv + 128) >> 8) - 1))
            ref[base + x] = top[idx]
    for x in range(n):
        off = ((x + 1) * ang) >> 5
        frac = ((x + 1) * ang) & 31
        i0 = base + 1 + off
        a = ref[i0: i0 + n].astype(np.int64)
        b = ref[i0 + 1: i0 + n + 1].astype(np.int64)
        out[:, x] = ((32 - frac) * a + frac * b + 16) >> 5
    if mode == 10 and luma and n < 32:
        out[0, :] = np.clip(
            int(left[0]) + ((top[:n].astype(np.int64) - corner) >> 1),
            0, 255)
    return out


# ---------------------------------------------------------------------------
# Slice decode: coding quadtree parse + interleaved TU recon
# ---------------------------------------------------------------------------

class IntraSliceDecoder:
    def __init__(self, sps: FSps, pps: FPps, slice_qp: int):
        if pps.transform_skip:
            raise ForeignHevcError("transform_skip unsupported yet")
        self.sps = sps
        self.pps = pps
        self.qp = slice_qp
        ctu = 1 << sps.log2_ctu
        self.pw = -(-sps.width // ctu) * ctu
        self.ph = -(-sps.height // ctu) * ctu
        self.ctus_w = self.pw >> sps.log2_ctu
        self.ctus_h = self.ph >> sps.log2_ctu
        self.y = np.zeros((self.ph, self.pw), np.int32)
        self.u = np.zeros((self.ph // 2, self.pw // 2), np.int32)
        self.v = np.zeros((self.ph // 2, self.pw // 2), np.int32)
        # per-min-CB (4x4 luma) grids for context derivation / deblock
        self.depth = np.zeros((self.ph // 4, self.pw // 4), np.int8)
        self.lmode = np.full((self.ph // 4, self.pw // 4), 1, np.int8)
        self.qp_map = np.full((self.ph // 4, self.pw // 4), slice_qp,
                              np.int8)
        self.tu_edge_v = np.zeros((self.ph // 4, self.pw // 4), bool)
        self.tu_edge_h = np.zeros((self.ph // 4, self.pw // 4), bool)
        # quantization-group state (8.6.1): per-QG predicted QP + the
        # parsed delta; qp_prev carries across QGs in decode order
        self.sao_luma = False
        self.sao_chroma = False
        # per-CTB SAO params: [cIdx][ctby][ctbx] = (type, offsets(4),
        # pos_or_class); type 0=off, 1=band, 2=edge
        self.sao = [[[None] * self.ctus_w for _ in range(self.ctus_h)]
                    for _ in range(3)]
        self.log2_qg = sps.log2_ctu - pps.diff_cu_qp_delta_depth
        self.qp_prev = slice_qp
        self.qg_xy = (0, 0)
        self.qp_delta_coded = False
        self.qp_delta_val = 0
        self.cu_qp = slice_qp

    # -- availability-aware mode prediction (8.4.2) -----------------------
    def _cand_mode(self, x: int, y: int, x0: int, y0: int,
                   above: bool) -> int:
        sps = self.sps
        if x < 0 or y < 0:
            return 1                     # DC
        if above and (y >> sps.log2_ctu) != (y0 >> sps.log2_ctu):
            return 1                     # above CTU row: treated DC
        if not _z_before(x, y, x0, y0, sps.log2_ctu, self.ctus_w):
            return 1
        return int(self.lmode[y >> 2, x >> 2])

    def decode(self, payload: bytes, entry_points=()):
        sps = self.sps
        cx = FCtx(self.qp)
        self.cx = cx
        if entry_points:
            # WPP: one byte-aligned substream per CTU row; contexts of
            # each row initialize from the snapshot taken after the
            # second CTU of the row above (9.3.1); the QP predictor
            # chain also restarts per row (8.6.1)
            if len(entry_points) != self.ctus_h - 1:
                raise ForeignHevcError("entry points != CTU rows - 1")
            starts = [0]
            for off in entry_points:
                starts.append(starts[-1] + off)
            starts.append(len(payload))
            snapshot = None
            for cy in range(self.ctus_h):
                sub = payload[starts[cy]:starts[cy + 1]]
                dec = CabacDecoder(sub)
                self.dec = dec
                if cy > 0 and snapshot is not None:
                    for name, states in snapshot.items():
                        for c, (st, mps) in zip(cx.t[name], states):
                            c.state, c.mps = st, mps
                # 8.6.1: the QP predictor chain restarts at each CTU
                # row under entropy sync (cu_qp feeds the next QG's
                # qp_prev, so both reset)
                self.qp_prev = self.qp
                self.cu_qp = self.qp
                for cx_i in range(self.ctus_w):
                    self._sao_params(cx_i, cy)
                    self._coding_quadtree(cx_i << sps.log2_ctu,
                                          cy << sps.log2_ctu,
                                          sps.log2_ctu, 0)
                    if cx_i == min(1, self.ctus_w - 1):
                        snapshot = {name: [(c.state, c.mps) for c in lst]
                                    for name, lst in cx.t.items()}
                    last_row = cx_i == self.ctus_w - 1
                    last_slice = last_row and cy == self.ctus_h - 1
                    # end_of_slice_segment_flag after every CTU, then
                    # end_of_subset_one_bit (==1) at each row end
                    if dec.decode_terminate() != (1 if last_slice
                                                  else 0):
                        raise ForeignHevcError("WPP CTU count mismatch")
                    if last_row and not last_slice:
                        if dec.decode_terminate() != 1:
                            raise ForeignHevcError(
                                "missing end_of_subset bit")
            return self.y, self.u, self.v
        dec = CabacDecoder(payload)
        self.dec = dec
        for cy in range(self.ctus_h):
            for cx_i in range(self.ctus_w):
                self._sao_params(cx_i, cy)
                x0 = cx_i << sps.log2_ctu
                y0 = cy << sps.log2_ctu
                self._coding_quadtree(x0, y0, sps.log2_ctu, 0)
                last = (cy == self.ctus_h - 1
                        and cx_i == self.ctus_w - 1)
                term = dec.decode_terminate()
                if term != (1 if last else 0):
                    raise ForeignHevcError("CTU count mismatch")
        return self.y, self.u, self.v

    def _sao_params(self, ctbx, ctby):
        """sao() syntax (7.3.8.3), one CTB; no-op when SAO is off."""
        if not (self.sao_luma or self.sao_chroma):
            return
        dec, cx = self.dec, self.cx
        if ctbx > 0 and dec.decode(cx["sao_merge", 0]):
            for c in range(3):
                self.sao[c][ctby][ctbx] = self.sao[c][ctby][ctbx - 1]
            return
        if ctby > 0 and dec.decode(cx["sao_merge", 0]):
            for c in range(3):
                self.sao[c][ctby][ctbx] = self.sao[c][ctby - 1][ctbx]
            return
        typ = [0, 0, 0]
        eo_class = [0, 0, 0]
        for c in range(3):
            if c == 0 and not self.sao_luma:
                continue
            if c > 0 and not self.sao_chroma:
                continue
            if c <= 1:
                t = 0
                if dec.decode(cx["sao_type", 0]):
                    t = 2 if dec.decode_bypass() else 1
                typ[c] = t
            else:
                typ[2] = typ[1]
            if typ[c] == 0:
                self.sao[c][ctby][ctbx] = (0, None, 0)
                continue
            offs = []
            for _ in range(4):
                a = 0
                while a < 7 and dec.decode_bypass():
                    a += 1
                offs.append(a)
            if typ[c] == 1:              # band
                for k in range(4):
                    if offs[k] and dec.decode_bypass():
                        offs[k] = -offs[k]
                pos = 0
                for _ in range(5):
                    pos = (pos << 1) | dec.decode_bypass()
                self.sao[c][ctby][ctbx] = (1, offs, pos)
            else:                        # edge: signs inferred
                if c == 0:
                    eo_class[0] = (dec.decode_bypass() << 1) \
                        | dec.decode_bypass()
                elif c == 1:
                    eo_class[1] = (dec.decode_bypass() << 1) \
                        | dec.decode_bypass()
                    eo_class[2] = eo_class[1]
                offs = [offs[0], offs[1], -offs[2], -offs[3]]
                self.sao[c][ctby][ctbx] = (2, offs, eo_class[c])

    def apply_sao(self, planes):
        """8.7.3: offsets applied to the deblocked picture, per CTB
        region per component (reads pre-SAO neighbors)."""
        if not (self.sao_luma or self.sao_chroma):
            return planes
        out = []
        ctu = 1 << self.sps.log2_ctu
        for c, plane in enumerate(planes):
            src = plane
            dst = plane.copy()
            sh = 0 if c == 0 else 1
            n = ctu >> sh
            ph, pw = plane.shape
            for ctby in range(self.ctus_h):
                for ctbx in range(self.ctus_w):
                    prm = self.sao[c][ctby][ctbx]
                    if prm is None or prm[0] == 0:
                        continue
                    t, offs, aux = prm
                    y0, x0 = ctby * n, ctbx * n
                    y1, x1 = min(y0 + n, ph), min(x0 + n, pw)
                    if y0 >= ph or x0 >= pw:
                        continue
                    reg = src[y0:y1, x0:x1].astype(np.int32)
                    if t == 1:           # band offset
                        band = (reg >> 3) - aux
                        add = np.zeros_like(reg)
                        for k in range(4):
                            add = np.where((band & 31) == k, offs[k],
                                           add)
                        dst[y0:y1, x0:x1] = np.clip(reg + add, 0, 255)
                        continue
                    # edge offset: neighbors from the pre-SAO picture,
                    # skipping samples whose neighbor leaves the pic
                    dy, dx = ((0, 1), (1, 0), (1, 1), (-1, 1))[aux]
                    yy0, xx0 = y0, x0
                    ys = np.arange(y0, y1)[:, None]
                    xs = np.arange(x0, x1)[None, :]
                    ya, xa = ys - dy, xs - dx
                    yb, xb = ys + dy, xs + dx
                    ok = ((ya >= 0) & (ya < ph) & (xa >= 0) & (xa < pw)
                          & (yb >= 0) & (yb < ph) & (xb >= 0)
                          & (xb < pw))
                    yac = np.clip(ya, 0, ph - 1)
                    xac = np.clip(xa, 0, pw - 1)
                    ybc = np.clip(yb, 0, ph - 1)
                    xbc = np.clip(xb, 0, pw - 1)
                    a = src[yac, xac].astype(np.int32)
                    b = src[ybc, xbc].astype(np.int32)
                    idx = 2 + np.sign(reg - a) + np.sign(reg - b)
                    add = np.zeros_like(reg)
                    for eidx, k in ((0, 0), (1, 1), (3, 2), (4, 3)):
                        add = np.where(idx == eidx, offs[k], add)
                    add = np.where(ok, add, 0)
                    dst[y0:y1, x0:x1] = np.clip(reg + add, 0, 255)
            out.append(dst)
        return tuple(out)

    def _coding_quadtree(self, x0, y0, log2_cb, depth):
        sps, dec, cx = self.sps, self.dec, self.cx
        if self.pps.cu_qp_delta and log2_cb >= self.log2_qg:
            # new quantization group: qp_prev advances to the previous
            # group's final CU QP before the predictor uses it
            self.qp_prev = self.cu_qp
            self.qg_xy = (x0, y0)
            self.qp_delta_coded = False
            self.qp_delta_val = 0
        n = 1 << log2_cb
        inside = (x0 + n <= sps.width) and (y0 + n <= sps.height)
        if inside and log2_cb > sps.log2_min_cb:
            ctx = 0
            if x0 > 0 and _z_before(x0 - 1, y0, x0, y0, sps.log2_ctu,
                                    self.ctus_w):
                ctx += int(self.depth[y0 >> 2, (x0 - 1) >> 2] > depth)
            if y0 > 0 and _z_before(x0, y0 - 1, x0, y0, sps.log2_ctu,
                                    self.ctus_w):
                ctx += int(self.depth[(y0 - 1) >> 2, x0 >> 2] > depth)
            split = dec.decode(cx["split_cu", ctx])
        else:
            split = 1 if (log2_cb > sps.log2_min_cb or not inside) else 0
        if split:
            h = n >> 1
            for (dy, dx) in ((0, 0), (0, h), (h, 0), (h, h)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 < sps.width and y1 < sps.height:
                    self._coding_quadtree(x1, y1, log2_cb - 1, depth + 1)
            return
        self._coding_unit(x0, y0, log2_cb, depth)

    def _decode_qp_delta(self) -> int:
        dec, cx = self.dec, self.cx
        if not dec.decode(cx["qp_delta", 0]):
            return 0
        mag = 1
        while mag < 5 and dec.decode(cx["qp_delta", 1]):
            mag += 1
        if mag == 5:                     # EG0 bypass suffix
            k = 0
            while dec.decode_bypass():
                k += 1
                if k > 30:
                    raise ForeignHevcError("qp_delta EG runaway")
            suf = 0
            for _ in range(k):
                suf = (suf << 1) | dec.decode_bypass()
            mag = 5 + (1 << k) - 1 + suf
        return -mag if dec.decode_bypass() else mag

    def _cu_qp_pred(self):
        """qPY_PRED (8.6.1): left/above of the QG when in the same CTB,
        else the previous group's QP."""
        xq, yq = self.qg_xy
        ctb = 1 << self.sps.log2_ctu
        qa = qb = self.qp_prev
        if xq % ctb != 0 and xq > 0:
            qa = int(self.qp_map[yq >> 2, (xq - 1) >> 2])
        if yq % ctb != 0 and yq > 0:
            qb = int(self.qp_map[(yq - 1) >> 2, xq >> 2])
        return (qa + qb + 1) >> 1

    def _coding_unit(self, x0, y0, log2_cb, depth):
        sps, pps, dec, cx = self.sps, self.pps, self.dec, self.cx
        n = 1 << log2_cb
        if pps.cu_qp_delta:
            self.cu_qp = (self._cu_qp_pred() + self.qp_delta_val
                          + 52) % 52
        else:
            self.cu_qp = self.qp
        self.qp_map[y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2] = \
            self.cu_qp
        self.cu_origin = (x0, y0, n)
        if pps.transquant_bypass and dec.decode(cx["tq_bypass", 0]):
            raise ForeignHevcError("transquant bypass unsupported")
        # I slice: pred_mode inferred intra; part_mode only at min CB
        part_nxn = False
        if log2_cb == sps.log2_min_cb:
            part_nxn = dec.decode(cx["part_mode", 0]) == 0
        n_pu = 4 if part_nxn else 1
        half = n >> 1

        prev_flags = [dec.decode(cx["prev_intra", 0])
                      for _ in range(n_pu)]
        modes = []
        pu_xy = [(x0, y0)] if not part_nxn else [
            (x0, y0), (x0 + half, y0), (x0, y0 + half),
            (x0 + half, y0 + half)]
        for i in range(n_pu):
            px, py = pu_xy[i]
            cand_a = self._cand_mode(px - 1, py, px, py, False)
            cand_b = self._cand_mode(px, py - 1, px, py, True)
            if cand_a == cand_b:
                if cand_a < 2:
                    mpm = [0, 1, 26]
                else:
                    mpm = [cand_a, 2 + ((cand_a + 29) % 32),
                           2 + ((cand_a - 2 + 1) % 32)]
            else:
                mpm = [cand_a, cand_b]
                if 0 not in mpm:
                    mpm.append(0)
                elif 1 not in mpm:
                    mpm.append(1)
                else:
                    mpm.append(26)
            if prev_flags[i]:
                idx = 0
                if dec.decode_bypass():
                    idx = 1 + dec.decode_bypass()
                mode = mpm[idx]
            else:
                rem = 0
                for _ in range(5):
                    rem = (rem << 1) | dec.decode_bypass()
                mode = rem
                for c in sorted(mpm):
                    if mode >= c:
                        mode += 1
            modes.append(mode)
            # record for later PUs' prediction within this CU
            s = half if part_nxn else n
            self.lmode[py >> 2:(py + s) >> 2, px >> 2:(px + s) >> 2] = mode
        # chroma mode (one for the CU in 4:2:0)
        if dec.decode(cx["chroma_mode", 0]):
            idx = (dec.decode_bypass() << 1) | dec.decode_bypass()
            cand = [0, 26, 10, 1]
            cmode = cand[idx]
            if cmode == modes[0]:
                cmode = 34
        else:
            cmode = modes[0]             # DM
        self.depth[y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2] = depth

        # ---- transform tree + interleaved recon
        max_depth = sps.max_tdepth_intra + (1 if part_nxn else 0)
        self._transform_tree(x0, y0, x0, y0, log2_cb, 0, 0, max_depth,
                             part_nxn, modes, cmode,
                             parent_cbf_cb=1, parent_cbf_cr=1)

    def _transform_tree(self, x0, y0, xb, yb, log2_tr, tdepth, blk_idx,
                        max_depth, part_nxn, modes, cmode,
                        parent_cbf_cb, parent_cbf_cr):
        sps, dec, cx = self.sps, self.dec, self.cx
        intra_split = part_nxn
        if log2_tr <= sps.log2_max_tb and log2_tr > sps.log2_min_tb \
                and tdepth < max_depth \
                and not (intra_split and tdepth == 0):
            split = dec.decode(cx["split_tr", 5 - log2_tr])
        else:
            split = 1 if (log2_tr > sps.log2_max_tb
                          or (intra_split and tdepth == 0
                              and log2_tr > sps.log2_min_tb)) else 0
        cbf_cb = parent_cbf_cb
        cbf_cr = parent_cbf_cr
        if log2_tr > 2:
            if tdepth == 0 or parent_cbf_cb:
                cbf_cb = dec.decode(cx["cbf_chroma", tdepth])
            if tdepth == 0 or parent_cbf_cr:
                cbf_cr = dec.decode(cx["cbf_chroma", tdepth])
        if split:
            h = 1 << (log2_tr - 1)
            for i, (dy, dx) in enumerate(((0, 0), (0, h), (h, 0),
                                          (h, h))):
                self._transform_tree(x0 + dx, y0 + dy, x0, y0,
                                     log2_tr - 1, tdepth + 1, i,
                                     max_depth, part_nxn, modes, cmode,
                                     cbf_cb, cbf_cr)
            return
        # leaf: cbf_luma (intra: always coded)
        cbf_luma = dec.decode(cx["cbf_luma", 1 if tdepth == 0 else 0])
        self._transform_unit(x0, y0, xb, yb, log2_tr, tdepth, blk_idx,
                             part_nxn, modes, cmode, cbf_luma, cbf_cb,
                             cbf_cr)

    def _luma_mode_at(self, x, y, part_nxn, modes, x0cu=None):
        if not part_nxn:
            return modes[0]
        return int(self.lmode[y >> 2, x >> 2])

    def _scan_idx(self, mode, log2, c_idx):
        if (c_idx == 0 and log2 in (2, 3)) or (c_idx and log2 == 2):
            if 6 <= mode <= 14:
                return 2
            if 22 <= mode <= 30:
                return 1
        return 0

    def _recon_tu(self, plane, x, y, n, mode, coeffs, qp, c_idx,
                  luma: bool):
        sps = self.sps
        lctu = sps.log2_ctu - (0 if luma else 1)
        pic_w = sps.width if luma else sps.width // 2
        pic_h = sps.height if luma else sps.height // 2
        left, corner, top = intra_refs(plane, x, y, n, lctu,
                                       self.ctus_w, pic_w, pic_h)
        if luma:
            left, corner, top = _filter_refs(
                left, corner, top, n, mode,
                sps.strong_intra_smoothing)
        pred = intra_pred(left, corner, top, n, mode, luma)
        if coeffs is None:
            res = 0
        else:
            log2 = n.bit_length() - 1
            d = th.dequant_np(coeffs[None], qp, log2)[0]
            if luma and n == 4:
                res = _inv_dst4_np(d)
            else:
                res = th.inv_np(d[None], log2)[0]
        plane[y:y + n, x:x + n] = np.clip(pred + res, 0, 255)

    def _transform_unit(self, x0, y0, xb, yb, log2_tr, tdepth, blk_idx,
                        part_nxn, modes, cmode, cbf_luma, cbf_cb,
                        cbf_cr):
        dec, cx, pps = self.dec, self.cx, self.pps
        n = 1 << log2_tr
        if pps.cu_qp_delta and not self.qp_delta_coded \
                and (cbf_luma or cbf_cb or cbf_cr):
            self.qp_delta_val = self._decode_qp_delta()
            self.qp_delta_coded = True
            self.cu_qp = (self._cu_qp_pred() + self.qp_delta_val
                          + 52) % 52
            cx0, cy0, cn = self.cu_origin
            self.qp_map[cy0 >> 2:(cy0 + cn) >> 2,
                        cx0 >> 2:(cx0 + cn) >> 2] = self.cu_qp
        qp = self.cu_qp if pps.cu_qp_delta else self.qp
        qpc_cb = th.chroma_qp(qp, pps.cb_qp_offset)
        qpc_cr = th.chroma_qp(qp, pps.cr_qp_offset)
        lmode = self._luma_mode_at(x0, y0, part_nxn, modes)

        cy = None
        if cbf_luma:
            scan = self._scan_idx(lmode, log2_tr, 0)
            cy = decode_residual(dec, cx, log2_tr, 0, scan,
                                 pps.sign_data_hiding)
        self._recon_tu(self.y, x0, y0, n, lmode, cy, qp, 0, True)
        self.tu_edge_v[y0 >> 2:(y0 + n) >> 2, x0 >> 2] = True
        self.tu_edge_h[y0 >> 2, x0 >> 2:(x0 + n) >> 2] = True

        # chroma at the 8x8-luma level: for log2 == 2, only blk 3 codes
        # the shared 4x4 chroma TU (positioned at the parent block)
        if log2_tr > 2:
            xc, yc, nc = x0 >> 1, y0 >> 1, n >> 1
            log2c = log2_tr - 1
        elif blk_idx == 3:
            xc, yc, nc = xb >> 1, yb >> 1, 4
            log2c = 2
        else:
            return
        scan_c = self._scan_idx(cmode, log2c, 1)
        ccb = decode_residual(dec, cx, log2c, 1, scan_c,
                              pps.sign_data_hiding) if cbf_cb else None
        ccr = decode_residual(dec, cx, log2c, 2, scan_c,
                              pps.sign_data_hiding) if cbf_cr else None
        self._recon_tu(self.u, xc, yc, nc, cmode, ccb, qpc_cb, 1, False)
        self._recon_tu(self.v, xc, yc, nc, cmode, ccr, qpc_cr, 2, False)


# DST-VII 4x4 (intra luma), spec 8.6.4.2
_DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29],
], np.int64)


def _inv_dst4_np(coeffs: np.ndarray) -> np.ndarray:
    e = np.einsum("ky,kx->yx", _DST4, coeffs.astype(np.int64))
    e = np.clip((e + 64) >> 7, -32768, 32767)
    r = np.einsum("lx,yl->yx", _DST4, e)
    return ((r + (1 << 11)) >> 12).astype(np.int32)


# ---------------------------------------------------------------------------
# Stream-level decode (NAL units in, pictures out)
# ---------------------------------------------------------------------------

class ForeignHevcDecoder:
    """Intra-only foreign HEVC decoder (one slice per picture)."""

    def __init__(self):
        self.sps: FSps | None = None
        self.pps: FPps | None = None

    def decode_nal(self, nal: bytes):
        from ...utils.bitstream import emulation_remove
        nal_type = (nal[0] >> 1) & 0x3F
        rbsp = emulation_remove(nal[2:])
        if nal_type == 33:
            self.sps = parse_sps_foreign(rbsp)
            return None
        if nal_type == 34:
            self.pps = parse_pps_foreign(rbsp)
            return None
        if nal_type in (32, 35, 39, 40):  # VPS / AUD / SEI
            return None
        if nal_type <= 31:                # slice NAL
            if self.sps is None or self.pps is None:
                raise ForeignHevcError("slice before parameter sets")
            br = BitReader(rbsp)
            (_, slice_qp, _dbd, eps, sao_l,
             sao_c) = parse_slice_header_foreign(
                br, self.sps, self.pps, nal_type)
            payload = rbsp[br.pos // 8:]
            sd = IntraSliceDecoder(self.sps, self.pps, slice_qp)
            sd.sao_luma, sd.sao_chroma = sao_l, sao_c
            y, u, v = sd.decode(payload, eps)
            if not _dbd:
                y, u, v = deblock_foreign_intra(
                    y, u, v, self.sps, self.pps, sd.qp_map,
                    sd.tu_edge_v, sd.tu_edge_h)
            else:
                h_, w_ = self.sps.height, self.sps.width
                y = y[:h_, :w_]
                u = u[:h_ // 2, :w_ // 2]
                v = v[:h_ // 2, :w_ // 2]
            y, u, v = sd.apply_sao((y, u, v))
            w = self.sps.width - self.sps.conf_r
            h = self.sps.height - self.sps.conf_b
            x0, y0 = self.sps.conf_l, self.sps.conf_t
            return (y[y0:h, x0:w].astype(np.uint8),
                    u[y0 // 2:h // 2, x0 // 2:w // 2].astype(np.uint8),
                    v[y0 // 2:h // 2, x0 // 2:w // 2].astype(np.uint8))
        raise ForeignHevcError(f"NAL type {nal_type} unsupported")


# ---------------------------------------------------------------------------
# Read-side deblocking for foreign intra pictures (spec 8.7.2): every
# TU/CU edge on the 8x8 grid carries bS 2; per-edge QP from the CU QP
# map (AQ streams), per-segment beta/tc. Reuses the filter cores from
# ops.deblock_hevc (oracle-pinned by the encoder conformance tests).
# ---------------------------------------------------------------------------

def deblock_foreign_intra(y, u, v, sps: FSps, pps: FPps, qp_map4,
                          tu_v, tu_h):
    from ...ops.deblock_hevc import (BETA_TABLE, TC_TABLE,
                                     _chroma_edge_filter,
                                     _luma_edge_filter)
    h, w = sps.height, sps.width
    yc = y[:h, :w].copy()
    uc = u[:h // 2, :w // 2].copy()
    vc = v[:h // 2, :w // 2].copy()
    q4 = qp_map4[:h // 4, :w // 4].astype(np.int32)
    b_off = 2 * pps.beta_offset_div2
    t_off = 2 * pps.tc_offset_div2

    def luma_dir(plane, tu_edges, qmap):
        hh, ww = plane.shape
        ne = ww // 8 - 1
        blocks = plane.reshape(hh, ww // 8, 8)
        p = blocks[:, :-1, 4:8].reshape(hh // 4, 4, ne, 4) \
            .transpose(2, 0, 1, 3)
        q = blocks[:, 1:, 0:4].reshape(hh // 4, 4, ne, 4) \
            .transpose(2, 0, 1, 3)
        # bs/beta/tc per (edge, 4-line segment)
        edge_cols = 2 * (np.arange(ne) + 1)          # tu grid cols (x/4)
        bs = np.where(tu_edges[:, edge_cols].T, 2, 0)   # (ne, H/4)
        q_l = qmap[:, edge_cols - 1].T
        q_r = qmap[:, edge_cols].T
        q_av = (q_l + q_r + 1) >> 1
        beta = BETA_TABLE[np.clip(q_av + b_off, 0, 51)]
        tc = TC_TABLE[np.clip(q_av + 2 + t_off, 0, 53)]
        pf, qf = _luma_edge_filter(p, q, bs, beta, tc, np)
        pf = pf.transpose(1, 2, 0, 3).reshape(hh, ne, 4)
        qf = qf.transpose(1, 2, 0, 3).reshape(hh, ne, 4)
        blocks = blocks.copy()
        blocks[:, :-1, 4:8] = pf
        blocks[:, 1:, 0:4] = qf
        return blocks.reshape(hh, ww)

    tv = tu_v[:h // 4, :w // 4]
    thh = tu_h[:h // 4, :w // 4]
    yc = luma_dir(yc, tv, q4)
    yc = luma_dir(yc.T, thh.T, q4.T).T

    def chroma_dir(plane, tu_edges, qmap, c_off):
        hh, ww = plane.shape                          # chroma dims
        # chroma planes are only guaranteed multiples of 4; pad the
        # width to 8 for the block view (pad columns are never edges)
        ww8 = -(-ww // 8) * 8
        if ww8 != ww:
            plane = np.pad(plane, ((0, 0), (0, ww8 - ww)), mode="edge")
        ne = ww8 // 8 - 1
        blocks = plane.reshape(hh, ww8 // 8, 8)
        p = blocks[:, :-1, 6:8].transpose(1, 0, 2)    # (ne, Hc, 2)
        q = blocks[:, 1:, 0:2].transpose(1, 0, 2)
        # chroma edge at chroma x = 8(m+1) <-> luma x = 16(m+1)
        edge_cols = 4 * (np.arange(ne) + 1)
        rows4 = np.arange(hh) >> 1                    # chroma line -> row4
        bs = np.where(tu_edges[rows4][:, edge_cols].T, 2, 0)  # (ne, Hc)
        q_l = qmap[rows4][:, edge_cols - 1].T
        q_r = qmap[rows4][:, edge_cols].T
        q_av = (q_l + q_r + 1) >> 1
        from ...ops.transform_hevc import chroma_qp as _cqp
        qpc = np.asarray([_cqp(int(qq), c_off)
                          for qq in range(52)], np.int32)[
            np.clip(q_av, 0, 51)]
        tc = TC_TABLE[np.clip(qpc + 2 + t_off, 0, 53)]
        pf, qf = _chroma_edge_filter(p, q, bs, tc, np)
        blocks = blocks.copy()
        blocks[:, :-1, 6:8] = pf.transpose(1, 0, 2)
        blocks[:, 1:, 0:2] = qf.transpose(1, 0, 2)
        return blocks.reshape(hh, ww8)[:, :ww]

    uc = chroma_dir(uc, tv, q4, pps.cb_qp_offset)
    uc = chroma_dir(uc.T, thh.T, q4.T, pps.cb_qp_offset).T
    vc = chroma_dir(vc, tv, q4, pps.cr_qp_offset)
    vc = chroma_dir(vc.T, thh.T, q4.T, pps.cr_qp_offset).T
    return yc, uc, vc
