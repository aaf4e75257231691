"""HEVC residual_coding syntax (spec 7.3.8.11 / 9.3.4.2.5-9.3.3.13).

Copy of ``vcp_tpu/codec/h265/residual.py`` (host code).
"""

from __future__ import annotations

import numpy as np

from ..cabac import CabacDecoder, CabacEncoder
from .ctx import HevcContexts, coeff_scan, diag_scan

# 4x4 TB significance context map, indexed [4*yC + xC].
_CTX_IND_MAP_4x4 = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)

_C1FLAG_NUMBER = 8


def _sig_ctx_inc(x_c: int, y_c: int, log2: int, c_idx: int,
                 prev_csbf: int) -> int:
    """Context increment for sig_coeff_flag (spec 9.3.4.2.5), diagonal
    scan. prev_csbf = csbf(right) + 2*csbf(below)."""
    if log2 == 2:
        return _CTX_IND_MAP_4x4[4 * y_c + x_c]
    if x_c + y_c == 0:
        return 0
    x_p, y_p = x_c & 3, y_c & 3
    if prev_csbf == 0:
        s = x_p + y_p
        cnt = 2 if s == 0 else (1 if s < 3 else 0)
    elif prev_csbf == 1:
        cnt = 2 if y_p == 0 else (1 if y_p == 1 else 0)
    elif prev_csbf == 2:
        cnt = 2 if x_p == 0 else (1 if x_p == 1 else 0)
    else:
        cnt = 2
    if c_idx == 0 and (x_c >= 4 or y_c >= 4):
        cnt += 3
    offset = 9 if log2 == 3 else (21 if c_idx == 0 else 12)
    return cnt + offset


def _last_ctx_params(log2: int, c_idx: int):
    """(ctxOffset, ctxShift) for last_sig_coeff_{x,y}_prefix."""
    if c_idx == 0:
        return 3 * (log2 - 2) + ((log2 - 1) >> 2), (log2 + 1) >> 2
    return 15, log2 - 2


def _last_prefix_of(v: int) -> int:
    """Binarization prefix for a last-coefficient coordinate."""
    if v < 4:
        return v
    msb = v.bit_length() - 1
    return 2 * msb + ((v >> (msb - 1)) & 1)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def encode_residual(enc: CabacEncoder, cx: HevcContexts,
                    coeffs: np.ndarray, log2: int, c_idx: int) -> None:
    """Write residual_coding for one TB. ``coeffs`` is (N, N) [y][x] with
    at least one nonzero (the caller codes cbf)."""
    n = 1 << log2
    scan = coeff_scan(log2)
    last = -1
    for i in range(len(scan) - 1, -1, -1):
        x, y = scan[i]
        if coeffs[y][x]:
            last = i
            break
    assert last >= 0, "encode_residual requires a nonzero block"
    lx, ly = scan[last]

    off, shift = _last_ctx_params(log2, c_idx)
    cmax = (log2 << 1) - 1
    px, py = _last_prefix_of(lx), _last_prefix_of(ly)
    for name, p in (("last_x", px), ("last_y", py)):
        for b in range(p):
            enc.encode(cx[name, off + (b >> shift)], 1)
        if p < cmax:
            enc.encode(cx[name, off + (p >> shift)], 0)
    for p, v in ((px, lx), (py, ly)):
        if p > 3:
            nbits = (p >> 1) - 1
            enc.encode_bypass_bits(v & ((1 << nbits) - 1), nbits)

    n_sb_side = max(1, n // 4)
    sb_scan = diag_scan(n_sb_side)
    last_sb, last_pos = last >> 4, last & 15
    sub4 = diag_scan(4)

    # csbf map as the decoder will know it (actual significance)
    csbf = np.zeros((n_sb_side, n_sb_side), np.int32)
    for i in range(last_sb + 1):
        sx, sy = sb_scan[i]
        blk = coeffs[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4]
        csbf[sy, sx] = 1 if np.any(blk) else 0
    sx0, sy0 = sb_scan[0]
    sxl, syl = sb_scan[last_sb]
    csbf[syl, sxl] = 1          # inferred 1 at the last subblock
    csbf[sy0, sx0] = 1          # inferred 1 at the DC subblock

    c1 = 1                      # greater1 state carried across subblocks
    for i in range(last_sb, -1, -1):
        sx, sy = sb_scan[i]
        right = csbf[sy, sx + 1] if sx + 1 < n_sb_side else 0
        below = csbf[sy + 1, sx] if sy + 1 < n_sb_side else 0
        infer_dc = False
        if i == last_sb or i == 0:
            sb_flag = 1  # inferred (an empty DC subblock simply codes
            #              all-zero sig flags below)
        else:
            blk = coeffs[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4]
            sb_flag = 1 if np.any(blk) else 0
            ctx_inc = min(1, right + below) + (2 if c_idx else 0)
            enc.encode(cx["csbf", ctx_inc], sb_flag)
            infer_dc = True
        if not sb_flag:
            continue

        prev_csbf = (1 if right else 0) + (2 if below else 0)
        sig_set = "sig_chroma" if c_idx else "sig_luma"
        start = last_pos - 1 if i == last_sb else 15
        sig = [False] * 16
        if i == last_sb:
            sig[last_pos] = True
        for nn in range(start, -1, -1):
            px_, py_ = sub4[nn]
            x_c, y_c = sx * 4 + px_, sy * 4 + py_
            v = coeffs[y_c, x_c]
            if nn > 0 or not infer_dc:
                s = 1 if v else 0
                enc.encode(cx[sig_set, _sig_ctx_inc(
                    x_c, y_c, log2, c_idx, prev_csbf)], s)
                sig[nn] = bool(s)
                if s:
                    infer_dc = False
            else:
                # nn == 0 with inferSbDcSigCoeffFlag still set
                sig[0] = True
                assert v != 0, "inferred-significant DC must be nonzero"

        pos_list = [nn for nn in range(15, -1, -1) if sig[nn]]
        if not pos_list:
            continue
        abs_vals, signs = [], []
        for nn in pos_list:
            px_, py_ = sub4[nn]
            v = int(coeffs[sy * 4 + py_, sx * 4 + px_])
            abs_vals.append(abs(v))
            signs.append(1 if v < 0 else 0)

        ctx_set = (2 if (i > 0 and c_idx == 0) else 0)
        if c1 == 0:
            ctx_set += 1
        c1 = 1
        g1_set = "gr1_chroma" if c_idx else "gr1_luma"
        g2_set = "gr2_chroma" if c_idx else "gr2_luma"
        num_g1 = min(_C1FLAG_NUMBER, len(abs_vals))
        first_g2 = -1
        for idx in range(num_g1):
            v = 1 if abs_vals[idx] > 1 else 0
            enc.encode(cx[g1_set, ctx_set * 4 + c1], v)
            if v:
                c1 = 0
                if first_g2 < 0:
                    first_g2 = idx
            elif 0 < c1 < 3:
                c1 += 1
        if first_g2 >= 0:
            enc.encode(cx[g2_set, ctx_set], 1 if abs_vals[first_g2] > 2
                       else 0)
        for s in signs:
            enc.encode_bypass(s)

        rice = 0
        first_coeff2 = 1
        for idx, a in enumerate(abs_vals):
            # base saturation level expressible by the flags alone: 3
            # until the first abs>=2 coefficient has been processed
            # (that one carried the greater2 flag), 2 after, 1 past the
            # 8 greater1 slots.
            base = (2 + first_coeff2) if idx < num_g1 else 1
            if a >= base:
                _write_remain(enc, a - base, rice)
                if a > (3 << rice):
                    rice = min(rice + 1, 4)
            if a >= 2:
                first_coeff2 = 0


def _write_remain(enc: CabacEncoder, value: int, rice: int) -> None:
    """coeff_abs_level_remaining binarization (TR + EGk, bypass)."""
    q = value >> rice
    if q < 3:
        for _ in range(q):
            enc.encode_bypass(1)
        enc.encode_bypass(0)
        if rice:
            enc.encode_bypass_bits(value & ((1 << rice) - 1), rice)
    else:
        v = value - (3 << rice)
        k = 0
        while v >= (1 << (k + rice)):
            v -= 1 << (k + rice)
            k += 1
        for _ in range(3 + k):
            enc.encode_bypass(1)
        enc.encode_bypass(0)
        if k + rice:
            enc.encode_bypass_bits(v, k + rice)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_residual(dec: CabacDecoder, cx: HevcContexts, log2: int,
                    c_idx: int) -> np.ndarray:
    """Parse residual_coding for one TB; returns (N, N) int32 levels."""
    n = 1 << log2
    coeffs = np.zeros((n, n), np.int32)
    off, shift = _last_ctx_params(log2, c_idx)
    cmax = (log2 << 1) - 1

    def read_last_prefix(name):
        p = 0
        while p < cmax and dec.decode(cx[name, off + (p >> shift)]):
            p += 1
        return p

    px = read_last_prefix("last_x")
    py = read_last_prefix("last_y")

    def last_value(p, read_suffix):
        if p <= 3:
            return p
        nbits = (p >> 1) - 1
        suffix = read_suffix(nbits)
        return ((2 + (p & 1)) << nbits) + suffix

    lx = last_value(px, dec.decode_bypass_bits)
    ly = last_value(py, dec.decode_bypass_bits)

    scan = coeff_scan(log2)
    from .ctx import scan_pos_of
    if n == 4:
        last = scan_pos_of(4)[(lx, ly)]
    else:
        sb_pos = scan_pos_of(n // 4)[(lx // 4, ly // 4)]
        last = sb_pos * 16 + scan_pos_of(4)[(lx & 3, ly & 3)]

    n_sb_side = max(1, n // 4)
    sb_scan = diag_scan(n_sb_side)
    last_sb, last_pos = last >> 4, last & 15
    sub4 = diag_scan(4)
    csbf = np.zeros((n_sb_side, n_sb_side), np.int32)

    c1 = 1
    for i in range(last_sb, -1, -1):
        sx, sy = sb_scan[i]
        right = csbf[sy, sx + 1] if sx + 1 < n_sb_side else 0
        below = csbf[sy + 1, sx] if sy + 1 < n_sb_side else 0
        infer_dc = False
        if i == last_sb or i == 0:
            sb_flag = 1
        else:
            ctx_inc = min(1, right + below) + (2 if c_idx else 0)
            sb_flag = dec.decode(cx["csbf", ctx_inc])
            infer_dc = True
        csbf[sy, sx] = sb_flag
        if not sb_flag:
            continue

        prev_csbf = (1 if right else 0) + (2 if below else 0)
        sig_set = "sig_chroma" if c_idx else "sig_luma"
        start = last_pos - 1 if i == last_sb else 15
        sig = [False] * 16
        if i == last_sb:
            sig[last_pos] = True
        for nn in range(start, -1, -1):
            px_, py_ = sub4[nn]
            x_c, y_c = sx * 4 + px_, sy * 4 + py_
            if nn > 0 or not infer_dc:
                s = dec.decode(cx[sig_set, _sig_ctx_inc(
                    x_c, y_c, log2, c_idx, prev_csbf)])
                sig[nn] = bool(s)
                if s:
                    infer_dc = False
            else:
                sig[0] = True

        pos_list = [nn for nn in range(15, -1, -1) if sig[nn]]
        if not pos_list:
            continue
        num_sig = len(pos_list)
        ctx_set = (2 if (i > 0 and c_idx == 0) else 0)
        if c1 == 0:
            ctx_set += 1
        c1 = 1
        g1_set = "gr1_chroma" if c_idx else "gr1_luma"
        g2_set = "gr2_chroma" if c_idx else "gr2_luma"
        num_g1 = min(_C1FLAG_NUMBER, num_sig)
        g1 = [0] * num_sig
        first_g2 = -1
        for idx in range(num_g1):
            g1[idx] = dec.decode(cx[g1_set, ctx_set * 4 + c1])
            if g1[idx]:
                c1 = 0
                if first_g2 < 0:
                    first_g2 = idx
            elif 0 < c1 < 3:
                c1 += 1
        g2 = 0
        if first_g2 >= 0:
            g2 = dec.decode(cx[g2_set, ctx_set])
        signs = [dec.decode_bypass() for _ in range(num_sig)]

        rice = 0
        first_coeff2 = 1
        for idx in range(num_sig):
            level = 1
            if idx < num_g1:
                level += g1[idx]
                if idx == first_g2:
                    level += g2
            base = (2 + first_coeff2) if idx < num_g1 else 1
            if level == base:
                rem = _read_remain(dec, rice)
                level += rem
                if level > (3 << rice):
                    rice = min(rice + 1, 4)
            if level >= 2:
                first_coeff2 = 0
            nn = pos_list[idx]
            px_, py_ = sub4[nn]
            coeffs[sy * 4 + py_, sx * 4 + px_] = -level if signs[idx] \
                else level
    return coeffs


def _read_remain(dec: CabacDecoder, rice: int) -> int:
    p = 0
    while p < 32 and dec.decode_bypass():
        p += 1
    if p < 3:
        suffix = dec.decode_bypass_bits(rice) if rice else 0
        return (p << rice) + suffix
    k = p - 3
    suffix = dec.decode_bypass_bits(k + rice) if (k + rice) else 0
    return (((1 << k) + 2) << rice) + suffix
