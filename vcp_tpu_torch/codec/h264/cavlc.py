"""CAVLC residual block coding (ITU-T H.264 9.2), encoder and decoder;
copy of ``vcp_tpu/codec/h264/cavlc.py``. The host decoder reads CAVLC
residuals through ``decode_residual_block``.

A residual block is passed as its zig-zag-ordered coefficient list
(length = maxNumCoeff: 16 for luma 4x4 / chroma AC uses 15, Intra16x16 AC
uses 15, luma DC 16, chroma DC 4). ``nc`` is the standard context:
predicted nonzero count from neighbors, or -1 for chroma DC."""

from __future__ import annotations

from ...utils.bitstream import BitReader, BitWriter
from . import tables as T


def encode_residual_block(bw: BitWriter, coeffs, nc: int) -> int:
    """Encode one residual block; returns its TotalCoeff (for nC context)."""
    max_coeffs = len(coeffs)
    nz = [(i, c) for i, c in enumerate(coeffs) if c != 0]
    total_coeff = len(nz)

    # trailing ones: up to 3 |1| coefficients at the end of scan order
    t1 = 0
    for _, c in reversed(nz):
        if abs(c) == 1 and t1 < 3:
            t1 += 1
        else:
            break

    tab = T.coeff_token_table(nc)
    if tab is None:
        bw.bits(T.coeff_token_fixed(t1, total_coeff))
    else:
        bw.bits(tab[(t1, total_coeff)])
    if total_coeff == 0:
        return 0

    # trailing-one sign flags, highest frequency first
    for _, c in reversed(nz[total_coeff - t1:]):
        bw.u(1, 1 if c < 0 else 0)

    # remaining levels, highest frequency first
    suffix_length = 1 if (total_coeff > 10 and t1 < 3) else 0
    first = True
    for _, c in reversed(nz[: total_coeff - t1]):
        level_code = 2 * c - 2 if c > 0 else -2 * c - 1
        if first and t1 < 3:
            level_code -= 2
        first = False
        _write_level(bw, level_code, suffix_length)
        if suffix_length == 0:
            suffix_length = 1
        if abs(c) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    # total_zeros
    last_idx = nz[-1][0]
    total_zeros = last_idx + 1 - total_coeff
    if total_coeff < max_coeffs:
        if nc == -1:
            bw.bits(T.TOTAL_ZEROS_CHROMA_DC[total_coeff][total_zeros])
        else:
            bw.bits(T.TOTAL_ZEROS_4x4[total_coeff][total_zeros])

    # run_before, highest frequency first, not for the last (lowest) coeff
    zeros_left = total_zeros
    prev_idx = None
    for idx, _ in reversed(nz):
        if zeros_left == 0:
            break
        if prev_idx is None:
            prev_idx = idx
            continue
        run = prev_idx - idx - 1
        bw.bits(T.RUN_BEFORE[min(zeros_left, 7)][run])
        zeros_left -= run
        prev_idx = idx
    return total_coeff


def _write_level(bw: BitWriter, level_code: int, suffix_length: int) -> None:
    if suffix_length == 0:
        if level_code < 14:
            bw.u(level_code + 1, 1)                    # unary
        elif level_code < 30:
            bw.u(15, 1)                                # prefix 14
            bw.u(4, level_code - 14)
        else:
            bw.u(16, 1)                                # prefix 15
            if level_code - 30 >= (1 << 12):
                raise ValueError("level too large for CAVLC escape")
            bw.u(12, level_code - 30)
    else:
        prefix = level_code >> suffix_length
        if prefix < 15:
            bw.u(prefix + 1, 1)
            bw.u(suffix_length, level_code & ((1 << suffix_length) - 1))
        else:
            bw.u(16, 1)
            rem = level_code - (15 << suffix_length)
            if rem >= (1 << 12):
                raise ValueError("level too large for CAVLC escape")
            bw.u(12, rem)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

def _build_trie(table: dict) -> dict[str, tuple[int, int]]:
    return {code: key for key, code in table.items()}


_DECODE_NC0 = _build_trie(T.COEFF_TOKEN_NC0)
_DECODE_NC2 = _build_trie(T.COEFF_TOKEN_NC2)
_DECODE_NC4 = _build_trie(T.COEFF_TOKEN_NC4)
_DECODE_CHROMA = _build_trie(T.COEFF_TOKEN_CHROMA_DC)


def _read_vlc(br: BitReader, inverse: dict[str, object], max_len: int = 16):
    code = ""
    for _ in range(max_len):
        code += str(br.u(1))
        if code in inverse:
            return inverse[code]
    raise ValueError(f"invalid VLC: {code}")


def decode_residual_block(br: BitReader, nc: int, max_coeffs: int):
    """Decode one residual block → list of coefficients in zig-zag order."""
    if nc == -1:
        inv = _DECODE_CHROMA
    elif nc < 2:
        inv = _DECODE_NC0
    elif nc < 4:
        inv = _DECODE_NC2
    elif nc < 8:
        inv = _DECODE_NC4
    else:
        v = br.u(6)
        if v == 3:
            t1, total_coeff = 0, 0
        else:
            total_coeff, t1 = (v >> 2) + 1, v & 3
        inv = None
    if inv is not None:
        t1, total_coeff = _read_vlc(br, inv)

    coeffs = [0] * max_coeffs
    if total_coeff == 0:
        return coeffs

    levels = []
    for _ in range(t1):
        levels.append(-1 if br.u(1) else 1)

    suffix_length = 1 if (total_coeff > 10 and t1 < 3) else 0
    for i in range(total_coeff - t1):
        prefix = 0
        while br.u(1) == 0:
            prefix += 1
            if prefix > 32:
                raise ValueError("bad level prefix")
        if suffix_length == 0:
            if prefix < 14:
                level_code = prefix
            elif prefix == 14:
                level_code = 14 + br.u(4)
            else:
                level_code = 30 + br.u(12)
        else:
            if prefix < 15:
                level_code = (prefix << suffix_length) + br.u(suffix_length)
            else:
                level_code = (15 << suffix_length) + br.u(12)
        if i == 0 and t1 < 3:
            level_code += 2
        level = (level_code + 2) >> 1 if level_code % 2 == 0 else \
            -((level_code + 1) >> 1)
        levels.append(level)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    if total_coeff < max_coeffs:
        if nc == -1:
            tz_inv = {c: z for z, c in
                      enumerate(T.TOTAL_ZEROS_CHROMA_DC[total_coeff])}
        else:
            tz_inv = {c: z for z, c in
                      enumerate(T.TOTAL_ZEROS_4x4[total_coeff])}
        total_zeros = _read_vlc(br, tz_inv)
    else:
        total_zeros = 0

    runs = []
    zeros_left = total_zeros
    for i in range(total_coeff - 1):
        if zeros_left > 0:
            rb_inv = {c: r for r, c in
                      enumerate(T.RUN_BEFORE[min(zeros_left, 7)])}
            run = _read_vlc(br, rb_inv)
        else:
            run = 0
        runs.append(run)
        zeros_left -= run
    runs.append(zeros_left)  # remaining zeros precede the first coefficient

    # place coefficients: levels[] are highest-frequency first
    idx = total_coeff + total_zeros - 1
    for level, run in zip(levels, runs):
        coeffs[idx] = level
        idx -= run + 1
    return coeffs
