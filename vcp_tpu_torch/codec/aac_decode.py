"""AAC-LC decoder (ISO/IEC 14496-3) on the host, in numpy.

Copy of ``vcp_tpu/codec/aac_decode.py``: the decoder in front of the AAC
encoder when ``-c:a aac -b:a N`` re-encodes an AAC source. LC mono /
stereo: SCE / CPE, all four window sequences (sine and KBD shapes via
``numpy.i0``), section / scalefactor / spectral decode over codebooks
1-11 with escapes, TNS, M/S and intensity stereo, and PNS, whose noise
comes from ``np.random.default_rng(0)`` per decoder, as in ``vcp_tpu``.
No SBR / PS, LTP, coupling channels, gain control or pulse data (they
raise :class:`AacDecodeError`).
"""

from __future__ import annotations

import numpy as np

from ..utils.bitstream import BitReader
from .aac_tables import (RATE_TABLE, SF_BITS, SF_CODES, SPECTRAL,
                         SWB_GROUP, SWB_OFFSET_1024)

# Short-window scalefactor-band offsets (128 spectral lines) per the
# long-window group ids the encoder's SWB_GROUP uses (Table 4.5.x).
SWB_OFFSET_128 = {
    96: (0, 4, 8, 12, 16, 20, 24, 32, 40, 48, 64, 92, 128),
    64: (0, 4, 8, 12, 16, 20, 24, 32, 40, 48, 64, 92, 128),
    48: (0, 4, 8, 12, 16, 20, 28, 36, 44, 56, 68, 80, 96, 112, 128),
    32: (0, 4, 8, 12, 16, 20, 28, 36, 44, 56, 68, 80, 96, 112, 128),
    24: (0, 4, 8, 12, 16, 20, 24, 28, 36, 44, 52, 64, 76, 92, 108, 128),
    16: (0, 4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 60, 72, 88, 108, 128),
    8: (0, 4, 8, 12, 16, 20, 24, 28, 36, 44, 52, 60, 72, 88, 108, 128),
}

# tns_max_bands (Table 4.139), long / short windows, by long-group id.
TNS_MAX_BANDS_LONG = {96: 31, 64: 34, 48: 40, 32: 51, 24: 46, 16: 42,
                      8: 39}
TNS_MAX_BANDS_SHORT = {96: 9, 64: 10, 48: 14, 32: 14, 24: 14, 16: 14,
                       8: 14}

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = range(4)

BT_ZERO = 0
BT_NOISE = 13          # PNS
BT_INTENSITY2 = 14
BT_INTENSITY = 15
ESC_BOOK = 11


class AacDecodeError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Huffman decode tables (built from the encoder's (codes, bits) arrays)
# ---------------------------------------------------------------------------

def _prefix_map(codes, bits):
    """{(length, code): index} for canonical prefix decoding."""
    m = {}
    for i, (c, b) in enumerate(zip(codes, bits)):
        if b:
            m[(int(b), int(c))] = i
    return m


_SPECTRAL_DEC = {book: _prefix_map(*SPECTRAL[book]) for book in SPECTRAL}
_SF_DEC = _prefix_map(SF_CODES, SF_BITS)

_BOOK_DIM = {1: 4, 2: 4, 3: 4, 4: 4, 5: 2, 6: 2, 7: 2, 8: 2, 9: 2,
             10: 2, 11: 2}
_BOOK_MOD = {1: 3, 2: 3, 3: 3, 4: 3, 5: 9, 6: 9, 7: 8, 8: 8, 9: 13,
             10: 13, 11: 17}
_BOOK_OFF = {1: 1, 2: 1, 5: 4, 6: 4}        # signed books subtract lav


def _read_huff(br: BitReader, table) -> int:
    code = 0
    for length in range(1, 20):
        code = (code << 1) | br.u(1)
        idx = table.get((length, code))
        if idx is not None:
            return idx
    raise AacDecodeError("bad Huffman code")


def _read_sf(br: BitReader) -> int:
    """Scalefactor dpcm value (index - 60)."""
    return _read_huff(br, _SF_DEC) - 60


def _read_spectral(br: BitReader, book: int, n: int) -> np.ndarray:
    dim = _BOOK_DIM[book]
    mod = _BOOK_MOD[book]
    off = _BOOK_OFF.get(book, 0)
    signed = book in (1, 2, 5, 6)
    out = np.zeros(n, np.float64)
    for i in range(0, n, dim):
        idx = _read_huff(br, _SPECTRAL_DEC[book])
        vals = [int(idx // (mod ** d) % mod - off)
                for d in range(dim - 1, -1, -1)]
        if not signed:                 # sign bits for all nonzeros first
            for k, v in enumerate(vals):
                if v != 0 and br.u(1):
                    vals[k] = -v
        if book == ESC_BOOK:           # then escape sequences, in order
            for k, v in enumerate(vals):
                if abs(v) == 16:
                    m = 4
                    while br.u(1):
                        m += 1
                    mag = (1 << m) + br.u(m)
                    vals[k] = -mag if v < 0 else mag
        out[i:i + dim] = vals
    return out


# ---------------------------------------------------------------------------
# Windows / filterbank
# ---------------------------------------------------------------------------

def _sine_win(n: int) -> np.ndarray:
    return np.sin(np.pi / n * (np.arange(n) + 0.5))


def _kbd_win(n: int, alpha: float) -> np.ndarray:
    """Kaiser-Bessel derived window (spec 4.6.11.3.3)."""
    from numpy import i0
    half = n // 2
    t = np.arange(half + 1)
    w = i0(np.pi * alpha * np.sqrt(1.0 - (2.0 * t / half - 1.0) ** 2))
    c = np.cumsum(w)
    kbd_half = np.sqrt(c[:half] / c[half])
    return np.concatenate([kbd_half, kbd_half[::-1]])


_WINDOWS = {}


def _win(shape: int, n: int) -> np.ndarray:
    key = (shape, n)
    if key not in _WINDOWS:
        if shape == 0:
            _WINDOWS[key] = _sine_win(n)
        else:
            _WINDOWS[key] = _kbd_win(n, 4.0 if n == 2048 else 6.0)
    return _WINDOWS[key]


_IMDCT_BASIS = {}


def _imdct(spec: np.ndarray) -> np.ndarray:
    """N/2-point IMDCT → N time samples (no window), spec 4.6.11.3.1
    (includes the 2/N normalization)."""
    half = spec.shape[-1]
    n = 2 * half
    if n not in _IMDCT_BASIS:
        n0 = (half + 1) / 2.0
        ns = np.arange(n)
        ks = np.arange(half)
        _IMDCT_BASIS[n] = (2.0 / n) * np.cos(
            np.pi / half * (ns[:, None] + n0) * (ks[None, :] + 0.5))
    return spec @ _IMDCT_BASIS[n].T


# ---------------------------------------------------------------------------
# Per-channel ICS state
# ---------------------------------------------------------------------------

class _Ics:
    def __init__(self):
        self.window_sequence = ONLY_LONG
        self.window_shape = 0
        self.max_sfb = 0
        self.num_windows = 1
        self.group_len = [1]          # windows per group
        self.swb_offset = None
        self.band_type = None         # (groups, max_sfb)
        self.sf = None                # (groups, max_sfb) int
        self.tns = None
        self.spec = None              # (1024,) float
        self.ms_used = None


def _parse_ics_info(br, ics: _Ics, rate_group):
    if br.u(1):
        raise AacDecodeError("ics_reserved_bit set")
    ics.window_sequence = br.u(2)
    ics.window_shape = br.u(1)
    if ics.window_sequence == EIGHT_SHORT:
        ics.max_sfb = br.u(4)
        scale_factor_grouping = br.u(7)
        ics.num_windows = 8
        ics.group_len = []
        run = 1
        for b in range(6, -1, -1):
            if (scale_factor_grouping >> b) & 1:
                run += 1
            else:
                ics.group_len.append(run)
                run = 1
        ics.group_len.append(run)
        ics.swb_offset = list(SWB_OFFSET_128[rate_group])
    else:
        ics.max_sfb = br.u(6)
        if br.u(1):                    # predictor_data_present
            raise AacDecodeError("MAIN/LTP prediction unsupported in LC")
        ics.num_windows = 1
        ics.group_len = [1]
        offs = [o for o in SWB_OFFSET_1024[rate_group] if o <= 1024]
        ics.swb_offset = offs
    if ics.max_sfb > len(ics.swb_offset) - 1:
        raise AacDecodeError("max_sfb exceeds swb count")


def _parse_section_data(br, ics: _Ics):
    bits = 3 if ics.window_sequence == EIGHT_SHORT else 5
    esc = (1 << bits) - 1
    n_groups = len(ics.group_len)
    band_type = np.zeros((n_groups, ics.max_sfb), np.int32)
    for g in range(n_groups):
        k = 0
        while k < ics.max_sfb:
            book = br.u(4)
            run = 0
            while True:
                inc = br.u(bits)
                run += inc
                if inc != esc:
                    break
            band_type[g, k:k + run] = book
            k += run
    ics.band_type = band_type


def _parse_scalefactors(br, ics: _Ics, global_gain: int):
    n_groups = len(ics.group_len)
    sf = np.zeros((n_groups, ics.max_sfb), np.int32)
    offset = global_gain
    noise_offset = global_gain - 90
    noise_first = True
    is_offset = 0
    for g in range(n_groups):
        for k in range(ics.max_sfb):
            bt = ics.band_type[g, k]
            if bt == BT_ZERO:
                continue
            if bt in (BT_INTENSITY, BT_INTENSITY2):
                is_offset += _read_sf(br)
                sf[g, k] = is_offset
            elif bt == BT_NOISE:
                if noise_first:
                    noise_offset += br.u(9) - 256
                    noise_first = False
                else:
                    noise_offset += _read_sf(br)
                sf[g, k] = noise_offset
            else:
                offset += _read_sf(br)
                sf[g, k] = offset
    ics.sf = sf


class _Tns:
    def __init__(self):
        self.n_filt = []
        self.filt = []      # per window: list of (length, order, dir, coefs)


def _parse_tns(br, ics: _Ics) -> _Tns:
    tns = _Tns()
    short = ics.window_sequence == EIGHT_SHORT
    for w in range(ics.num_windows):
        n_filt = br.u(1 if short else 2)
        filts = []
        coef_res = 0
        if n_filt:
            coef_res = br.u(1)
        for _ in range(n_filt):
            length = br.u(4 if short else 6)
            order = br.u(3 if short else 5)
            if order:
                direction = br.u(1)
                compress = br.u(1)
                bits = coef_res + 3 - compress
                coefs = [br.u(bits) for _ in range(order)]
                filts.append((length, order, direction,
                              coefs, coef_res, compress))
            else:
                filts.append((length, 0, 0, [], coef_res, 0))
        tns.n_filt.append(n_filt)
        tns.filt.append(filts)
    return tns


def _tns_lpc(coefs, coef_res, compress, order):
    """Decode TNS reflection coefficients → LPC (spec 4.6.9.3)."""
    bits = coef_res + 3 - compress
    maxv = 1 << (bits - 1)
    iqfac = (maxv - 0.5) / (np.pi / 2.0)
    iqfac_m = (maxv + 0.5) / (np.pi / 2.0)
    refl = []
    for c in coefs:
        v = c - (1 << bits) if c >= maxv else c
        refl.append(np.sin(v / (iqfac if v >= 0 else iqfac_m)))
    lpc = np.zeros(order + 1)
    lpc[0] = 1.0
    for m in range(1, order + 1):
        b = lpc.copy()
        for i in range(1, m):
            b[i] += refl[m - 1] * lpc[m - i]
        b[m] = refl[m - 1]
        lpc = b
    return lpc


def _apply_tns(ics: _Ics, rate_group):
    if ics.tns is None:
        return
    short = ics.window_sequence == EIGHT_SHORT
    mmax = (TNS_MAX_BANDS_SHORT if short else TNS_MAX_BANDS_LONG)[rate_group]
    lines = 128 if short else 1024
    spec = ics.spec.reshape(ics.num_windows, lines)
    offs = ics.swb_offset
    n_swb = len(offs) - 1
    for w in range(ics.num_windows):
        bottom = n_swb
        for (length, order, direction, coefs, cres, comp) in ics.tns.filt[w]:
            top = bottom
            bottom = max(0, top - length)
            if order == 0:
                continue
            lpc = _tns_lpc(coefs, cres, comp, order)
            start = offs[min(bottom, mmax, n_swb)]
            end = offs[min(top, mmax, n_swb)]
            if end <= start:
                continue
            x = spec[w]
            if direction:
                for i in range(end - 1, start - 1, -1):
                    acc = x[i]
                    for j in range(1, order + 1):
                        if i + j < end:
                            acc -= lpc[j] * x[i + j]
                    x[i] = acc
            else:
                for i in range(start, end):
                    acc = x[i]
                    for j in range(1, order + 1):
                        if i - j >= start:
                            acc -= lpc[j] * x[i - j]
                    x[i] = acc


def _parse_spectral(br, ics: _Ics):
    """Huffman-decode all coded lines into a compact stream (the order
    the bitstream carries: group-major, band, window-in-group)."""
    short = ics.window_sequence == EIGHT_SHORT
    offs = ics.swb_offset
    total = []
    for g, glen in enumerate(ics.group_len):
        for k in range(ics.max_sfb):
            bt = int(ics.band_type[g, k])
            width = offs[k + 1] - offs[k]
            if bt in (BT_ZERO, BT_NOISE, BT_INTENSITY, BT_INTENSITY2):
                continue
            total.append(_read_spectral(br, bt, width * glen))
    ics.spec = (np.concatenate(total) if total
                else np.zeros(0, np.float64))


def _parse_pulse(br):
    n = br.u(2) + 1
    br.u(6)                           # start_sfb
    amps = []
    for _ in range(n):
        br.u(5)
        amps.append(br.u(4))
    return amps


def _expand_levels(ics: _Ics):
    """Re-scatter the compact Huffman stream into per-line positions so
    dequant can walk (group, band, window)."""
    short = ics.window_sequence == EIGHT_SHORT
    lines = 128 if short else 1024
    offs = ics.swb_offset
    q = np.zeros(ics.num_windows * lines, np.float64)
    pos = 0
    win0 = 0
    src = ics.spec
    for g, glen in enumerate(ics.group_len):
        for k in range(ics.max_sfb):
            bt = int(ics.band_type[g, k])
            width = offs[k + 1] - offs[k]
            if bt in (BT_ZERO, BT_NOISE, BT_INTENSITY, BT_INTENSITY2):
                continue
            for wi in range(glen):
                base = (win0 + wi) * lines + offs[k]
                q[base:base + width] = src[pos:pos + width]
                pos += width
        win0 += glen
    ics.spec = q


def _dequant_inplace(ics: _Ics, rng):
    short = ics.window_sequence == EIGHT_SHORT
    lines = 128 if short else 1024
    q = ics.spec
    out = np.zeros(ics.num_windows * lines, np.float64)
    offs = ics.swb_offset
    win0 = 0
    for g, glen in enumerate(ics.group_len):
        for k in range(ics.max_sfb):
            bt = int(ics.band_type[g, k])
            width = offs[k + 1] - offs[k]
            for wi in range(glen):
                base = (win0 + wi) * lines + offs[k]
                if bt in (BT_ZERO, BT_INTENSITY, BT_INTENSITY2):
                    continue
                if bt == BT_NOISE:
                    noise = rng.standard_normal(width)
                    norm = np.sqrt(np.mean(noise ** 2)) or 1.0
                    gain = 2.0 ** (ics.sf[g, k] / 4.0)
                    out[base:base + width] = noise / norm * gain
                else:
                    vals = q[base:base + width]
                    gain = 2.0 ** ((ics.sf[g, k] - 100) / 4.0)
                    out[base:base + width] = (
                        np.sign(vals) * np.abs(vals) ** (4.0 / 3.0) * gain)
        win0 += glen
    ics.spec = out


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------

class AacDecoder:
    """Stateful AAC-LC decoder. Feed raw access units (one AAC frame
    each) via decode_frame, or a whole ADTS stream via decode_adts.
    Emits (1024, channels) float64 PCM per frame (first frame is the
    filterbank priming delay, all-zero history)."""

    def __init__(self, rate: int = 48000, channels: int = 1):
        self.rate = rate
        self.channels = channels
        self.group = SWB_GROUP[min(SWB_GROUP, key=lambda r: abs(r - rate))] \
            if rate not in SWB_GROUP else SWB_GROUP[rate]
        self._overlap = np.zeros((channels, 1024))
        self._prev_shape = [0] * channels
        self._rng = np.random.default_rng(0)

    # -- element decode ----------------------------------------------------

    def _decode_ics(self, br, common_ics=None):
        ics = _Ics()
        global_gain = br.u(8)
        if common_ics is None:
            _parse_ics_info(br, ics, self.group)
        else:
            for a in ("window_sequence", "window_shape", "max_sfb",
                      "num_windows", "group_len", "swb_offset"):
                setattr(ics, a, getattr(common_ics, a))
        _parse_section_data(br, ics)
        _parse_scalefactors(br, ics, global_gain)
        if br.u(1):                   # pulse_data_present
            if ics.window_sequence == EIGHT_SHORT:
                raise AacDecodeError("pulse with short windows")
            self._pulse = _parse_pulse(br)
            raise AacDecodeError("pulse_data unsupported")
        ics.tns = _parse_tns(br, ics) if br.u(1) else None
        if br.u(1):                   # gain_control_data_present
            raise AacDecodeError("gain control (SSR) unsupported")
        _parse_spectral(br, ics)
        _expand_levels(ics)
        _dequant_inplace(ics, self._rng)
        return ics

    def _synth(self, ch: int, ics: _Ics) -> np.ndarray:
        """Filterbank + overlap-add for one channel; returns 1024 PCM."""
        _apply_tns(ics, self.group)
        shape = ics.window_shape
        prev = self._prev_shape[ch]
        if ics.window_sequence == EIGHT_SHORT:
            spec = ics.spec.reshape(8, 128)
            t = _imdct(spec)                     # (8, 256)
            wprev = _win(prev, 256)
            wcur = _win(shape, 256)
            buf = np.zeros(2048)
            for w in range(8):
                x = t[w].copy()
                x[:128] *= (wprev if w == 0 else wcur)[:128]
                x[128:] *= wcur[128:]
                start = 448 + 128 * w
                buf[start:start + 256] += x
            out = self._overlap[ch] + buf[:1024]
            self._overlap[ch] = buf[1024:]
        else:
            t = _imdct(ics.spec[None, :])[0]     # (2048,)
            if ics.window_sequence == ONLY_LONG:
                t[:1024] *= _win(prev, 2048)[:1024]
                t[1024:] *= _win(shape, 2048)[1024:]
            elif ics.window_sequence == LONG_START:
                t[:1024] *= _win(prev, 2048)[:1024]
                t[1024:1024 + 448] *= 1.0
                t[1472:1600] *= _win(shape, 256)[128:]
                t[1600:] = 0.0
            else:                                # LONG_STOP
                t[:448] = 0.0
                t[448:576] *= _win(prev, 256)[:128]
                t[1024:] *= _win(shape, 2048)[1024:]
            out = self._overlap[ch] + t[:1024]
            self._overlap[ch] = t[1024:]
        self._prev_shape[ch] = shape
        return out

    # -- syntax ------------------------------------------------------------

    def decode_frame(self, au: bytes) -> np.ndarray:
        br = BitReader(au)
        pcm = np.zeros((1024, self.channels))
        got = 0
        while True:
            elem = br.u(3)
            if elem == 7:             # END
                break
            if elem == 0:             # SCE
                br.u(4)               # element_instance_tag
                ics = self._decode_ics(br)
                pcm[:, got] = self._synth(got, ics)
                got += 1
            elif elem == 1:           # CPE
                br.u(4)
                common = br.u(1)
                ms_type = 0
                icsL = _Ics()
                if common:
                    _parse_ics_info(br, icsL, self.group)
                    ms_type = br.u(2)
                    n_groups = len(icsL.group_len)
                    if ms_type == 1:
                        ms_mask = np.zeros((n_groups, icsL.max_sfb), bool)
                        for g in range(n_groups):
                            for k in range(icsL.max_sfb):
                                ms_mask[g, k] = bool(br.u(1))
                    elif ms_type == 2:
                        ms_mask = np.ones((n_groups, icsL.max_sfb), bool)
                    else:
                        ms_mask = None
                else:
                    ms_mask = None
                left = self._decode_ics(br, icsL if common else None)
                right = self._decode_ics(br, icsL if common else None)
                self._stereo_tools(left, right, ms_mask)
                pcm[:, got % self.channels] = self._synth(got, left)
                g2 = min(got + 1, self.channels - 1)
                pcm[:, g2] = self._synth(g2, right)
                got += 2
            elif elem == 4:           # DSE: skip payload
                br.u(4)
                align = br.u(1)
                cnt = br.u(8)
                if cnt == 255:
                    cnt += br.u(8)
                if align:
                    br.byte_align()
                for _ in range(cnt):
                    br.u(8)
            elif elem == 6:           # FIL: skip payload
                cnt = br.u(4)
                if cnt == 15:
                    cnt += br.u(8) - 1
                for _ in range(cnt):
                    br.u(8)
            elif elem == 2:           # CCE
                raise AacDecodeError("coupling channel unsupported")
            elif elem == 3:           # LFE: decode as an SCE
                br.u(4)
                ics = self._decode_ics(br)
                pcm[:, min(got, self.channels - 1)] = self._synth(
                    min(got, self.channels - 1), ics)
                got += 1
            else:                     # PCE
                raise AacDecodeError(f"element {elem} unsupported")
        return pcm

    def _stereo_tools(self, left: _Ics, right: _Ics, ms_mask):
        """M/S and intensity stereo over dequantized spectra."""
        short = left.window_sequence == EIGHT_SHORT
        lines = 128 if short else 1024
        offs = left.swb_offset
        win0 = 0
        for g, glen in enumerate(left.group_len):
            for k in range(right.max_sfb):
                bt = int(right.band_type[g, k])
                width = offs[k + 1] - offs[k]
                for wi in range(glen):
                    base = (win0 + wi) * lines + offs[k]
                    sl = slice(base, base + width)
                    if bt in (BT_INTENSITY, BT_INTENSITY2):
                        invert = (bt == BT_INTENSITY2)
                        if ms_mask is not None and ms_mask[g, k]:
                            invert = not invert
                        scale = 0.5 ** (right.sf[g, k] / 4.0)
                        right.spec[sl] = left.spec[sl] * scale * \
                            (-1.0 if invert else 1.0)
                    elif (ms_mask is not None and ms_mask[g, k]
                          and bt != BT_NOISE):
                        m = left.spec[sl].copy()
                        s = right.spec[sl].copy()
                        left.spec[sl] = m + s
                        right.spec[sl] = m - s
            win0 += glen

    def decode_adts(self, data: bytes) -> np.ndarray:
        """Decode a whole ADTS stream → (n, channels) float PCM."""
        out = []
        pos = 0
        while pos + 7 <= len(data):
            if data[pos] != 0xFF or (data[pos + 1] & 0xF6) != 0xF0:
                pos += 1
                continue
            hdr = data[pos:pos + 9]
            protection_absent = hdr[1] & 1
            rate_idx = (hdr[2] >> 2) & 0xF
            channels = ((hdr[2] & 1) << 2) | (hdr[3] >> 6)
            frame_len = ((hdr[3] & 0x3) << 11) | (hdr[4] << 3) | (hdr[5] >> 5)
            hdr_len = 7 if protection_absent else 9
            au = data[pos + hdr_len:pos + frame_len]
            if rate_idx < len(RATE_TABLE):
                self.rate = RATE_TABLE[rate_idx]
                self.group = SWB_GROUP.get(self.rate, self.group)
            if channels and channels != self.channels:
                self.channels = channels
                self._overlap = np.zeros((channels, 1024))
                self._prev_shape = [0] * channels
            out.append(self.decode_frame(au))
            pos += frame_len
        if not out:
            return np.zeros((0, self.channels))
        return np.concatenate(out, axis=0)


def decode_adts(data: bytes) -> tuple[np.ndarray, int]:
    """Convenience: ADTS bytes → ((n, ch) int16 PCM, sample_rate)."""
    dec = AacDecoder()
    pcm = dec.decode_adts(data)
    pcm16 = np.clip(np.round(pcm), -32768, 32767).astype(np.int16)
    return pcm16, dec.rate
