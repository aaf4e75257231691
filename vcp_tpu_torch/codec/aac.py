"""AAC-LC encoder (ISO/IEC 14496-3), long windows, on the host.

Copy of ``vcp_tpu/codec/aac.py``: a sine-windowed 2048-point MDCT (one
float64 matmul per frame in numpy), one scalefactor per frame picked by a
bisection against the frame's bit budget, per-band Huffman codebooks 1-11,
mono SCE or stereo CPE (common window, no M/S). Numpy float64 on the host
keeps the scalefactor decisions, and so the access units, byte-identical
to ``vcp_tpu``'s; audio is about 5 MFLOP/s at 48 kHz.
"""

from __future__ import annotations


import numpy as np

from ..utils.bitstream import BitWriter
from .aac_tables import (RATE_TABLE, SF_BITS, SF_CODES, SPECTRAL,
                         SWB_GROUP, SWB_OFFSET_1024)

ESC_BOOK = 11


def mdct_basis(n: int = 2048) -> np.ndarray:
    """(2048, 1024) forward MDCT basis including the sine window."""
    half = n // 2
    n0 = (half + 1) / 2.0
    ns = np.arange(n)
    ks = np.arange(half)
    win = np.sin(np.pi / n * (ns + 0.5))
    basis = np.cos(np.pi / half * (ns[:, None] + n0) * (ks[None, :] + 0.5))
    # spec forward factor 2 (4.6.11.3); calibrated against the
    # system-ffmpeg decoder: waveform corr 1.00000 at exactly 2.0
    return (win[:, None] * basis) * 2.0


def swb_offsets(rate: int, max_line: int = 1024):
    offs = list(SWB_OFFSET_1024[SWB_GROUP[rate]])
    return [o for o in offs if o <= max_line]


SF_OFFSET = 100    # decoder gain = 2^((coded_sf - SF_OFFSET)/4)


def quantize(spec: np.ndarray, scalefac: int) -> np.ndarray:
    """Spec 4.6.2 nonlinear quantizer; ``scalefac`` is the CODED value
    (global_gain), applied around the spec's offset of 100."""
    step = 2.0 ** (-(scalefac - SF_OFFSET) / 4.0)
    q = np.floor(np.abs(spec * step) ** 0.75 + 0.4054)
    return (np.sign(spec) * np.clip(q, 0, 8191)).astype(np.int64)


def _book_for(maxabs: int) -> int:
    if maxabs == 0:
        return 0
    if maxabs <= 1:
        return 2
    if maxabs <= 2:
        return 4
    if maxabs <= 4:
        return 6
    if maxabs <= 7:
        return 8
    if maxabs <= 12:
        return 10
    return ESC_BOOK


def _write_spectral(bw: BitWriter, book: int, vals: np.ndarray) -> None:
    codes, bits = SPECTRAL[book]
    if book <= 4:                         # 4-tuples
        dim, lav = 4, (1 if book <= 2 else 2)
    else:                                 # pairs
        dim = 2
        lav = {5: 4, 6: 4, 7: 7, 8: 7, 9: 12, 10: 12, 11: 16}[book]
    signed = book in (1, 2, 5, 6)
    mod = {1: 3, 2: 3, 3: 3, 4: 3, 5: 9, 6: 9, 7: 8, 8: 8,
           9: 13, 10: 13, 11: 17}[book]
    off = lav if signed else 0
    for i in range(0, len(vals), dim):
        group = vals[i:i + dim]
        idx = 0
        for v in group:
            w = int(v) if signed else min(abs(int(v)), lav)
            idx = idx * mod + (w + off)
        bw.u(bits[idx], codes[idx])
        if not signed:
            for v in group:
                if v != 0:
                    bw.u(1, 1 if v < 0 else 0)
        if book == ESC_BOOK:
            for v in group:
                a = abs(int(v))
                if a >= 16:
                    # escape: (m-4) ones + '0' + m-bit mantissa, value
                    # a = 2^m + mantissa (spec 4.6.3.3)
                    m = a.bit_length() - 1
                    bw.u(m - 3, (1 << (m - 3)) - 2)
                    bw.u(m, a - (1 << m))


class AacEncoder:
    """Stateful AAC-LC encoder: feed (n, ch) int16 PCM, collect ADTS
    frames (or raw AUs + AudioSpecificConfig for MP4 muxing)."""

    def __init__(self, rate: int = 48000, channels: int = 1,
                 bitrate: int = 128000):
        assert channels in (1, 2)
        assert rate in SWB_GROUP, f"unsupported sample rate {rate}"
        self.rate = rate
        self.channels = channels
        self.bitrate = bitrate
        self.basis = mdct_basis()
        self.offsets = swb_offsets(rate)
        self.max_sfb = len(self.offsets) - 1
        self._prev = np.zeros((1024, channels), np.float64)
        self._bit_budget = bitrate * 1024 / rate  # bits per frame target
        self.rate_index = RATE_TABLE.index(rate)

    # -- per-channel ICS ---------------------------------------------------
    def _channel_bits(self, spec: np.ndarray, scalefac: int,
                      bw: BitWriter, write_ics_info: bool = True) -> None:
        q = quantize(spec, scalefac)
        offs = self.offsets
        books = []
        for b in range(self.max_sfb):
            seg = q[offs[b]:offs[b + 1]]
            books.append(_book_for(int(np.max(np.abs(seg)))
                                   if seg.size else 0))
        bw.u(8, scalefac & 0xFF)          # global_gain
        if write_ics_info:
            self._write_ics_info(bw)
        # section_data (long window: 5-bit lengths, esc 31)
        i = 0
        while i < self.max_sfb:
            j = i
            while j < self.max_sfb and books[j] == books[i]:
                j += 1
            bw.u(4, books[i])
            run = j - i
            while run >= 31:
                bw.u(5, 31)
                run -= 31
            bw.u(5, run)
            i = j
        # scale_factor_data: uniform scalefactor -> delta 0 for every
        # non-zero-book band (dpcm starts from global_gain)
        zero_delta = 60
        for b in range(self.max_sfb):
            if books[b] != 0:
                bw.u(SF_BITS[zero_delta], SF_CODES[zero_delta])
        bw.u(1, 0)                        # pulse_data_present
        bw.u(1, 0)                        # tns_data_present
        bw.u(1, 0)                        # gain_control_data_present
        for b in range(self.max_sfb):
            if books[b] != 0:
                _write_spectral(bw, books[b], q[offs[b]:offs[b + 1]])

    def _write_ics_info(self, bw: BitWriter) -> None:
        bw.u(1, 0)                        # ics_reserved
        bw.u(2, 0)                        # window_sequence = ONLY_LONG
        bw.u(1, 0)                        # window_shape = sine
        bw.u(6, self.max_sfb)
        bw.u(1, 0)                        # predictor_data_present

    def _frame_spectra(self, pcm: np.ndarray) -> np.ndarray:
        """(1024, ch) new samples -> (ch, 1024) MDCT lines."""
        block = np.concatenate([self._prev, pcm], axis=0)   # (2048, ch)
        self._prev = pcm
        return (block.T @ self.basis)                       # (ch, 1024)

    def _pick_scalefac(self, specs: np.ndarray) -> int:
        """Smallest quantization error whose frame fits the bit budget.
        The search floor keeps max|q| inside the 8191 level range —
        below it the quantizer clamp saturates the dominant lines
        (audible distortion the bit budget can't see)."""
        lo, hi = 0, 255
        maxabs = float(np.max(np.abs(specs)))
        if maxabs > 0:
            # (maxabs * 2^(-(sf-100)/4))^0.75 <= 8191
            lo = max(0, int(np.ceil(
                100 + 4 * (np.log2(maxabs) - np.log2(8191.0) * 4 / 3))))
            lo = min(lo, 255)
        budget = self._bit_budget
        best = 255
        for _ in range(12):
            mid = (lo + hi) // 2
            size = len(self._encode_payload(specs, mid)) * 8
            if size <= budget:
                best = mid
                hi = mid - 1
            else:
                lo = mid + 1
            if lo > hi:
                break
        return best

    def _encode_payload(self, specs: np.ndarray, scalefac: int) -> bytes:
        bw = BitWriter()
        if self.channels == 1:
            bw.u(3, 0)                    # ID_SCE
            bw.u(4, 0)                    # element_instance_tag
            self._channel_bits(specs[0], scalefac, bw)
        else:
            bw.u(3, 1)                    # ID_CPE
            bw.u(4, 0)
            bw.u(1, 1)                    # common_window
            self._write_ics_info(bw)
            bw.u(2, 0)                    # ms_mask_present = 0
            self._channel_bits(specs[0], scalefac, bw,
                               write_ics_info=False)
            self._channel_bits(specs[1], scalefac, bw,
                               write_ics_info=False)
        bw.u(3, 7)                        # ID_END
        bw.byte_align(0)
        return bw.to_bytes()

    def encode_frame(self, pcm: np.ndarray) -> bytes:
        """(1024, ch) int16/float PCM -> one raw AAC access unit."""
        pcm = np.asarray(pcm, np.float64).reshape(1024, self.channels)
        specs = self._frame_spectra(pcm)
        return self._encode_payload(specs, self._pick_scalefac(specs))

    def encode(self, pcm: np.ndarray) -> list[bytes]:
        """(N, ch) PCM -> raw AUs (one per 1024 samples; the tail is
        zero-padded to a full frame)."""
        pcm = np.asarray(pcm, np.float64)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        n = pcm.shape[0]
        pad = (-n) % 1024
        if pad:
            pcm = np.concatenate(
                [pcm, np.zeros((pad, pcm.shape[1]))], axis=0)
        return [self.encode_frame(pcm[i:i + 1024])
                for i in range(0, pcm.shape[0], 1024)]

    # -- packaging ---------------------------------------------------------
    def adts_frame(self, au: bytes) -> bytes:
        n = len(au) + 7
        h = bytearray(7)
        h[0] = 0xFF
        h[1] = 0xF1
        h[2] = (1 << 6) | (self.rate_index << 2) | ((self.channels >> 2) & 1)
        h[3] = ((self.channels & 3) << 6) | ((n >> 11) & 3)
        h[4] = (n >> 3) & 0xFF
        h[5] = ((n & 7) << 5) | 0x1F
        h[6] = 0xFC
        return bytes(h) + au

    def adts_stream(self, pcm: np.ndarray) -> bytes:
        return b"".join(self.adts_frame(au) for au in self.encode(pcm))

    def audio_specific_config(self) -> bytes:
        """AudioSpecificConfig for MP4 esds (AAC-LC = object type 2)."""
        bw = BitWriter()
        bw.u(5, 2)
        bw.u(4, self.rate_index)
        bw.u(4, self.channels)
        bw.byte_align(0)
        return bw.to_bytes()
