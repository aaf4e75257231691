"""CABAC binary arithmetic codec (context-adaptive, spec 9.3).

Copy of ``vcp_tpu/codec/cabac.py`` (host code): the
HEVC slice writers and parsers, the validation decoder and the foreign
HEVC decoder run on it; the H.264 path uses the C++ writers of
``native/cabac.cpp`` instead.
"""

from __future__ import annotations

# Table 9-44: rangeTabLPS[pStateIdx][qRangeIdx].
RANGE_TAB_LPS = (
    (128, 176, 208, 240), (128, 167, 197, 227), (128, 158, 187, 216),
    (123, 150, 178, 205), (116, 142, 169, 195), (111, 135, 160, 185),
    (105, 128, 152, 175), (100, 122, 144, 166), (95, 116, 137, 158),
    (90, 110, 130, 150), (85, 104, 123, 142), (81, 99, 117, 135),
    (77, 94, 111, 128), (73, 89, 105, 122), (69, 85, 100, 116),
    (66, 80, 95, 110), (62, 76, 90, 104), (59, 72, 86, 99),
    (56, 69, 81, 94), (53, 65, 77, 89), (51, 62, 73, 85),
    (48, 59, 69, 80), (46, 56, 66, 76), (43, 53, 63, 72),
    (41, 50, 59, 69), (39, 48, 56, 65), (37, 45, 54, 62),
    (35, 43, 51, 59), (33, 41, 48, 56), (32, 39, 46, 53),
    (30, 37, 43, 50), (29, 35, 41, 48), (27, 33, 39, 45),
    (26, 31, 37, 43), (24, 30, 35, 41), (23, 28, 33, 39),
    (22, 27, 32, 37), (21, 26, 30, 35), (20, 24, 29, 33),
    (19, 23, 27, 31), (18, 22, 26, 30), (17, 21, 25, 28),
    (16, 20, 23, 27), (15, 19, 22, 25), (14, 18, 21, 24),
    (14, 17, 20, 23), (13, 16, 19, 22), (12, 15, 18, 21),
    (12, 14, 17, 20), (11, 14, 16, 19), (11, 13, 15, 18),
    (10, 12, 15, 17), (10, 12, 14, 16), (9, 11, 13, 15),
    (9, 11, 12, 14), (8, 10, 12, 14), (8, 9, 11, 13),
    (7, 9, 11, 12), (7, 9, 10, 12), (7, 8, 10, 11),
    (6, 8, 9, 11), (6, 7, 9, 10), (6, 7, 8, 9),
    (2, 2, 2, 2),
)

# Table 9-45: transIdxLPS (state after coding an LPS). Round-2
# conformance fix: entry [29] was transcribed as 23; the spec value is
# 22 (caught by the ffmpeg oracle as rare latent bin flips —
# tests/test_conformance.py).
TRANS_IDX_LPS = (
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
)


def trans_idx_mps(state: int) -> int:
    """State after coding an MPS: advance one rung, saturating at 62."""
    return state + 1 if state < 62 else state


def validate_tables() -> None:
    """Structural invariants of the spec tables (defense against
    transcription slips; conformance validation is external)."""
    assert len(RANGE_TAB_LPS) == 64 and len(TRANS_IDX_LPS) == 64
    assert RANGE_TAB_LPS[63] == (2, 2, 2, 2)
    for s, row in enumerate(RANGE_TAB_LPS):
        assert all(row[i] < row[i + 1] for i in range(3)) or s == 63
        if 0 < s < 63:
            prev = RANGE_TAB_LPS[s - 1]
            # LPS probability decays by ~0.949 per rung
            for i in range(4):
                assert row[i] <= prev[i]
                assert row[i] >= int(prev[i] * 0.90) - 1, (s, i)
    for s, t in enumerate(TRANS_IDX_LPS):
        assert t <= s or (s, t) == (63, 63)
        if s:
            assert t >= TRANS_IDX_LPS[s - 1]


def _clip3(lo: int, hi: int, v: int) -> int:
    return lo if v < lo else (hi if v > hi else v)


class Context:
    """One adaptive binary context: 6-bit probability state + MPS."""

    __slots__ = ("state", "mps")

    def __init__(self, state: int = 0, mps: int = 0):
        self.state = state
        self.mps = mps

    @classmethod
    def from_init(cls, m: int, n: int, slice_qp: int) -> "Context":
        """Spec 9.3.1.1 (H.264 form; HEVC packs (m, n) into one byte —
        use ``from_init_hevc``)."""
        pre = _clip3(1, 126, ((m * _clip3(0, 51, slice_qp)) >> 4) + n)
        if pre <= 63:
            return cls(63 - pre, 0)
        return cls(pre - 64, 1)

    @classmethod
    def from_init_hevc(cls, init_value: int, slice_qp: int) -> "Context":
        m = (init_value >> 4) * 5 - 45
        n = ((init_value & 15) << 3) - 16
        return cls.from_init(m, n, slice_qp)


class CabacEncoder:
    """Binary arithmetic encoder (spec 9.3.4). Produces the RBSP byte
    payload after ``flush``; NAL escaping is the caller's concern."""

    def __init__(self):
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first = True
        self._bits = []          # bit accumulator (ints 0/1)

    # -- bit plumbing --------------------------------------------------
    def _put(self, b: int) -> None:
        if self.first:
            self.first = False   # spec: the very first PutBit is discarded
        else:
            self._bits.append(b)
        nb = 1 - b
        while self.bits_outstanding > 0:
            self._bits.append(nb)
            self.bits_outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.bits_outstanding += 1
            self.range <<= 1
            self.low <<= 1

    # -- bin coders ----------------------------------------------------
    def encode(self, ctx: Context, binval: int) -> None:
        q = (self.range >> 6) & 3
        r_lps = RANGE_TAB_LPS[ctx.state][q]
        self.range -= r_lps
        if binval != ctx.mps:
            self.low += self.range
            self.range = r_lps
            if ctx.state == 0:
                ctx.mps ^= 1
            ctx.state = TRANS_IDX_LPS[ctx.state]
        else:
            ctx.state = trans_idx_mps(ctx.state)
        self._renorm()

    def encode_bypass(self, binval: int) -> None:
        self.low <<= 1
        if binval:
            self.low += self.range
        if self.low >= 1024:
            self.low -= 1024
            self._put(1)
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.bits_outstanding += 1

    def encode_bypass_bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.encode_bypass((value >> i) & 1)

    def encode_terminate(self, binval: int) -> None:
        self.range -= 2
        if binval:
            self.low += self.range
            self.range = 2
            # flush (spec 9.3.4.6): 2 low bits + stop bit
            self._renorm()
            self._put((self.low >> 9) & 1)
            self._bits.append((self.low >> 8) & 1)
            self._bits.append(1)
        else:
            self._renorm()

    def flush(self) -> bytes:
        """Byte-align with zero padding and return the payload."""
        bits = self._bits
        pad = (-len(bits)) % 8
        bits = bits + [0] * pad
        out = bytearray()
        for i in range(0, len(bits), 8):
            byte = 0
            for b in bits[i:i + 8]:
                byte = (byte << 1) | b
            out.append(byte)
        return bytes(out)


class CabacDecoder:
    """Binary arithmetic decoder (spec 9.3.3.2)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._bit()

    def _bit(self) -> int:
        byte = self.data[self.pos >> 3] if (self.pos >> 3) < len(self.data) \
            else 0
        b = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def decode(self, ctx: Context) -> int:
        q = (self.range >> 6) & 3
        r_lps = RANGE_TAB_LPS[ctx.state][q]
        self.range -= r_lps
        if self.offset >= self.range:
            self.offset -= self.range
            self.range = r_lps
            binval = ctx.mps ^ 1
            if ctx.state == 0:
                ctx.mps ^= 1
            ctx.state = TRANS_IDX_LPS[ctx.state]
        else:
            binval = ctx.mps
            ctx.state = trans_idx_mps(ctx.state)
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return binval

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return 0
