"""Bit-exact bitstream IO (host): MSB-first bit IO, Exp-Golomb
codes, RBSP trailing bits and NAL emulation-prevention (EBSP) framing.
Copy of ``vcp_tpu/utils/bitstream.py``: the writer half, and the
reader half (``BitReader``, ``emulation_remove``) of the host decoder.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit accumulator."""

    __slots__ = ("_bytes", "_cur", "_nbits")

    def __init__(self):
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0

    def u(self, n: int, value: int) -> None:
        """Write unsigned value in n bits."""
        if n == 0:
            return
        if value < 0 or value >> n:
            raise ValueError(f"u({n}) cannot hold {value}")
        cur, nbits = self._cur, self._nbits
        cur = (cur << n) | value
        nbits += n
        while nbits >= 8:
            nbits -= 8
            self._bytes.append((cur >> nbits) & 0xFF)
        self._cur = cur & ((1 << nbits) - 1)
        self._nbits = nbits

    def ue(self, value: int) -> None:
        """Unsigned Exp-Golomb."""
        if value < 0:
            raise ValueError("ue requires non-negative")
        k = value + 1
        n = k.bit_length()
        self.u(2 * n - 1, k)

    def se(self, value: int) -> None:
        """Signed Exp-Golomb: v>0 → 2v-1, v<=0 → -2v."""
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def bits(self, code: str) -> None:
        """Write a literal bit-string like '0001011'."""
        self.u(len(code), int(code, 2) if code else 0)

    def byte_align(self, bit: int = 0) -> None:
        while self._nbits % 8:
            self.u(1, bit)

    def rbsp_trailing_bits(self) -> None:
        self.u(1, 1)
        self.byte_align(0)

    def to_bytes(self) -> bytes:
        if self._nbits:
            raise ValueError("bitstream not byte-aligned")
        return bytes(self._bytes)


def emulation_prevent(rbsp: bytes) -> bytes:
    """RBSP → EBSP: insert 0x03 after any 00 00 preceding 00/01/02/03."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal_unit(nal_type: int, rbsp: bytes, nal_ref_idc: int = 3,
             long_start: bool = False) -> bytes:
    """Annex-B NAL: start code + header byte + EBSP payload."""
    start = b"\x00\x00\x00\x01" if long_start else b"\x00\x00\x01"
    header = bytes([(nal_ref_idc << 5) | nal_type])
    return start + header + emulation_prevent(rbsp)


def emulation_remove(ebsp: bytes) -> bytes:
    """EBSP → RBSP: drop 0x03 in 00 00 03 sequences (followed by
    00/01/02/03). Vectorized: input-window matching is equivalent to
    the sequential scanner because removed bytes are 0x03 and can never
    be part of another candidate's 00 00 prefix."""
    if b"\x00\x00\x03" not in ebsp:
        return ebsp
    import numpy as np
    a = np.frombuffer(ebsp, np.uint8)
    n = len(a)
    cand = np.flatnonzero((a[2:] == 3) & (a[1:-1] == 0)
                          & (a[:-2] == 0)) + 2
    cand = cand[cand + 1 < n]
    cand = cand[a[cand + 1] <= 3]
    if len(cand) == 0:
        return ebsp
    keep = np.ones(n, bool)
    keep[cand] = False
    return a[keep].tobytes()


class BitReader:
    """MSB-first bit reader over a bytes object."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def u(self, n: int) -> int:
        v = 0
        pos = self.pos
        data = self.data
        for _ in range(n):
            byte = data[pos >> 3]
            v = (v << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def peek(self, n: int) -> int:
        save = self.pos
        try:
            return self.u(n)
        finally:
            self.pos = save

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("invalid exp-golomb")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def bits_left(self) -> int:
        return len(self.data) * 8 - self.pos

    def more_rbsp_data(self) -> bool:
        """True if data remains before the rbsp_stop_one_bit."""
        left = self.bits_left()
        if left <= 0:
            return False
        # find last set bit in the stream (the stop bit)
        save = self.pos
        # scan from the end of data
        for byte_idx in range(len(self.data) - 1, -1, -1):
            b = self.data[byte_idx]
            if b:
                # position of lowest set bit
                low = (b & -b).bit_length() - 1
                stop_pos = byte_idx * 8 + (7 - low)
                self.pos = save
                return save < stop_pos
        self.pos = save
        return False
