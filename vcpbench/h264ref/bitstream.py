"""Bitstream reading (host): MSB-first bits, Exp-Golomb codes and the
removal of NAL emulation prevention. Copy of the reader half
(``BitReader``, ``emulation_remove``) of ``vcp_tpu/utils/bitstream.py``.
"""

from __future__ import annotations


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
