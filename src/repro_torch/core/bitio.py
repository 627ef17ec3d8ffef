"""Bit-level IO used by every entropy coder in repro.core.

Host-side (numpy / pure python): entropy coding is inherently sequential,
variable-length work and lives on the coordinator CPU in production; the TPU
handles the dense statistics extraction (see repro.forest / repro.kernels).
"""
from __future__ import annotations

import numpy as np


class BitWriter:
    """Append-only MSB-first bit buffer."""

    __slots__ = ("_bytes", "_cur", "_nbits")

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._cur = 0  # partial byte accumulator
        self._nbits = 0  # bits in accumulator (0..7)

    def write_bit(self, bit: int) -> None:
        self._cur = (self._cur << 1) | (bit & 1)
        self._nbits += 1
        if self._nbits == 8:
            self._bytes.append(self._cur)
            self._cur = 0
            self._nbits = 0

    def write_bits(self, value: int, width: int) -> None:
        """Write ``width`` bits of ``value``, MSB first."""
        for shift in range(width - 1, -1, -1):
            self.write_bit((value >> shift) & 1)

    def write_bitstring(self, bits) -> None:
        for b in bits:
            self.write_bit(int(b))

    def __len__(self) -> int:  # total bits written
        return len(self._bytes) * 8 + self._nbits

    def getvalue(self) -> bytes:
        """Byte-aligned payload; trailing bits padded with zeros."""
        out = bytearray(self._bytes)
        if self._nbits:
            out.append(self._cur << (8 - self._nbits))
        return bytes(out)


class BitReader:
    """MSB-first reader over a bytes payload."""

    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes, start_bit: int = 0) -> None:
        self._data = data
        self._pos = start_bit

    @property
    def pos(self) -> int:
        return self._pos

    def read_bit(self) -> int:
        byte = self._data[self._pos >> 3]
        bit = (byte >> (7 - (self._pos & 7))) & 1
        self._pos += 1
        return bit

    def read_bits(self, width: int) -> int:
        v = 0
        for _ in range(width):
            v = (v << 1) | self.read_bit()
        return v

    def peek_bits(self, width: int) -> int:
        """Next ``width`` bits MSB-first WITHOUT advancing; positions past the
        end of the payload read as 0 (callers bound the real consumption)."""
        v = 0
        data = self._data
        n_bits = len(data) * 8
        for p in range(self._pos, self._pos + width):
            v <<= 1
            if p < n_bits:
                v |= (data[p >> 3] >> (7 - (p & 7))) & 1
        return v

    def skip(self, n_bits: int) -> None:
        self._pos += n_bits

    def remaining(self) -> int:
        return len(self._data) * 8 - self._pos


def pack_bits(bits: np.ndarray) -> bytes:
    """Vectorized MSB-first packing of a 0/1 array."""
    bits = np.asarray(bits, dtype=np.uint8)
    return np.packbits(bits).tobytes()


def unpack_bits(data: bytes, n_bits: int) -> np.ndarray:
    arr = np.frombuffer(data, dtype=np.uint8)
    return np.unpackbits(arr)[:n_bits]
