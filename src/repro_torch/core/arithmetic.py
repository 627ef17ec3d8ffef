"""Static integer arithmetic coding (paper §2.2, used for fits per §4).

32-bit range implementation after Witten/Neal/Cleary (as presented in Sayood).
Operates on integer symbols with a fixed cumulative-frequency table; achieves
within ~2 bits of ``n * H(P)`` for the whole sequence, which is why the paper
prefers it over Huffman for skewed binary alphabets (two-class fits).
"""
from __future__ import annotations

import numpy as np

from .bitio import BitReader, BitWriter

_PRECISION = 32
_WHOLE = 1 << _PRECISION
_HALF = _WHOLE >> 1
_QUARTER = _WHOLE >> 2
_MASK = _WHOLE - 1
_MAX_TOTAL = 1 << 24  # keep range arithmetic exact


def _quantize_freqs(freqs: np.ndarray) -> np.ndarray:
    """Integer frequency table with every observed symbol >= 1."""
    freqs = np.asarray(freqs, dtype=np.float64)
    total = freqs.sum()
    if total <= 0:
        raise ValueError("empty frequency table")
    scaled = np.maximum((freqs / total * (_MAX_TOTAL - len(freqs))), 0.0)
    q = np.floor(scaled).astype(np.int64)
    q[freqs > 0] = np.maximum(q[freqs > 0], 1)
    return q


class ArithmeticCode:
    """Static arithmetic coder over symbols 0..B-1 with distribution ``freqs``.

    Symbols with zero frequency cannot be coded (mirrors the Huffman
    codebook-membership rule); cluster centroids always dominate their
    members' supports, so this never triggers in the codec.
    """

    def __init__(self, freqs: np.ndarray) -> None:
        self.freqs = _quantize_freqs(freqs)
        self.cum = np.zeros(len(self.freqs) + 1, dtype=np.int64)
        np.cumsum(self.freqs, out=self.cum[1:])
        self.total = int(self.cum[-1])

    def encode(self, symbols) -> bytes:
        w = BitWriter()
        low, high = 0, _MASK
        pending = 0

        def emit(bit: int) -> None:
            nonlocal pending
            w.write_bit(bit)
            while pending:
                w.write_bit(1 - bit)
                pending -= 1

        for s in symbols:
            s = int(s)
            span = high - low + 1
            if self.freqs[s] == 0:
                raise ValueError(f"symbol {s} has zero probability")
            high = low + span * int(self.cum[s + 1]) // self.total - 1
            low = low + span * int(self.cum[s]) // self.total
            while True:
                if high < _HALF:
                    emit(0)
                elif low >= _HALF:
                    emit(1)
                    low -= _HALF
                    high -= _HALF
                elif low >= _QUARTER and high < 3 * _QUARTER:
                    pending += 1
                    low -= _QUARTER
                    high -= _QUARTER
                else:
                    break
                low <<= 1
                high = (high << 1) | 1
        # flush
        pending += 1
        emit(0 if low < _QUARTER else 1)
        return w.getvalue()

    def decode(self, data: bytes, n_symbols: int) -> np.ndarray:
        # Range decoding is inherently sequential; this loop is tuned for the
        # serving hot path: bits pre-unpacked once, cumulative table as Python
        # ints (bisect/compares beat np.searchsorted by ~10x per call at the
        # tiny alphabet sizes the fits coder sees), and the two-class case —
        # what the paper actually uses arithmetic coding for — gets a branch
        # with a single range split per symbol.  The arithmetic is identical
        # to the original Witten/Neal/Cleary loop: same symbols, bit for bit
        # (tests/test_serve_path.py checks against decode_reference).
        from bisect import bisect_right

        if n_symbols == 0:
            return np.empty(0, dtype=np.int64)
        bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8)).tolist()
        nb = len(bits)
        cum = self.cum.tolist()
        total = self.total
        binary = len(cum) == 3  # alphabet {0, 1}
        c1 = cum[1] if binary else 0
        half, quarter, three_q = _HALF, _QUARTER, 3 * _QUARTER
        low, high = 0, _MASK
        value = 0
        pos = 0
        for _ in range(_PRECISION):
            value = (value << 1) | (bits[pos] if pos < nb else 0)
            pos += 1
        out = []
        append = out.append
        for _ in range(n_symbols):
            span = high - low + 1
            target = ((value - low + 1) * total - 1) // span
            if binary:
                # split = low + span*c1//total is both high(0)+1 and low(1):
                # one multiply-divide decodes AND updates the range.
                split = low + span * c1 // total
                if target < c1:
                    append(0)
                    high = split - 1
                else:
                    append(1)
                    low = split
            else:
                s = bisect_right(cum, target) - 1
                append(s)
                high = low + span * cum[s + 1] // total - 1
                low = low + span * cum[s] // total
            while True:
                if high < half:
                    pass
                elif low >= half:
                    low -= half
                    high -= half
                    value -= half
                elif low >= quarter and high < three_q:
                    low -= quarter
                    high -= quarter
                    value -= quarter
                else:
                    break
                low <<= 1
                high = (high << 1) | 1
                value = (value << 1) | (bits[pos] if pos < nb else 0)
                pos += 1
        return np.array(out, dtype=np.int64)

    def decode_reference(self, data: bytes, n_symbols: int) -> np.ndarray:
        """Original decoder (seed-faithful; differential oracle + benchmark
        baseline)."""
        r = BitReader(data)
        total_bits = len(data) * 8

        def next_bit() -> int:
            return r.read_bit() if r.pos < total_bits else 0

        low, high = 0, _MASK
        value = 0
        for _ in range(_PRECISION):
            value = (value << 1) | next_bit()
        out = np.empty(n_symbols, dtype=np.int64)
        for i in range(n_symbols):
            span = high - low + 1
            target = ((value - low + 1) * self.total - 1) // span
            s = int(np.searchsorted(self.cum, target, side="right") - 1)
            out[i] = s
            high = low + span * int(self.cum[s + 1]) // self.total - 1
            low = low + span * int(self.cum[s]) // self.total
            while True:
                if high < _HALF:
                    pass
                elif low >= _HALF:
                    low -= _HALF
                    high -= _HALF
                    value -= _HALF
                elif low >= _QUARTER and high < 3 * _QUARTER:
                    low -= _QUARTER
                    high -= _QUARTER
                    value -= _QUARTER
                else:
                    break
                low <<= 1
                high = (high << 1) | 1
                value = (value << 1) | next_bit()
        return out
