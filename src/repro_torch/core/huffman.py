"""Canonical Huffman coding (paper §2.2, §3.2).

The codec operates on integer symbol ids ``0..B-1``.  Codes are *canonical*:
the dictionary only needs the code length of each symbol, which is what we
charge as overhead (the paper's ``alpha`` per dictionary line).

Guarantees (tested):
  * prefix-free, uniquely decodable,
  * average length within [H, H+1) of the empirical entropy,
  * lossless even when coding with a mismatched (cluster) distribution Q,
    provided Q gives every coded symbol nonzero mass (paper §5).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from .bitio import BitReader, BitWriter

_MAX_CODE_LEN = 58  # fits comfortably in python ints; depth bound for sanity


def code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Huffman code length per symbol. Zero-frequency symbols get length 0
    (they are not in the codebook and must never be coded)."""
    freqs = np.asarray(freqs, dtype=np.float64)
    alive = np.flatnonzero(freqs > 0)
    lengths = np.zeros(len(freqs), dtype=np.int32)
    if len(alive) == 0:
        return lengths
    if len(alive) == 1:
        lengths[alive[0]] = 1  # degenerate alphabet still needs 1 bit/symbol
        return lengths
    # classic heap construction over (freq, tiebreak, payload-of-symbols)
    heap = [(float(freqs[s]), int(s), [int(s)]) for s in alive]
    heapq.heapify(heap)
    tie = len(freqs)
    while len(heap) > 1:
        fa, _, syms_a = heapq.heappop(heap)
        fb, _, syms_b = heapq.heappop(heap)
        for s in syms_a:
            lengths[s] += 1
        for s in syms_b:
            lengths[s] += 1
        heapq.heappush(heap, (fa + fb, tie, syms_a + syms_b))
        tie += 1
    return lengths


def canonical_codes(lengths: np.ndarray) -> dict[int, tuple[int, int]]:
    """symbol -> (code, length), canonical ordering (length, then symbol id)."""
    order = sorted((int(l), int(s)) for s, l in enumerate(lengths) if l > 0)
    codes: dict[int, tuple[int, int]] = {}
    code = 0
    prev_len = 0
    for length, sym in order:
        code <<= length - prev_len
        codes[sym] = (code, length)
        code += 1
        prev_len = length
    return codes


_LUT_BITS_CAP = 12  # LUT width: min(max_len, 12) — table is <= 4096 entries


@dataclass
class DecodeTables:
    """Table-driven canonical decoding state.

    ``lut_sym``/``lut_len`` resolve every code of length <= ``lut_bits`` with a
    single ``lut_bits``-wide window lookup; longer codes fall through to the
    per-length ``first_code``/``rank_base`` comparisons (the classic canonical
    decoder: a length-``l`` window ``c`` is a valid code iff
    ``0 <= c - first_code[l] < count_at[l]``, and its symbol is
    ``sym_by_rank[rank_base[l] + c - first_code[l]]``).
    """

    max_len: int
    lut_bits: int
    lut_sym: np.ndarray  # (1 << lut_bits,) int64; -1 => code longer than LUT
    lut_len: np.ndarray  # (1 << lut_bits,) int64; 0 where lut_sym == -1
    first_code: np.ndarray  # (max_len + 2,) int64
    count_at: np.ndarray  # (max_len + 2,) int64
    rank_base: np.ndarray  # (max_len + 2,) int64; #codes shorter than l
    sym_by_rank: np.ndarray  # (n_codes,) int64, sorted by (length, symbol)
    ends: np.ndarray  # (max_len,) left-aligned exclusive end of length-l codes


def build_decode_tables(
    lengths: np.ndarray, lut_bits_cap: int | None = None
) -> DecodeTables:
    lengths = np.asarray(lengths, dtype=np.int64)
    nz = np.flatnonzero(lengths > 0)
    max_len = int(lengths[nz].max()) if nz.size else 0
    if lut_bits_cap is None:
        # large alphabets (regression fit dictionaries reach 1e4+ symbols)
        # get a wider LUT so typical codes still resolve in one probe
        lut_bits_cap = _LUT_BITS_CAP
        if nz.size > (1 << _LUT_BITS_CAP):
            lut_bits_cap = min(16, int(np.ceil(np.log2(nz.size))) + 1)
    lut_bits = max(1, min(max_len, lut_bits_cap))
    lut_sym = np.full(1 << lut_bits, -1, dtype=np.int64)
    lut_len = np.zeros(1 << lut_bits, dtype=np.int64)
    first_code = np.zeros(max_len + 2, dtype=np.int64)
    count_at = np.zeros(max_len + 2, dtype=np.int64)
    rank_base = np.zeros(max_len + 2, dtype=np.int64)
    ends = np.zeros(max(max_len, 1), dtype=np.int64)
    if nz.size == 0:
        return DecodeTables(
            max_len, lut_bits, lut_sym, lut_len,
            first_code, count_at, rank_base, nz.astype(np.int64), ends,
        )
    sym_by_rank = nz[np.lexsort((nz, lengths[nz]))]  # by (length, symbol)
    cnt = np.bincount(lengths[sym_by_rank], minlength=max_len + 2)
    count_at[: len(cnt)] = cnt[: max_len + 2]
    rank_base[1:] = np.cumsum(count_at)[:-1]  # rank_base[l] = #codes len < l
    # canonical code assignment: fc[l] = (fc[l-1] + count[l-1]) << 1, and the
    # left-aligned (max_len-bit) code ranges of successive lengths tile
    # [0, 2^max_len) in increasing order — that is what lets the decoder find
    # a window's code length with one searchsorted over ``ends``.
    fc = 0
    for length in range(1, max_len + 1):
        first_code[length] = fc
        ends[length - 1] = (fc + int(count_at[length])) << (max_len - length)
        fc = (fc + int(count_at[length])) << 1
    for length in range(1, lut_bits + 1):  # LUT: one segment per length
        c = int(count_at[length])
        if c == 0:
            continue
        span = 1 << (lut_bits - length)
        base = int(first_code[length]) << (lut_bits - length)
        seg = sym_by_rank[int(rank_base[length]) : int(rank_base[length]) + c]
        lut_sym[base : base + c * span] = np.repeat(seg, span)
        lut_len[base : base + c * span] = length
    return DecodeTables(
        max_len, lut_bits, lut_sym, lut_len,
        first_code, count_at, rank_base, sym_by_rank, ends,
    )


@dataclass
class HuffmanCode:
    """A canonical Huffman codebook over symbols 0..B-1."""

    lengths: np.ndarray  # (B,) int32; 0 => symbol absent from codebook

    def __post_init__(self) -> None:
        self.lengths = np.asarray(self.lengths, dtype=np.int32)
        nzl = self.lengths[self.lengths > 0]
        self._min_len = int(nzl.min()) if nzl.size else 0
        self._max_len = int(nzl.max()) if nzl.size else 0
        # (code, length) dicts and decode tables are built lazily: encoders
        # touch _codes, bitwise decoding touches _decode, the table-driven
        # serving path touches tables() — none should pay for the others
        # (fit alphabets reach 1e4+ symbols).
        self._codes_map: dict[int, tuple[int, int]] | None = None
        self._decode_map: dict[tuple[int, int], int] | None = None
        self._tables: DecodeTables | None = None

    @property
    def _codes(self) -> dict[int, tuple[int, int]]:
        if self._codes_map is None:
            self._codes_map = canonical_codes(self.lengths)
        return self._codes_map

    @property
    def _decode(self) -> dict[tuple[int, int], int]:
        if self._decode_map is None:
            self._decode_map = {
                (l, c): s for s, (c, l) in self._codes.items()
            }
        return self._decode_map

    def tables(self) -> DecodeTables:
        if self._tables is None:
            self._tables = build_decode_tables(self.lengths)
        return self._tables

    @classmethod
    def from_freqs(cls, freqs: np.ndarray) -> "HuffmanCode":
        return cls(code_lengths(freqs))

    @property
    def alphabet_size(self) -> int:
        return len(self.lengths)

    def encode_symbol(self, w: BitWriter, sym: int) -> None:
        code, length = self._codes[int(sym)]
        w.write_bits(code, length)

    def decode_symbol_bitwise(self, r: BitReader) -> int:
        """Reference bit-at-a-time decoder (kept as the differential oracle
        for the table-driven paths; see tests/test_serve_path.py)."""
        code = 0
        length = 0
        while True:
            code = (code << 1) | r.read_bit()
            length += 1
            sym = self._decode.get((length, code))
            if sym is not None:
                return sym
            if length > _MAX_CODE_LEN:
                raise ValueError("corrupt Huffman stream")

    def decode_symbol(self, r: BitReader) -> int:
        """Table-driven decode: one LUT probe resolves codes of length
        <= min(max_len, 12); longer codes use per-length canonical compares.
        peek_bits speculates with zero padding past the payload, but a code
        is only consumed if it fits inside the remaining real bits."""
        t = self.tables()
        if t.max_len == 0:
            raise ValueError("corrupt Huffman stream")
        win = r.peek_bits(t.lut_bits)
        sym = int(t.lut_sym[win])
        if sym >= 0:
            length = int(t.lut_len[win])
            if r.remaining() < length:
                raise ValueError("truncated Huffman stream")
            r.skip(length)
            return sym
        code = r.peek_bits(t.max_len)
        for length in range(t.lut_bits + 1, t.max_len + 1):
            c = code >> (t.max_len - length)
            off = c - int(t.first_code[length])
            if 0 <= off < int(t.count_at[length]):
                if r.remaining() < length:
                    raise ValueError("truncated Huffman stream")
                r.skip(length)
                return int(t.sym_by_rank[int(t.rank_base[length]) + off])
        raise ValueError("corrupt Huffman stream")

    def encode(self, symbols) -> bytes:
        w = BitWriter()
        n = 0
        for s in symbols:
            self.encode_symbol(w, s)
            n += 1
        return w.getvalue()

    def decode(self, data: bytes, n_symbols: int) -> np.ndarray:
        """Whole-stream decode via the vectorized table-driven path."""
        if n_symbols == 0:
            return np.zeros(0, dtype=np.int64)
        from .vechuff import decode_stream  # deferred: vechuff imports us

        return decode_stream(self.tables(), data, n_symbols)

    def decode_bitwise(self, data: bytes, n_symbols: int) -> np.ndarray:
        r = BitReader(data)
        return np.array(
            [self.decode_symbol_bitwise(r) for _ in range(n_symbols)],
            dtype=np.int64,
        )

    def encoded_bits(self, counts: np.ndarray) -> int:
        """Exact bit cost of coding ``counts[s]`` occurrences of each symbol."""
        counts = np.asarray(counts)
        return int((counts * self.lengths).sum())

    def dictionary_bits(self, alpha_bits: float) -> float:
        """Paper's dictionary overhead: alpha bits per dictionary line."""
        return float((self.lengths > 0).sum()) * alpha_bits


def entropy_bits(counts: np.ndarray) -> float:
    """n * empirical entropy, in bits."""
    counts = np.asarray(counts, dtype=np.float64)
    n = counts.sum()
    if n == 0:
        return 0.0
    p = counts[counts > 0] / n
    return float(-n * (p * np.log2(p)).sum())
