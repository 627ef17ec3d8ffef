"""LZW coding of the concatenated Zaks bitstream (paper §3.1).

The paper compresses all trees' Zaks sequences as ONE concatenated sequence
with "an LZ-based encoder", exploiting cross-tree structural redundancy
without paying any dictionary overhead.  We implement LZW over the binary
alphabet {0,1} with growing code width — dictionary-free on the wire, exactly
the property §2.2 highlights for the LZ family.
"""
from __future__ import annotations

import numpy as np

from .bitio import BitReader, BitWriter


def lzw_encode_bits(bits: np.ndarray) -> bytes:
    """LZW-encode a 0/1 numpy array. Returns the code stream (the symbol count
    travels in the codec header, not here)."""
    bits = np.asarray(bits, dtype=np.uint8)
    dictionary: dict[bytes, int] = {b"\x00": 0, b"\x01": 1}
    w = BitWriter()
    if len(bits) == 0:
        return w.getvalue()
    data = bits.tobytes()  # one byte per bit; fine for dictionary keys
    cur = data[0:1]
    for i in range(1, len(data)):
        nxt = cur + data[i : i + 1]
        if nxt in dictionary:
            cur = nxt
            continue
        width = max(1, (len(dictionary) - 1).bit_length())
        w.write_bits(dictionary[cur], width)
        dictionary[nxt] = len(dictionary)
        cur = data[i : i + 1]
    width = max(1, (len(dictionary) - 1).bit_length())
    w.write_bits(dictionary[cur], width)
    return w.getvalue()


def _extract_codes(payload: bytes, n_bits: int) -> np.ndarray:
    """Vectorized extraction of every LZW code in ``payload``.

    The dictionary grows by exactly one entry per decoded code, so the code
    widths are a deterministic sequence — ``1`` for the first code, then
    ``(2 + j).bit_length()`` for loop iteration ``j`` — and every code
    boundary is known before decoding starts.  Codes are pulled out with one
    windowed gather per distinct width (<= ~30 groups), no per-bit loop.
    """
    bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8)).astype(np.int64)
    total = bits.size
    # widths: enough codes to certainly cover the payload (each code >= 1 bit)
    j = np.arange(total, dtype=np.int64)
    widths = np.concatenate(
        [[1], (np.floor(np.log2(j + 2)).astype(np.int64) + 1)]
    )
    ends = np.cumsum(widths)
    k = int(np.searchsorted(ends, total, side="right"))  # codes fully inside
    widths = widths[:k]
    starts = ends[:k] - widths
    codes = np.zeros(k, dtype=np.int64)
    lo = 0
    while lo < k:
        w = int(widths[lo])
        hi = int(np.searchsorted(widths, w, side="right"))
        s = starts[lo:hi]
        window = bits[s[:, None] + np.arange(w)[None, :]]
        codes[lo:hi] = window @ (1 << np.arange(w - 1, -1, -1, dtype=np.int64))
        lo = hi
    return codes


def lzw_decode_bits(payload: bytes, n_bits: int) -> np.ndarray:
    """Inverse of :func:`lzw_encode_bits`; returns exactly ``n_bits`` bits."""
    if n_bits == 0:
        return np.empty(0, dtype=np.uint8)
    codes = _extract_codes(payload, n_bits)
    if len(codes) == 0:
        raise ValueError("corrupt LZW stream")
    entries = [b"\x00", b"\x01"]
    prev = entries[int(codes[0])]
    parts = [prev]
    pos = len(prev)
    n_entries = 2
    for i in range(1, len(codes)):
        if pos >= n_bits:
            break
        code = int(codes[i])
        if code < n_entries:
            entry = entries[code]
        elif code == n_entries:  # KwKwK corner case
            entry = prev + prev[0:1]
        else:
            raise ValueError("corrupt LZW stream")
        entries.append(prev + entry[0:1])
        n_entries += 1
        parts.append(entry)
        pos += len(entry)
        prev = entry
    if pos < n_bits:
        raise ValueError("corrupt LZW stream")
    buf = b"".join(parts)
    return np.frombuffer(buf, dtype=np.uint8)[:n_bits].copy()


def lzw_decode_bits_reference(payload: bytes, n_bits: int) -> np.ndarray:
    """Original bit-at-a-time decoder (differential oracle for the
    vectorized path; also the seed-faithful baseline in benchmarks)."""
    out = np.empty(n_bits, dtype=np.uint8)
    if n_bits == 0:
        return out
    dictionary: dict[int, bytes] = {0: b"\x00", 1: b"\x01"}
    r = BitReader(payload)

    # The encoder's dictionary grows BEFORE it emits the next code, so the
    # decoder mirrors that: after reading code k, it knows entry
    # len(dictionary) will be prev + first-byte-of(entry(k)).
    width = max(1, (len(dictionary) - 1).bit_length())
    code = r.read_bits(width)
    prev = dictionary[code]
    pos = 0
    out[pos : pos + len(prev)] = np.frombuffer(prev, dtype=np.uint8)
    pos += len(prev)
    while pos < n_bits:
        width = max(1, len(dictionary).bit_length())
        code = r.read_bits(width)
        if code in dictionary:
            entry = dictionary[code]
        elif code == len(dictionary):  # KwKwK corner case
            entry = prev + prev[0:1]
        else:
            raise ValueError("corrupt LZW stream")
        dictionary[len(dictionary)] = prev + entry[0:1]
        out[pos : pos + len(entry)] = np.frombuffer(entry, dtype=np.uint8)
        pos += len(entry)
        prev = entry
    return out
