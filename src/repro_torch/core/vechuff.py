"""Vectorized canonical Huffman codec over MANY independent streams.

The paper's per-tree Huffman coding is fine in pure Python; checkpoint
tensors have 1e8 symbols, so the tensor codec (tensor_codec.py) needs a
numpy-vectorized path:

  * ENCODE: per-symbol (code, length) lookup, then one flat bit-scatter +
    np.packbits — O(total bits) without a Python per-symbol loop.
  * DECODE: canonical decoding advanced bit-synchronously across all
    streams at once (the classic first_code/offset-per-length tables);
    the Python loop is over BITS-PER-STREAM, not total symbols, so
    decoding N streams of length L costs O(L * max_len) vector steps.

Streams are independent (one per tensor chunk) — which is also what lets
a restore path decode only the layers it needs (the paper's
predict-from-compressed property, §5).
"""
from __future__ import annotations

import numpy as np

from .huffman import DecodeTables, build_decode_tables


def _byte_windows(blob: bytes) -> np.ndarray:
    """(n_bytes + 1,) uint64 array: ``u[q]`` is the big-endian 64-bit value of
    payload bytes q..q+7 (zero-padded past the end).  The window of any bit
    position ``p`` is then one shift of ``u[p >> 3]`` — no per-bit unpacking."""
    raw = np.frombuffer(blob, dtype=np.uint8)
    padded = np.concatenate([raw, np.zeros(8, np.uint8)])
    u = np.zeros(raw.size + 1, dtype=np.uint64)
    for k in range(8):
        u = (u << np.uint64(8)) | padded[k : k + u.size].astype(np.uint64)
    return u


def decode_stream(t: DecodeTables, blob: bytes, n: int) -> np.ndarray:
    """Table-driven whole-stream canonical Huffman decode.

    Two strategies share the same tables, picked by symbol density:

    * dense streams (short codes): speculatively decode a symbol at EVERY
      bit offset — codes of length <= lut_bits resolve with one LUT gather;
      longer codes get their length from one searchsorted over the
      left-aligned canonical range ``ends`` and their symbol from rank
      arithmetic — then follow the true decode chain 0 -> +len(sym_0) -> ...
      through the precomputed successor list (all per-bit work is numpy; the
      only Python loop is the O(n_symbols) chain walk over plain lists);
    * sparse streams (avg code length > ~8 bits, e.g. regression fit
      alphabets with 1e4+ symbols): the all-positions pass would waste most
      of its work, so walk the chain directly, resolving each symbol with
      one LUT probe into the 64-bit byte-window table.
    """
    n = int(n)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if t.max_len == 0:
        raise ValueError("corrupt Huffman stream")
    if t.max_len > 57:  # 64-bit windows can't hold offset+code; rare/corrupt
        return _decode_stream_bitwise(t, blob, n)
    nbytes = len(blob)
    L = nbytes * 8
    if L == 0:
        raise ValueError("truncated Huffman stream")
    u = _byte_windows(blob)
    if L > 8 * n:  # sparse: per-symbol LUT chase beats the all-positions pass
        return _decode_chase(t, u, L, n)
    p = np.arange(L, dtype=np.int64)
    uq = u[p >> 3]
    off = (p & 7).astype(np.uint64)
    w = t.lut_bits
    win = ((uq >> (np.uint64(64 - w) - off)) & np.uint64((1 << w) - 1)).astype(
        np.int64
    )
    sym_at = t.lut_sym[win]
    len_at = t.lut_len[win]
    if t.max_len > w:
        hard = np.flatnonzero(sym_at < 0)
        if hard.size:
            ml = t.max_len
            vmax = (
                (u[hard >> 3] >> (np.uint64(64 - ml) - (hard & 7).astype(np.uint64)))
                & np.uint64((1 << ml) - 1)
            ).astype(np.int64)
            li = np.searchsorted(t.ends, vmax, side="right")
            ok = li < len(t.ends)
            length = np.minimum(li, len(t.ends) - 1) + 1
            offv = (vmax >> (ml - length)) - t.first_code[length]
            rank = t.rank_base[length] + offv
            ok &= (offv >= 0) & (offv < t.count_at[length])
            rank = np.clip(rank, 0, max(len(t.sym_by_rank) - 1, 0))
            sym_at[hard] = np.where(ok, t.sym_by_rank[rank], -1)
            len_at[hard] = np.where(ok, length, 0)
    # successor list; a symbol is only real if its code fits in the payload
    complete = (len_at > 0) & (p + len_at <= L)
    nxt = np.where(complete, p + len_at, L).tolist()
    syms = np.where(complete, sym_at, -1).tolist()
    out = []
    append = out.append
    pos = 0
    for _ in range(n):
        if pos >= L:
            raise ValueError("truncated Huffman stream")
        s = syms[pos]
        if s < 0:
            raise ValueError("corrupt Huffman stream")
        append(s)
        pos = nxt[pos]
    return np.array(out, dtype=np.int64)


def _decode_chase(t: DecodeTables, u: np.ndarray, L: int, n: int) -> np.ndarray:
    """Per-symbol chain walk: one 64-bit window shift + LUT probe per symbol,
    canonical ``ends``-bisect fallback for codes longer than the LUT."""
    from bisect import bisect_right

    u_l = u.tolist()
    lut_sym = t.lut_sym.tolist()
    lut_len = t.lut_len.tolist()
    ends = t.ends.tolist()
    first_code = t.first_code.tolist()
    count_at = t.count_at.tolist()
    rank_base = t.rank_base.tolist()
    sym_by_rank = t.sym_by_rank.tolist()
    w = t.lut_bits
    ml = t.max_len
    wmask = (1 << w) - 1
    mmask = (1 << ml) - 1
    out = []
    append = out.append
    pos = 0
    for _ in range(n):
        q = u_l[pos >> 3]
        r = pos & 7
        win = (q >> (64 - w - r)) & wmask
        s = lut_sym[win]
        if s >= 0:
            length = lut_len[win]
        else:
            v = (q >> (64 - ml - r)) & mmask
            li = bisect_right(ends, v)
            if li >= ml:
                raise ValueError("corrupt Huffman stream")
            length = li + 1
            off = (v >> (ml - length)) - first_code[length]
            if not 0 <= off < count_at[length]:
                raise ValueError("corrupt Huffman stream")
            s = sym_by_rank[rank_base[length] + off]
        pos += length
        if pos > L:
            raise ValueError("truncated Huffman stream")
        append(s)
    return np.array(out, dtype=np.int64)


def _decode_stream_bitwise(t: DecodeTables, blob: bytes, n: int) -> np.ndarray:
    """Per-symbol canonical decode (fallback for > 57-bit codes)."""
    bits = np.unpackbits(np.frombuffer(blob, dtype=np.uint8)).tolist()
    L = len(bits)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    for i in range(n):
        code = 0
        length = 0
        while True:
            if pos >= L:
                raise ValueError("truncated Huffman stream")
            code = (code << 1) | bits[pos]
            pos += 1
            length += 1
            if length > t.max_len:
                raise ValueError("corrupt Huffman stream")
            offv = code - int(t.first_code[length])
            if 0 <= offv < int(t.count_at[length]):
                out[i] = int(t.sym_by_rank[int(t.rank_base[length]) + offv])
                break
    return out


class VectorHuffman:
    """Canonical Huffman codec with vectorized encode/decode.

    lengths: (B,) int array of code lengths (0 = absent symbol).
    """

    def __init__(self, lengths: np.ndarray):
        self.lengths = np.asarray(lengths, dtype=np.int64)
        # shared table-driven canonical decode state (per-length first_code /
        # rank_base + width-min(max_len, 12) LUT) — see huffman.DecodeTables.
        t = build_decode_tables(self.lengths)
        self.tables = t
        self.max_len = t.max_len
        self.sym_by_rank = t.sym_by_rank
        self.first_code = t.first_code
        self.count_at = t.count_at
        self.rank_base = t.rank_base
        # per-symbol canonical codes from rank arithmetic (encode side)
        self.code_of = np.zeros(len(self.lengths), dtype=np.uint64)
        if t.sym_by_rank.size:
            lens_sorted = self.lengths[t.sym_by_rank]
            ranks = np.arange(t.sym_by_rank.size, dtype=np.int64)
            codes = t.first_code[lens_sorted] + (ranks - t.rank_base[lens_sorted])
            self.code_of[t.sym_by_rank] = codes.astype(np.uint64)

    # -- encode ------------------------------------------------------------
    def encode(self, symbols: np.ndarray) -> tuple[bytes, int]:
        """symbols (N,) -> (packed bytes, total bits)."""
        symbols = np.asarray(symbols).ravel()
        lens = self.lengths[symbols]
        codes = self.code_of[symbols].astype(np.uint64)
        total = int(lens.sum())
        if total == 0:
            return b"", 0
        ends = np.cumsum(lens)
        starts = ends - lens
        # flat index of every bit: for symbol i, bits land at starts[i]..ends[i)
        within = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
        rep_codes = np.repeat(codes, lens)
        rep_lens = np.repeat(lens, lens)
        shift = (rep_lens - 1 - within).astype(np.uint64)
        bits = ((rep_codes >> shift) & np.uint64(1)).astype(np.uint8)
        return np.packbits(bits).tobytes(), total

    # -- decode ------------------------------------------------------------
    # Byte-level finite state machine: states are the internal nodes of the
    # code tree; one transition per INPUT BYTE emits 0..8 symbols.  The
    # Python loop is over stream BYTES (vectorized across streams), so
    # decoding cost is O(compressed bytes / n_streams) iterations.
    _MAX_FSM_ALPHABET = 4096  # table build is O(states * 2048)

    def _build_fsm(self):
        if getattr(self, "_fsm", None) is not None:
            return
        if int((self.lengths > 0).sum()) > self._MAX_FSM_ALPHABET:
            raise ValueError(
                "alphabet too large for the byte-FSM decoder; "
                "use <= 12-bit quantization"
            )
        # rebuild the code tree: children[node] = [left, right]; negative
        # entries encode leaves as -(symbol+1)
        children: list[list[int]] = [[0, 0]]
        for sym in self.sym_by_rank:
            code = int(self.code_of[sym])
            length = int(self.lengths[sym])
            node = 0
            for i in range(length - 1, -1, -1):
                bit = (code >> i) & 1
                if i == 0:
                    children[node][bit] = -(int(sym) + 1)
                else:
                    nxt = children[node][bit]
                    if nxt <= 0:
                        children.append([0, 0])
                        nxt = len(children) - 1
                        children[node][bit] = nxt
                    node = nxt
        n_states = len(children)
        # a byte may finish one pending code AND start/finish floor(8/min)
        # fresh codes
        max_emit = 8 // max(self._min_len(), 1) + 1
        trans = np.zeros((n_states, 256), dtype=np.int32)
        emit_count = np.zeros((n_states, 256), dtype=np.int8)
        emit_syms = np.zeros((n_states, 256, max_emit), dtype=np.int64)
        for s in range(n_states):
            for byte in range(256):
                node = s
                cnt = 0
                for i in range(7, -1, -1):
                    nxt = children[node][(byte >> i) & 1]
                    if nxt <= 0:
                        emit_syms[s, byte, cnt] = -nxt - 1
                        cnt += 1
                        node = 0
                    else:
                        node = nxt
                trans[s, byte] = node
                emit_count[s, byte] = cnt
        self._fsm = (trans, emit_count, emit_syms, max_emit)

    def _min_len(self) -> int:
        nz = self.lengths[self.lengths > 0]
        return int(nz.min()) if nz.size else 1

    def decode_streams(
        self, blobs: list[bytes], n_symbols: np.ndarray
    ) -> list[np.ndarray]:
        """Decode many independent streams with one shared FSM."""
        n_streams = len(blobs)
        if n_streams == 0:
            return []
        self._build_fsm()
        trans, emit_count, emit_syms, max_emit = self._fsm
        n_symbols = np.asarray(n_symbols, dtype=np.int64)
        byte_arrays = [np.frombuffer(b, dtype=np.uint8) for b in blobs]
        max_bytes = max((a.size for a in byte_arrays), default=0)
        data = np.zeros((n_streams, max_bytes), dtype=np.uint8)
        for i, a in enumerate(byte_arrays):
            data[i, : a.size] = a
        max_syms = int(n_symbols.max(initial=0))
        # one scratch slot at the end absorbs post-quota emissions (zero
        # padding of short streams keeps the FSM running; writes past a
        # stream's quota are clamped there and never read back)
        cap = max_syms + 1
        out = np.zeros((n_streams, cap + 1), np.int64)

        state = np.zeros(n_streams, dtype=np.int32)
        pos = np.zeros(n_streams, dtype=np.int64)
        rows = np.arange(n_streams)
        for j in range(max_bytes):
            byte = data[:, j]
            cnt = emit_count[state, byte].astype(np.int64)
            syms = emit_syms[state, byte]  # (n_streams, max_emit)
            for e in range(max_emit):
                w = e < cnt
                idx = np.minimum(pos[w] + e, cap)
                out[rows[w], idx] = syms[w, e]
            pos = np.minimum(pos + cnt, cap)
            state = trans[state, byte]
        if (pos < n_symbols).any():
            raise ValueError("truncated Huffman stream")
        return [out[i, : n_symbols[i]] for i in range(n_streams)]

    # -- single-stream vectorized decode ----------------------------------
    def decode(self, blob: bytes, n: int) -> np.ndarray:
        """Table-driven whole-stream decode (see :func:`decode_stream`)."""
        return decode_stream(self.tables, blob, n)
