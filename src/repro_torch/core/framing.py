"""Byte-honest framing primitives shared by every serializer in the repo.

One length-prefixed array/bytes wire format shared by every serializer
(dtype-tag + shape + raw bytes): the inline ``CompressedForest`` (RFC1) and
the store formats (RFS1/RFD1/RFT1/RFM1) must never diverge, so both call
here.  The normative byte-level description of every frame built from
these primitives lives in ``docs/format.md``.

Primitives:

* ``write_arr`` / ``read_arr`` — the ARR record: dtype tag + shape + raw
  little-endian bytes;
* ``write_bytes`` / ``read_bytes`` — the BYTES record: u32 length prefix +
  raw bytes;
* ``write_u16`` / ``read_u16``, ``write_u32`` / ``read_u32`` — bare
  little-endian scalars (codebook generations, element counts).

Integrity (ISSUE 6): every read is bounds-checked against the remaining
buffer — a corrupted or truncated length field raises a typed
``TruncatedFrameError`` / ``IntegrityError`` instead of attempting an
unbounded allocation or returning silently-short data — and every
top-level frame writer appends a CRC32 trailer (``with_crc``) that
``check_crc`` verifies and strips on read.  CRC-less frames written
before the trailer existed still parse (``docs/format.md`` §8).
"""
from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np


class FramingError(ValueError):
    """Base for every typed framing fault (subclasses ``ValueError`` so
    pre-existing ``except ValueError`` callers keep working)."""


class TruncatedFrameError(FramingError):
    """A length field points past the end of the frame, or the frame ends
    mid-record — the payload cannot be read in full."""


class IntegrityError(FramingError):
    """The frame's bytes are internally inconsistent: CRC mismatch, bad
    magic, an impossible dtype tag, or a shape that contradicts the
    element count."""


class UnrepairableError(IntegrityError):
    """Corruption was DETECTED but could not be REPAIRED: more than one
    shard of a parity group is corrupt or missing, so XOR reconstruction
    cannot recover the bytes (``store.durable``).  Subclasses
    ``IntegrityError`` so every quarantine/rejection path that handles
    detected corruption handles the unrepairable case identically —
    never a silent wrong artifact."""


#: CRC trailer layout: this magic + u32 CRC32 of every preceding byte.
CRC_MAGIC = b"CRC1"

#: Upper bound on ARR ndim — anything larger is a corrupted header, not a
#: real tensor (the codec never writes past 2 dimensions).
_MAX_NDIM = 8


def _read_exact(inp: io.BytesIO, n: int, what: str) -> bytes:
    """Read exactly ``n`` bytes or raise ``TruncatedFrameError`` — never
    return a silent short read."""
    b = inp.read(n)
    if len(b) != n:
        raise TruncatedFrameError(
            f"truncated frame: wanted {n} bytes for {what}, got {len(b)}"
        )
    return b


def _remaining(inp: io.BytesIO) -> int | None:
    """Bytes left in the buffer, or ``None`` for non-seekable streams."""
    try:
        return len(inp.getbuffer()) - inp.tell()
    except (AttributeError, io.UnsupportedOperation):
        return None


def _check_length(inp: io.BytesIO, nbytes: int, what: str) -> None:
    """Clamp an untrusted length field against the remaining buffer BEFORE
    allocating — a flipped bit in a u32 length must not turn into a
    multi-gigabyte allocation attempt."""
    rem = _remaining(inp)
    if rem is not None and nbytes > rem:
        raise TruncatedFrameError(
            f"truncated frame: {what} claims {nbytes} bytes but only "
            f"{rem} remain"
        )


def write_u16(out: io.BytesIO, v: int) -> None:
    """Write one little-endian uint16 scalar."""
    out.write(struct.pack("<H", v))


def read_u16(inp: io.BytesIO) -> int:
    """Read one little-endian uint16 scalar."""
    return struct.unpack("<H", _read_exact(inp, 2, "u16"))[0]


def write_u32(out: io.BytesIO, v: int) -> None:
    """Write one little-endian uint32 scalar."""
    out.write(struct.pack("<I", v))


def read_u32(inp: io.BytesIO) -> int:
    """Read one little-endian uint32 scalar."""
    return struct.unpack("<I", _read_exact(inp, 4, "u32"))[0]


def read_struct(inp: io.BytesIO, fmt: str, what: str) -> tuple:
    """Read one packed struct with bounds checking — frame parsers use
    this instead of bare ``struct.unpack(fmt, inp.read(n))`` so a
    truncated header raises ``TruncatedFrameError``, not ``struct.error``."""
    return struct.unpack(fmt, _read_exact(inp, struct.calcsize(fmt), what))


def write_arr(out: io.BytesIO, a: np.ndarray) -> None:
    """Write one ARR record: u8 dtype-tag length, the numpy dtype string
    (e.g. ``<i4``), u8 ndim, u32 total element count, u32 per-axis sizes,
    then the raw little-endian element bytes."""
    a = np.ascontiguousarray(a)
    dt = a.dtype.str.encode()
    out.write(struct.pack("<B", len(dt)))
    out.write(dt)
    out.write(struct.pack("<BI", a.ndim, a.size))
    for s in a.shape:
        out.write(struct.pack("<I", s))
    out.write(a.tobytes())


def read_arr(inp: io.BytesIO) -> np.ndarray:
    """Read one ARR record written by ``write_arr``.

    Every field is validated before use: the dtype tag must parse, ndim
    must be plausible, the per-axis sizes must multiply to the element
    count, and the payload length is clamped against the remaining buffer
    — corrupted headers raise ``IntegrityError`` /
    ``TruncatedFrameError`` instead of allocating from garbage."""
    (dl,) = struct.unpack("<B", _read_exact(inp, 1, "ARR dtype-tag length"))
    tag = _read_exact(inp, dl, "ARR dtype tag")
    try:
        dt = np.dtype(tag.decode("ascii"))
    except (UnicodeDecodeError, TypeError, ValueError) as e:
        raise IntegrityError(f"ARR record has invalid dtype tag {tag!r}") \
            from e
    ndim, size = struct.unpack("<BI", _read_exact(inp, 5, "ARR header"))
    if ndim > _MAX_NDIM:
        raise IntegrityError(f"ARR record claims ndim={ndim} (max {_MAX_NDIM})")
    shape = tuple(
        struct.unpack("<I", _read_exact(inp, 4, "ARR shape"))[0]
        for _ in range(ndim)
    )
    if int(np.prod(shape, dtype=np.int64)) != size:
        raise IntegrityError(
            f"ARR record shape {shape} does not match element count {size}"
        )
    nbytes = size * dt.itemsize
    _check_length(inp, nbytes, "ARR payload")
    raw = _read_exact(inp, nbytes, "ARR payload")
    return np.frombuffer(raw, dtype=dt).reshape(shape)


def write_bytes(out: io.BytesIO, b: bytes) -> None:
    """Write one BYTES record: u32 length prefix + raw bytes."""
    out.write(struct.pack("<I", len(b)))
    out.write(b)


def read_bytes(inp: io.BytesIO) -> bytes:
    """Read one BYTES record written by ``write_bytes``.  The length prefix
    is clamped against the remaining buffer; a short payload raises
    ``TruncatedFrameError`` instead of returning silently-short bytes."""
    (n,) = struct.unpack("<I", _read_exact(inp, 4, "BYTES length"))
    _check_length(inp, n, "BYTES payload")
    return _read_exact(inp, n, "BYTES payload")


# ---------------------------------------------------------------------------
# frame-level integrity: CRC32 trailers + typed magic checks
# ---------------------------------------------------------------------------

def with_crc(payload: bytes) -> bytes:
    """Append the CRC trailer (``CRC1`` magic + u32 CRC32 of ``payload``)
    — what every frame writer emits since ISSUE 6."""
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return payload + CRC_MAGIC + struct.pack("<I", crc)


def check_crc(data: bytes, what: str = "frame") -> bytes:
    """Verify and strip a frame's CRC trailer, returning the bare payload.

    Backward compatible: frames written before the trailer existed (no
    ``CRC1`` magic at the end) pass through unchanged — but when a trailer
    IS present, a mismatch raises ``IntegrityError`` (the frame was
    corrupted in storage or transit, and decoding it would yield a
    silently wrong artifact)."""
    if len(data) >= 8 and data[-8:-4] == CRC_MAGIC:
        payload = data[:-8]
        (want,) = struct.unpack("<I", data[-4:])
        got = zlib.crc32(payload) & 0xFFFFFFFF
        if got != want:
            raise IntegrityError(
                f"{what}: CRC mismatch (stored 0x{want:08x}, computed "
                f"0x{got:08x}) — the frame is corrupted"
            )
        return payload
    return data


def expect_magic(inp: io.BytesIO, magic: bytes, what: str) -> None:
    """Read and verify a frame's magic; a mismatch is a typed
    ``IntegrityError`` instead of a bare ``AssertionError``."""
    got = _read_exact(inp, len(magic), f"{what} magic")
    if got != magic:
        raise IntegrityError(
            f"{what}: bad magic {got!r} (expected {magic!r})"
        )


# ---------------------------------------------------------------------------
# durable writes: the one atomic-write helper every on-disk frame shares
# ---------------------------------------------------------------------------

def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a rename into it survives power loss.  POSIX
    makes the rename itself atomic but not durable: until the directory
    inode is flushed, a crash can forget the new name entirely.  No-op on
    platforms whose directories refuse ``os.open`` (e.g. Windows)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically AND durably: write to a
    same-directory temp file, flush + fsync the file, ``os.replace`` onto
    the final name, then fsync the containing directory.  After a crash at
    any instant the path holds either the complete old bytes or the
    complete new bytes — never a prefix (the durable store's whole
    recovery story rests on this; the migration journal shares it)."""
    directory = os.path.dirname(os.path.abspath(path))
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(directory)
