"""Byte-frugal varints and small binary IO helpers.

Fills the role of the reference's writeUIntByteFrugal/readUIntByteFrugal and
writeValue/readValue (utils/helper.h:149-226) for our own PGTC container.
Batch variants are vectorized over numpy arrays (per-byte-position rounds:
at most 10 rounds for uint64).
"""
from __future__ import annotations

import struct
import numpy as np


def write_varint(out: bytearray, value: int) -> None:
    """LEB128-style: 7 bits per byte, high bit = continuation."""
    v = int(value)
    assert v >= 0
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_varint(buf, pos: int) -> tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, pos
        shift += 7


def encode_varints(values: np.ndarray) -> bytes:
    """Vectorized LEB128 encode of an unsigned array."""
    values = np.ascontiguousarray(values, dtype=np.uint64)
    if values.size == 0:
        return b""
    nbytes = np.ones(values.shape, dtype=np.int64)
    v = values >> np.uint64(7)
    while v.any():
        nbytes += (v != 0)
        v >>= np.uint64(7)
    ends = np.cumsum(nbytes)
    starts = ends - nbytes
    out = np.zeros(int(ends[-1]), dtype=np.uint8)
    v = values.copy()
    k = 0
    active = np.ones(values.shape, dtype=bool)
    while active.any():
        idx = starts[active] + k
        more = nbytes[active] > k + 1
        out[idx] = (v[active] & np.uint64(0x7F)).astype(np.uint8) | (more.astype(np.uint8) << 7)
        v >>= np.uint64(7)
        k += 1
        active = nbytes > k
    return out.tobytes()


def decode_varints(buf: bytes, count: int) -> np.ndarray:
    """Vectorized LEB128 decode of `count` values from the head of buf."""
    if count == 0:
        return np.zeros(0, dtype=np.uint64)
    data = np.frombuffer(buf, dtype=np.uint8)
    is_start = np.empty(data.shape, dtype=bool)
    is_start[0] = True
    is_start[1:] = (data[:-1] & 0x80) == 0
    starts = np.nonzero(is_start)[0][:count]
    if starts.size < count:
        raise ValueError("varint stream truncated")
    out = np.zeros(count, dtype=np.uint64)
    cur = starts.copy()
    shift = np.uint64(0)
    active = np.ones(count, dtype=bool)
    while active.any():
        b = data[cur[active]]
        out[active] |= (b.astype(np.uint64) & np.uint64(0x7F)) << shift
        more = (b & 0x80) != 0
        nxt = active.copy()
        nxt[active] = more
        cur[nxt] += 1
        active = nxt
        shift += np.uint64(7)
    return out


def varints_span(buf: bytes, count: int) -> int:
    """Number of bytes occupied by the first `count` varints in buf."""
    if count == 0:
        return 0
    data = np.frombuffer(buf, dtype=np.uint8)
    term = np.nonzero((data & 0x80) == 0)[0]
    if term.size < count:
        raise ValueError("varint stream truncated")
    return int(term[count - 1]) + 1


def pack_u32(v: int) -> bytes:
    return struct.pack("<I", v)


def unpack_u32(buf, pos: int) -> tuple[int, int]:
    return struct.unpack_from("<I", buf, pos)[0], pos + 4


def pack_u64(v: int) -> bytes:
    return struct.pack("<Q", v)


def unpack_u64(buf, pos: int) -> tuple[int, int]:
    return struct.unpack_from("<Q", buf, pos)[0], pos + 8
