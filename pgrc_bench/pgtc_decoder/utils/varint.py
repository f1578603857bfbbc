"""Byte-frugal varints, the reading side.

Fills the role of the reference's readUIntByteFrugal (utils/helper.h:149-226)
for our own PGTC container. The batch variant is vectorized over numpy
arrays (per-byte-position rounds: at most 10 rounds for uint64).
"""
from __future__ import annotations

import numpy as np


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
