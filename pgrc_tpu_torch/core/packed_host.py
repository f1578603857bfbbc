"""Packed DNA on the host: a copy of pgrc_tpu/core/packed.py's numpy
packers — `num_lanes`, `pack_2bit`, `unpack_2bit`, `pack_text_2bit`,
`pack_lanes` (packed by the native library) and `revcomp_codes_matrix` — with only
the imports changed; the reference's jax.numpy branch of `_xp` is not
carried, so they take numpy arrays only. `pack_lanes` also takes row ids
(`rows=`), and finds whether a row holds an N without an [n, L]
temporary (`rows_with_n`, `row_chunks`), so that the encoder packs the
rows of its one code matrix without a gathered copy. This module imports
no torch, so the decoder and the validator, which use only these, run
without it (`core.packed` re-exports them beside the device ops).
"""
from __future__ import annotations

import numpy as np

SYMS_PER_LANE = 16


def _xp(a):
    """Array namespace of the host packers: numpy (the reference also
    dispatched to jax.numpy, packed.py:23-29; the port does not)."""
    return np


def num_lanes(read_len: int) -> int:
    return (read_len + SYMS_PER_LANE - 1) // SYMS_PER_LANE


def pack_2bit(codes, read_len: int | None = None):
    """[N, L] uint8 codes (ACGT only; N must be pre-mapped) -> [N, W] uint32.

    Symbol j sits in lane j//16 at bit position 2*(15 - j%16); tail symbols of
    the last lane are zero-padded, so lane-tuple comparison == lexicographic
    string comparison.
    """
    xp = _xp(codes)
    n, length = codes.shape
    if read_len is None:
        read_len = length
    w = num_lanes(read_len)
    pad = w * SYMS_PER_LANE - length
    if pad:
        codes = xp.concatenate([codes, xp.zeros((n, pad), dtype=codes.dtype)], axis=1)
    c = (codes & 0x3).astype(xp.uint32).reshape(n, w, SYMS_PER_LANE)
    shifts = xp.arange(SYMS_PER_LANE - 1, -1, -1, dtype=xp.uint32) * xp.uint32(2)
    return (c << shifts).sum(axis=2).astype(xp.uint32)


def unpack_2bit(lanes, read_len: int):
    """[N, W] uint32 -> [N, L] uint8 codes (values 0..3)."""
    xp = _xp(lanes)
    n, w = lanes.shape
    shifts = xp.arange(SYMS_PER_LANE - 1, -1, -1, dtype=xp.uint32) * xp.uint32(2)
    c = (lanes[:, :, None] >> shifts) & xp.uint32(0x3)
    return c.reshape(n, w * SYMS_PER_LANE)[:, :read_len].astype(xp.uint8)


def pack_text_2bit(codes_1d):
    """1-D sequence codes -> uint32 lanes, 16 symbols/lane, zero-padded.

    Layout matches pack_2bit rows; used for the pseudogenome text so read
    windows can be verified against it lane-wise (see align/).
    """
    xp = _xp(codes_1d)
    n = codes_1d.shape[0]
    w = num_lanes(n)
    pad = w * SYMS_PER_LANE - n
    if pad:
        codes_1d = xp.concatenate([codes_1d, xp.zeros((pad,), dtype=codes_1d.dtype)])
    c = (codes_1d & 0x3).astype(xp.uint32).reshape(w, SYMS_PER_LANE)
    shifts = xp.arange(SYMS_PER_LANE - 1, -1, -1, dtype=xp.uint32) * xp.uint32(2)
    return (c << shifts).sum(axis=1).astype(xp.uint32)


# rows a chunk of the numpy packers and the N scans gather at once
CHUNK_ROWS = 1 << 16


def row_chunks(codes: np.ndarray, rows=None, chunk: int = CHUNK_ROWS):
    """(lo, codes[rows][lo:lo + chunk]) over every row of `codes`, or of
    the rows `rows` ([n] ids), one chunk gathered at a time."""
    n = codes.shape[0] if rows is None else len(rows)
    for lo in range(0, n, chunk):
        yield lo, codes[lo:lo + chunk] if rows is None else codes[rows[lo:lo + chunk]]


def rows_with_n(codes: np.ndarray, rows=None) -> np.ndarray:
    """[n] bool: which rows of `codes` (or of `rows`, [n] ids) hold an N,
    without an [n, L] temporary."""
    n = codes.shape[0] if rows is None else len(rows)
    out = np.zeros(n, dtype=bool)
    for lo, c in row_chunks(codes, rows):
        out[lo:lo + c.shape[0]] = (c > 3).any(axis=1)
    return out


def pack_lanes(codes: np.ndarray, n_pad: int | None = None, rows=None):
    """Host-side packing of an ACGTN code matrix for the packed overlap/match
    kernels: returns (lanes [n_pad, W+1] uint32, nmask [n_pad, Wn+1] uint32
    or None). lanes hold 2-bit symbols (N packed as A) with one zero pad
    lane for cross-lane shifts; nmask holds N-position bits (bit 31-j%32 of
    lane j//32) and is None when the matrix has no N. Rows past n are zero.
    With `rows` ([n] ids) row r packs codes[rows[r]]: the rows are gathered
    while they are packed, never copied out as a matrix.

    Packed by native/packcodes.cpp, which also counts the rows with an N,
    so the mask is made only when there is one.
    """
    n = codes.shape[0] if rows is None else len(rows)
    L = codes.shape[1]
    if n_pad is None:
        n_pad = n
    W = (L + 15) // 16
    Wn = (L + 31) // 32
    from .. import native

    lanes = np.zeros((n_pad, W + 1), dtype=np.uint32)
    if not native.pack_lanes(codes, lanes[:n], None, rows=rows):
        return lanes, None
    nmask = np.zeros((n_pad, Wn + 1), dtype=np.uint32)
    native.pack_lanes(codes, None, nmask[:n], rows=rows)
    return lanes, nmask


def revcomp_codes_matrix(codes):
    """Reverse complement rows of an ACGTN code matrix (vector form of
    utils/helper.cpp:388-397)."""
    xp = _xp(codes)
    flipped = codes[:, ::-1]
    return xp.where(flipped <= 3, 3 - flipped, flipped).astype(codes.dtype)
