"""Packed DNA: the host packers (numpy) and the device ops (torch).

Host: a copy of pgrc_tpu/core/packed.py's numpy packers — `num_lanes`,
`pack_2bit`, `unpack_2bit`, `pack_text_2bit`, `pack_lanes` (native C++ fast
path) and `revcomp_codes_matrix` — with only the imports changed; the
reference's jax.numpy branch of `_xp` is not carried, so they take numpy
arrays only.

Device: lanes are the `pack_lanes` layout carried in int32: symbol j at
bits 2*(15 - j%16) of lane j//16, N packed as A, one zero pad lane; the N
mask holds bit 31 - j%32 of lane j//32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.uint import U32_MASK, i32_to_u32, u32_to_i32

SYMS_PER_LANE = 16


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Bit population count of u32 values carried in int64 (SWAR, as
    packed.py:76-82)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32_MASK) >> 24


def col_vals(lanes: torch.Tensor, nmask: torch.Tensor | None, t: int) -> torch.Tensor:
    """Symbol value (0..7: 2-bit code + 4 * N bit) of column t of every row,
    as int64 (port of greedy_scs._col_vals, :149-162). The arithmetic shifts
    are safe: every result is masked to the bits it keeps."""
    c = ((lanes[:, t // 16] >> (2 * (15 - t % 16))) & 3).to(torch.int64)
    if nmask is not None:
        c = c + (((nmask[:, t // 32] >> (31 - t % 32)) & 1).to(torch.int64) << 2)
    return c


def _swap_groups(v: torch.Tensor, width: int) -> torch.Tensor:
    """Reverse the order of `width`-bit groups within each u32 (int64 carrier)."""
    if width <= 16:
        v = ((v & 0x0000FFFF) << 16) | (v >> 16)
    if width <= 8:
        v = ((v & 0x00FF00FF) << 8) | ((v >> 8) & 0x00FF00FF)
    if width <= 4:
        v = ((v & 0x0F0F0F0F) << 4) | ((v >> 4) & 0x0F0F0F0F)
    if width <= 2:
        v = ((v & 0x33333333) << 2) | ((v >> 2) & 0x33333333)
    if width <= 1:
        v = ((v & 0x55555555) << 1) | ((v >> 1) & 0x55555555)
    return v


def _shift_left_lanes(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Shift a [n, W] u32 lane matrix (int64 carrier) left by `bits` < 32
    across lane boundaries; vacated low bits fill with zeros."""
    if bits == 0:
        return v
    nxt = torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])], dim=1)
    return ((v << bits) & U32_MASK) | (nxt >> (32 - bits))


def _spread16(x: torch.Tensor) -> torch.Tensor:
    """16 bits -> 32: each bit becomes a 2-bit group of copies."""
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x | (x << 1)


def revcomp_lanes(lanes: torch.Tensor, read_len: int,
                  nmask: torch.Tensor | None = None) -> torch.Tensor:
    """Reverse-complement packed rows (port of packed.revcomp_lanes, :205-253).

    `lanes` [n, W+1] int32 -> [n, W+1] int32 in the same layout, with the
    groups landing on (reversed) N positions cleared to A: N probes as A on
    both strands. The plain half of kernel I (`kernels.strand_rows`), which
    writes the matcher's strand rows on the card."""
    L = read_len
    W = (L + SYMS_PER_LANE - 1) // SYMS_PER_LANE
    n = lanes.shape[0]
    # complement (3 - v == NOT of each 2-bit group), reverse lanes, reverse
    # the 2-bit groups within each lane
    v = _swap_groups((~i32_to_u32(lanes[:, :W]) & U32_MASK).flip(1), 2)
    # the reversed read occupies the LAST L of the W*16 symbol slots
    v = _shift_left_lanes(v, 2 * (W * SYMS_PER_LANE - L))
    tail = L - (W - 1) * SYMS_PER_LANE
    if tail < SYMS_PER_LANE:
        v[:, W - 1] &= (U32_MASK << (32 - 2 * tail)) & U32_MASK
    if nmask is not None:
        Wn = (L + 31) // 32
        nb = _swap_groups(i32_to_u32(nmask[:, :Wn]).flip(1), 1)
        nb = _shift_left_lanes(nb, Wn * 32 - L)
        # each N bit becomes a 2-bit clear mask over the two code lanes one
        # nmask lane covers (bits 31..16 -> even lane, 15..0 -> odd)
        clear = torch.stack([_spread16(nb >> 16), _spread16(nb & 0xFFFF)],
                            dim=2).reshape(n, 2 * Wn)[:, :W]
        v = v & ~clear
    return torch.cat([u32_to_i32(v),
                      torch.zeros((n, 1), dtype=torch.int32, device=lanes.device)],
                     dim=1)


# ---- host packers (numpy), copied from pgrc_tpu/core/packed.py ----


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


def pack_lanes(codes: np.ndarray, n_pad: int | None = None):
    """Host-side packing of an ACGTN code matrix for the packed overlap/match
    kernels: returns (lanes [n_pad, W+1] uint32, nmask [n_pad, Wn+1] uint32
    or None). lanes hold 2-bit symbols (N packed as A) with one zero pad
    lane for cross-lane shifts; nmask holds N-position bits (bit 31-j%32 of
    lane j//32) and is None when the matrix has no N. Rows past n are zero.

    Native C++ fast path (native/packcodes.cpp); numpy fallback below.
    """
    n, L = codes.shape
    if n_pad is None:
        n_pad = n
    W = (L + 15) // 16
    Wn = (L + 31) // 32
    has_n = bool((codes > 3).any())
    from .. import native

    lanes = np.zeros((n_pad, W + 1), dtype=np.uint32)
    nmask = np.zeros((n_pad, Wn + 1), dtype=np.uint32) if has_n else None
    packed_ok = native.pack_lanes(codes, lanes[:n], nmask[:n] if has_n else None)
    if not packed_ok:
        pad = W * SYMS_PER_LANE - L
        c = codes & 0x3
        if pad:
            c = np.concatenate([c, np.zeros((n, pad), dtype=np.uint8)], axis=1)
        shifts = np.arange(SYMS_PER_LANE - 1, -1, -1, dtype=np.uint32) * np.uint32(2)
        lanes[:n, :W] = (
            c.astype(np.uint32).reshape(n, W, SYMS_PER_LANE) << shifts
        ).sum(axis=2, dtype=np.uint32)
        if has_n:
            padn = Wn * 32 - L
            nb = (codes > 3).astype(np.uint32)
            if padn:
                nb = np.concatenate([nb, np.zeros((n, padn), dtype=np.uint32)], axis=1)
            shifts_n = np.arange(31, -1, -1, dtype=np.uint32)
            nmask[:n, :Wn] = (nb.reshape(n, Wn, 32) << shifts_n).sum(axis=2, dtype=np.uint32)
    return lanes, nmask


def revcomp_codes_matrix(codes):
    """Reverse complement rows of an ACGTN code matrix (vector form of
    utils/helper.cpp:388-397)."""
    xp = _xp(codes)
    flipped = codes[:, ::-1]
    return xp.where(flipped <= 3, 3 - flipped, flipped).astype(codes.dtype)
