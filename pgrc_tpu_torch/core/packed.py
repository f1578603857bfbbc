"""Packed DNA: the host packers (numpy, in `packed_host`, re-exported
here) and the device ops (torch).

Device: lanes are the `pack_lanes` layout carried in int32: symbol j at
bits 2*(15 - j%16) of lane j//16, N packed as A, one zero pad lane; the N
mask holds bit 31 - j%32 of lane j//32. The matcher keeps them row-major
([n, W+1]); the overlap sweep's table stores them column-major ([W+1, n],
lane c of every row contiguous: `empty_cols`, `col_vals`), so that a round
reads each column it needs coalesced.
"""
from __future__ import annotations

import torch

from ..utils.uint import U32_MASK, i32_to_u32, u32_to_i32
from .packed_host import (SYMS_PER_LANE, num_lanes, pack_2bit, pack_lanes,  # noqa: F401
                          pack_text_2bit, revcomp_codes_matrix, row_chunks, rows_with_n,
                          unpack_2bit)


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Bit population count of u32 values carried in int64 (SWAR, as
    packed.py:76-82)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32_MASK) >> 24


# words the column stride of a column-major table is rounded up to: every
# column starts on a 128-byte line
COL_ALIGN = 32


def empty_cols(cols: int, rows: int, device) -> torch.Tensor:
    """An uninitialised column-major int32 table [cols, rows]: a view of
    [cols, ld] storage, ld = rows rounded up to COL_ALIGN words, so column
    c of every row is contiguous and starts on a 128-byte line."""
    ld = -(-rows // COL_ALIGN) * COL_ALIGN
    return torch.empty((cols, ld), dtype=torch.int32, device=device)[:, :rows]


def cols_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of a column-major table (any column stride) in `empty_cols`
    storage."""
    out = empty_cols(t.shape[0], t.shape[1], t.device)
    out.copy_(t)
    return out


def col_vals(lanes: torch.Tensor, nmask: torch.Tensor | None, t: int) -> torch.Tensor:
    """Symbol value (0..7: 2-bit code + 4 * N bit) of column t of every row
    of a column-major table (lanes [W+1, n], nmask [Wn+1, n] or None), as
    int64 (port of greedy_scs._col_vals, :149-162). The arithmetic shifts
    are safe: every result is masked to the bits it keeps."""
    c = ((lanes[t // 16] >> (2 * (15 - t % 16))) & 3).to(torch.int64)
    if nmask is not None:
        c = c + (((nmask[t // 32] >> (31 - t % 32)) & 1).to(torch.int64) << 2)
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
