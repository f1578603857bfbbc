"""Kernels K and L: the matcher's interleaved-anchor rescue on the card
(csrc/rescue.cu).

K, `rescue_table`, replaces matcher.py `_build_rescue_index` (:763-791):
each 2^20-bucket's first TABLE_CAP entries in ascending position, the
reference's candidates, as slots (j << 12) | (hash & 0xFFF) of entry j at
pg position j * k1, -1 where a bucket has fewer. L, `rescue_best`,
replaces the forward and reverse-complement calls of `_interleaved_rescue`
(:794-849): per read and strand the least (mismatches, start) over the
candidates of its interleaved anchors, as (mis << POS_BITS) | start, -1
for none. The pg is read from its packed lanes, or from its 1-byte codes
where given (a pg that holds a code above 3: the lanes pack N as A).
"""
from __future__ import annotations

import torch

from ..overlap.host import HASH_BASE
from ..utils.uint import U32_MASK, i32_to_u32
from . import check, launch, launches, on_cpu, ptr

_B = int(HASH_BASE)
BUCKET_BITS = 20        # the reference's `bits`
LOW_BITS = 32 - BUCKET_BITS
TABLE_CAP = 4           # the reference's `cap`
POS_BITS = 40           # rescue_best's start field
MAX_L = 256
MAX_K = 16              # a window of 2k - 1 symbols spans at most 3 lanes
# candidate windows the plain rescue_best counts at once (bounds its
# [windows, L] temporaries)
_PLAIN_CHUNK = 1 << 16


def n_entries(pg_len: int, k: int, k1: int) -> int:
    """Sampled positions p = j * k1 with p < pg_len - 2k + 1."""
    return -(-max(pg_len - 2 * k + 1, 0) // k1)


def _pg_syms(pg_lanes, pg_bytes, pos):
    """The pg's symbols at positions `pos` (int64, any shape): its 1-byte
    codes where given, else the 2-bit codes of the packed lanes."""
    if pg_bytes is not None:
        return pg_bytes[pos].to(torch.int64)
    lane = i32_to_u32(pg_lanes[pos >> 4])
    return (lane >> (2 * (15 - (pos & 15)))) & 3


def rescue_table_plain(pg_lanes, pg_len: int, k: int, k1: int, pg_bytes=None):
    """[2^20, TABLE_CAP] int64: bucket b's first entries in ascending
    position (a stable sort by bucket, then each run's first TABLE_CAP)."""
    dev = pg_lanes.device
    n_ent = n_entries(pg_len, k, k1)
    j = torch.arange(n_ent, dtype=torch.int64, device=dev)
    h = torch.zeros_like(j)
    for t in range(k):
        h = (h * _B + _pg_syms(pg_lanes, pg_bytes, j * k1 + 2 * t)) & U32_MASK
    b = h >> LOW_BITS
    bs, order = torch.sort(b, stable=True)
    rank = torch.arange(n_ent, dtype=torch.int64, device=dev) - torch.searchsorted(bs, bs)
    keep = rank < TABLE_CAP
    table = torch.full((1 << BUCKET_BITS, TABLE_CAP), -1, dtype=torch.int64, device=dev)
    order = order[keep]
    table.view(-1)[bs[keep] * TABLE_CAP + rank[keep]] = (order << LOW_BITS) | (
        h[order] & ((1 << LOW_BITS) - 1))
    return table


def rescue_table(pg_lanes: torch.Tensor, pg_len: int, k: int, k1: int,
                 pg_bytes: torch.Tensor | None = None) -> torch.Tensor:
    """pg_lanes [ceil(pg_len / 16) + 1] int32 (`state.pg_lanes_to_device`:
    the packed pg and its zero pad lane), pg_bytes [pg_len] uint8 or None
    -> the candidate table [2^20, TABLE_CAP] int64 of the interleaved
    anchors of k symbols (every second of 2k - 1) sampled every k1. CUDA
    tensors run kernel K."""
    check(pg_lanes, "pg_lanes", torch.int32, (-(-pg_len // 16) + 1,))
    if pg_bytes is not None:
        check(pg_bytes, "pg_bytes", torch.uint8, (pg_len,))
    if not 1 <= k <= MAX_K or k1 < 1:
        raise ValueError(f"kernel K needs 1 <= k <= {MAX_K} and k1 >= 1, got {k}, {k1}")
    if on_cpu(pg_lanes, pg_bytes):
        return rescue_table_plain(pg_lanes, pg_len, k, k1, pg_bytes)
    table = torch.empty((1 << BUCKET_BITS, TABLE_CAP), dtype=torch.int64,
                        device=pg_lanes.device)
    launch("pgrc_rescue_table", pg_lanes.device, ptr(pg_lanes), pg_lanes.numel(),
           ptr(pg_bytes), n_entries(pg_len, k, k1), k, k1, ptr(table))
    launches["rescue_table"] += 1
    return table


def strands(codes: torch.Tensor) -> torch.Tensor:
    """[2n, L] int64: the reads' 1-byte codes as they are, then their reverse
    complements with every code above 3 set to 0 (matcher.py:305-307)."""
    f = codes.to(torch.int64)
    r = f.flip(1)
    return torch.cat([f, torch.where(r <= 3, 3 - r, 0)])


def candidate_windows(rows, table, pg_len: int, k: int, k1: int) -> torch.Tensor:
    """The distinct (row, start) windows that the strand rows `rows` [R, L]
    int64 reach through the table: per anchor offset, each slot of its
    bucket whose full hash is the anchor's and whose start lies in [0,
    pg_len - L], as row << POS_BITS | start, ascending."""
    R, L = rows.shape
    dev = rows.device
    n_off = L - 2 * k + 1
    if R == 0 or n_off <= 0:
        return torch.zeros((0,), dtype=torch.int64, device=dev)
    h = torch.zeros((R, n_off), dtype=torch.int64, device=dev)
    for t in range(k):
        h = (h * _B + rows[:, 2 * t:2 * t + n_off]) & U32_MASK
    cand = table[h >> LOW_BITS]                            # [R, n_off, cap]
    off = torch.arange(n_off, dtype=torch.int64, device=dev)[None, :, None]
    start = (cand >> LOW_BITS) * k1 - off
    low = (1 << LOW_BITS) - 1
    ok = ((cand >= 0) & ((cand & low) == (h & low)[..., None])
          & (start >= 0) & (start <= pg_len - L))
    row = torch.arange(R, dtype=torch.int64, device=dev)[:, None, None].expand_as(start)
    return torch.unique(row[ok] * (1 << POS_BITS) + start[ok])


def rescue_best_plain(codes, table, pg_lanes, pg_len: int, k: int, k1: int, max_mis: int,
                      pg_bytes=None):
    """[2n] int64: for each strand row, the least (mis, start) over its
    candidate windows with mis <= max_mis, as (mis << POS_BITS) | start."""
    rows = strands(codes)
    R, L = rows.shape
    windows = candidate_windows(rows, table, pg_len, k, k1)
    cols = torch.arange(L, dtype=torch.int64, device=rows.device)
    none = torch.iinfo(torch.int64).max
    keys = torch.full((R,), none, dtype=torch.int64, device=rows.device)
    for lo in range(0, windows.numel(), _PLAIN_CHUNK):
        w = windows[lo:lo + _PLAIN_CHUNK]
        r, s = w >> POS_BITS, w & ((1 << POS_BITS) - 1)
        mis = (_pg_syms(pg_lanes, pg_bytes, s[:, None] + cols) != rows[r]).sum(dim=1)
        good = mis <= max_mis
        keys.scatter_reduce_(0, r[good], (mis[good] << POS_BITS) | s[good], "amin")
    return torch.where(keys == none, -1, keys)


def rescue_best(codes: torch.Tensor, table: torch.Tensor, pg_lanes: torch.Tensor, pg_len: int,
                k: int, k1: int, max_mis: int,
                pg_bytes: torch.Tensor | None = None) -> torch.Tensor:
    """codes [n, L] uint8 the reads' 1-byte codes, `table` K's for (k, k1),
    the pg as K took it, max_mis <= 254 -> [2n] int64: row r < n forward,
    n + r reverse complement, each (mis << POS_BITS) | start of its best
    window, -1 for none. CUDA tensors run kernel L."""
    n, L = codes.shape
    check(codes, "codes", torch.uint8, (n, L))
    check(table, "table", torch.int64, (1 << BUCKET_BITS, TABLE_CAP))
    check(pg_lanes, "pg_lanes", torch.int32, (-(-pg_len // 16) + 1,))
    if pg_bytes is not None:
        check(pg_bytes, "pg_bytes", torch.uint8, (pg_len,))
    if not 1 <= L <= MAX_L or not 1 <= k <= MAX_K or k1 < 1 or not 0 <= max_mis <= 254:
        raise ValueError(f"kernel L needs L <= {MAX_L}, k <= {MAX_K}, k1 >= 1 and max_mis "
                         f"in 0..254, got L {L}, k {k}, k1 {k1}, max_mis {max_mis}")
    if on_cpu(codes, table, pg_lanes, pg_bytes):
        return rescue_best_plain(codes, table, pg_lanes, pg_len, k, k1, max_mis, pg_bytes)
    out = torch.empty((2 * n,), dtype=torch.int64, device=codes.device)
    launch("pgrc_rescue_best", codes.device, ptr(codes), n, L, k, k1, max_mis, ptr(table),
           ptr(pg_lanes), pg_lanes.numel(), ptr(pg_bytes), pg_len, ptr(out))
    launches["rescue_best"] += 1
    return out
