"""Kernel D, `sweep_roll_entries`: an overlap round's hash roll and its
active entries, compacted (csrc/sweep_round.cu). Replaces greedy_scs.py
`round_fn`'s roll (:235-240) and entry build (:251-258), and the selection
of the valid entries that the port's round did with cat and nonzero.

Its sharded form, `sweep_roll_records` (a mesh round, greedy_scs.py:243-263),
writes each active entry whole instead of its index, prefixes first, into
the rank's send buffer: its key and its payload [side | gid | row, confirm
hash], in chunks of CHUNK keys then CHUNK payloads (csrc/sweep_record.cuh),
and counts the prefixes beside all entries.
"""
from __future__ import annotations

import torch

from ..core.packed import col_vals
from ..overlap.host import HASH_BASE64, HASH_BASE64_INV, HASH_BASE64B, HASH_BASE64B_INV
from ..utils.uint import SIGN64, s64
from . import TOTALS_WORD, check, check_cols, launch, launches, on_cpu, ptr, scan_scratch

_M64 = (1 << 64) - 1
# a sharded round's entries (csrc/sweep_record.cuh): a key and a payload
# [record, confirm hash] each; the record is side (bit 62, 1 = suffix),
# global id (bits 31-61) and the row in its owner's table (bits 0-30). A
# rank's send buffer holds them in chunks of CHUNK entries, CHUNK_WORDS
# int64 words each: the chunk's keys, then its payloads
SIDE_BIT = 1 << 62
GID_SHIFT = 31
MASK31 = (1 << 31) - 1
CHUNK = 32
CHUNK_WORDS = 3 * CHUNK


def check_table(lanes: torch.Tensor, nmask: torch.Tensor | None, n: int, i: int,
                L: int) -> None:
    """Raise unless lanes [W+1, n] and nmask [Wn+1, n] (or None) are a sweep
    table's column-major lanes (`kernels.check_cols`: contiguous columns,
    a column stride of at least n, passed to the kernel as it is) wide
    enough for read length L, and 1 <= i < L."""
    check_cols(lanes, "lanes", n)
    if nmask is not None:
        check_cols(nmask, "nmask", n)
    if not 1 <= i < L or L > 16 * lanes.shape[0] or (
            nmask is not None and L > 32 * nmask.shape[0]):
        raise ValueError(f"round {i} out of range for read length {L}")


def round_powers(i: int, L: int) -> tuple[int, int, int, int]:
    """u64 (A^(L-i), B^(L-i), A^-1, B^-1) of round i."""
    return (pow(int(HASH_BASE64), L - i, 1 << 64), pow(int(HASH_BASE64B), L - i, 1 << 64),
            int(HASH_BASE64_INV) & _M64, int(HASH_BASE64B_INV) & _M64)


def round_buffers(n: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(keys, ent, scratch) of a table of n rows, allocated once and reused
    every round: keys and ent [2n] int64 at capacity, scratch the int64
    words of kernel D's scan (zeroed by the kernel) with the round's count
    at TOTALS_WORD."""
    device = torch.device(device)
    scratch = (scan_scratch(2 * n, device) if device.type == "cuda"
               else torch.empty((TOTALS_WORD + 1,), dtype=torch.int64, device=device))
    return (torch.empty((2 * n,), dtype=torch.int64, device=device),
            torch.empty((2 * n,), dtype=torch.int64, device=device), scratch)


def round_entries_plain(active_s, active_p, h, p, keys, ent, scratch) -> torch.Tensor:
    """The active entries of 2n (r < n: row r's prefix, n + r: its suffix),
    in entry order: keys[:m] their hashes ^ SIGN64, ent[:m] their indices,
    m at scratch[TOTALS_WORD]. -> that count, a one-element view."""
    sel = torch.nonzero(torch.cat([active_p, active_s])).squeeze(1)
    m = sel.numel()
    keys[:m] = torch.cat([p, h])[sel] ^ SIGN64
    ent[:m] = sel
    scratch[TOTALS_WORD] = m
    return scratch[TOTALS_WORD:TOTALS_WORD + 1]


def roll_plain(lanes, nmask, i: int, L: int, h, p, h2, p2) -> None:
    """Roll h, p, h2, p2 (int64 bit patterns, IN PLACE) for round i; lanes
    and nmask column-major (`check_table`)."""
    pa, pb, ia, ib = (s64(x) for x in round_powers(i, L))
    vi = col_vals(lanes, nmask, i - 1)
    vm = col_vals(lanes, nmask, L - i)
    h.sub_(vi * pa)
    h2.sub_(vi * pb)
    p.sub_(vm).mul_(ia)
    p2.sub_(vm).mul_(ib)


def sweep_roll_entries_plain(lanes, nmask, active_s, active_p, i: int, L: int,
                             h, p, h2, p2, keys, ent, scratch) -> torch.Tensor:
    """Roll h, p, h2, p2 (IN PLACE) for round i, then write the round's
    active entries (`round_entries_plain`)."""
    roll_plain(lanes, nmask, i, L, h, p, h2, p2)
    return round_entries_plain(active_s, active_p, h, p, keys, ent, scratch)


def sweep_roll_entries(lanes: torch.Tensor, nmask: torch.Tensor | None,
                       active_s: torch.Tensor, active_p: torch.Tensor, i: int, L: int,
                       h: torch.Tensor, p: torch.Tensor, h2: torch.Tensor, p2: torch.Tensor,
                       keys: torch.Tensor, ent: torch.Tensor,
                       scratch: torch.Tensor) -> torch.Tensor:
    """lanes [W+1, n] int32 and nmask [Wn+1, n] int32 or None, the sweep
    table's column-major lanes (`check_table`), active_s/active_p
    [n] bool, h/p/h2/p2 [n] int64 (rolled in place), keys/ent [2n] int64
    and scratch from `round_buffers` -> the round's active entries in
    keys[:m] (order keys) and ent[:m] (entry indices: r < n row r's prefix,
    n + r its suffix), in entry order, and m as a one-element int64 tensor
    on the tensors' device. CUDA tensors run kernel D."""
    n = lanes.shape[1]
    check_table(lanes, nmask, n, i, L)
    for name, t in (("active_s", active_s), ("active_p", active_p)):
        check(t, name, torch.bool, (n,))
    for name, t in (("h", h), ("p", p), ("h2", h2), ("p2", p2)):
        check(t, name, torch.int64, (n,))
    for name, t in (("keys", keys), ("ent", ent)):
        check(t, name, torch.int64, (2 * n,))
    check(scratch, "scratch", torch.int64, (None,))
    if on_cpu(lanes, nmask, active_s, active_p, h, p, h2, p2, keys, ent, scratch):
        return sweep_roll_entries_plain(lanes, nmask, active_s, active_p, i, L, h, p, h2, p2,
                                        keys, ent, scratch)
    dev = lanes.device
    launch("pgrc_sweep_roll_entries", dev, n, ptr(lanes), lanes.stride(0),
           ptr(nmask), 0 if nmask is None else nmask.stride(0), ptr(active_s),
           ptr(active_p), i, L, *round_powers(i, L), ptr(h), ptr(p), ptr(h2),
           ptr(p2), ptr(keys), ptr(ent), ptr(scratch), scratch.numel())
    launches["sweep_roll_entries"] += 1
    return scratch[TOTALS_WORD:TOTALS_WORD + 1]


def record_chunks(m: int) -> int:
    """Chunks of a send buffer that hold m entries."""
    return -(-m // CHUNK)


def key_words(d: torch.Tensor) -> torch.Tensor:
    """Word of entry d's key in its rank's send buffer."""
    return d // CHUNK * CHUNK_WORDS + d % CHUNK


def payload_words(d: torch.Tensor) -> torch.Tensor:
    """Word of entry d's payload (its record; the confirm hash follows)."""
    return d // CHUNK * CHUNK_WORDS + CHUNK + 2 * (d % CHUNK)


def record_buffers(rows_max: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(recs, scratch) of a sharded table, allocated once and reused every
    round: recs the send buffer [record_chunks(2 * rows_max), CHUNK_WORDS]
    int64, sized from the largest table of any rank (rows_max rows), so
    that a rank's buffer holds at least the largest count of entries any
    rank sends in a round and the gather sends its head as it is; scratch
    the words of kernel D's scan over up to 2 * rows_max entries, with the
    round's count at TOTALS_WORD and its active prefixes in the next word."""
    device = torch.device(device)
    scratch = (scan_scratch(2 * rows_max, device) if device.type == "cuda"
               else torch.empty((TOTALS_WORD + 2,), dtype=torch.int64, device=device))
    return (torch.empty((record_chunks(2 * rows_max), CHUNK_WORDS), dtype=torch.int64,
                        device=device), scratch)


def sweep_roll_records_plain(lanes, nmask, active_s, active_p, i: int, L: int,
                             h, p, h2, p2, ids, recs, scratch) -> torch.Tensor:
    """Roll h, p, h2, p2 (IN PLACE) for round i, then write the active
    entries, prefixes then suffixes, each side in row order, entry d at
    key_words(d) (hash ^ SIGN64) and payload_words(d) (side | gid | row,
    then the rolled p2 or h2) of recs."""
    roll_plain(lanes, nmask, i, L, h, p, h2, p2)
    flat = recs.view(-1)
    gid = ids.to(torch.int64) << GID_SHIFT
    pre = torch.nonzero(active_p).squeeze(1)
    suf = torch.nonzero(active_s).squeeze(1)
    mp, m = pre.numel(), pre.numel() + suf.numel()
    for rows, first, key, conf, side in ((pre, 0, p, p2, 0), (suf, mp, h, h2, SIDE_BIT)):
        d = torch.arange(first, first + rows.numel(), dtype=torch.int64, device=recs.device)
        flat[key_words(d)] = key[rows] ^ SIGN64
        flat[payload_words(d)] = gid[rows] | rows | side
        flat[payload_words(d) + 1] = conf[rows]
    scratch[TOTALS_WORD] = m
    scratch[TOTALS_WORD + 1] = mp
    return scratch[TOTALS_WORD:TOTALS_WORD + 2]


def sweep_roll_records(lanes: torch.Tensor, nmask: torch.Tensor | None,
                       active_s: torch.Tensor, active_p: torch.Tensor, i: int, L: int,
                       h: torch.Tensor, p: torch.Tensor, h2: torch.Tensor, p2: torch.Tensor,
                       ids: torch.Tensor, recs: torch.Tensor,
                       scratch: torch.Tensor) -> torch.Tensor:
    """Kernel D's sharded form: as `sweep_roll_entries`, with ids [n] int32
    the rows' global ids, and recs [chunks, CHUNK_WORDS] int64 (at least 2n
    entries) and scratch from `record_buffers` -> the m active entries in
    the chunks of recs (the mp active prefixes first; csrc/sweep_record.cuh),
    and (m, mp) as a two-element int64 view on the tensors' device. CUDA
    tensors run kernel D's sharded form."""
    n = lanes.shape[1]
    check_table(lanes, nmask, n, i, L)
    for name, t in (("active_s", active_s), ("active_p", active_p)):
        check(t, name, torch.bool, (n,))
    for name, t in (("h", h), ("p", p), ("h2", h2), ("p2", p2)):
        check(t, name, torch.int64, (n,))
    check(ids, "ids", torch.int32, (n,))
    check(recs, "recs", torch.int64, (None, CHUNK_WORDS))
    check(scratch, "scratch", torch.int64, (None,))
    if recs.shape[0] * CHUNK < 2 * n:
        raise ValueError(f"recs: {recs.shape[0]} chunks cannot hold {2 * n} entries")
    if on_cpu(lanes, nmask, active_s, active_p, h, p, h2, p2, ids, recs, scratch):
        return sweep_roll_records_plain(lanes, nmask, active_s, active_p, i, L, h, p, h2, p2,
                                        ids, recs, scratch)
    launch("pgrc_sweep_roll_records", lanes.device, n, ptr(lanes), lanes.stride(0),
           ptr(nmask), 0 if nmask is None else nmask.stride(0), ptr(active_s),
           ptr(active_p), i, L, *round_powers(i, L), ptr(h), ptr(p), ptr(h2),
           ptr(p2), ptr(ids), ptr(recs), recs.shape[0], ptr(scratch), scratch.numel())
    launches["sweep_roll_entries.sharded"] += 1
    return scratch[TOTALS_WORD:TOTALS_WORD + 2]
