"""Kernel D, `sweep_roll_entries`: an overlap round's hash roll and its
active entries, compacted (csrc/sweep_round.cu). Replaces greedy_scs.py
`round_fn`'s roll (:235-240) and entry build (:251-258), and the selection
of the valid entries that the port's round did with cat and nonzero.

Its sharded form, `sweep_roll_records` (a mesh round, greedy_scs.py:243-263),
writes each active entry's whole record instead of its index: [key, side |
gid | row, confirm hash] (csrc/sweep_record.cuh), prefixes first, and counts
the prefixes beside all entries.
"""
from __future__ import annotations

import torch

from ..core.packed import col_vals
from ..overlap.host import HASH_BASE64, HASH_BASE64_INV, HASH_BASE64B, HASH_BASE64B_INV
from ..utils.uint import SIGN64, s64
from . import TOTALS_WORD, check, launch, launches, on_cpu, ptr, scan_scratch

_M64 = (1 << 64) - 1
# a sharded round's entry record (csrc/sweep_record.cuh): int64 words [key,
# record, confirm hash]; the record is side (bit 62, 1 = suffix), global id
# (bits 31-61) and the row in its owner's table (bits 0-30)
REC_WORDS = 3
SIDE_BIT = 1 << 62
GID_SHIFT = 31
MASK31 = (1 << 31) - 1


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
    """Roll h, p, h2, p2 (int64 bit patterns, IN PLACE) for round i."""
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
    """lanes [n, W+1] int32, nmask [n, Wn+1] int32 or None, active_s/active_p
    [n] bool, h/p/h2/p2 [n] int64 (rolled in place), keys/ent [2n] int64
    and scratch from `round_buffers` -> the round's active entries in
    keys[:m] (order keys) and ent[:m] (entry indices: r < n row r's prefix,
    n + r its suffix), in entry order, and m as a one-element int64 tensor
    on the tensors' device. CUDA tensors run kernel D."""
    n = lanes.shape[0]
    check(lanes, "lanes", torch.int32, (n, None))
    if nmask is not None:
        check(nmask, "nmask", torch.int32, (n, None))
    for name, t in (("active_s", active_s), ("active_p", active_p)):
        check(t, name, torch.bool, (n,))
    for name, t in (("h", h), ("p", p), ("h2", h2), ("p2", p2)):
        check(t, name, torch.int64, (n,))
    for name, t in (("keys", keys), ("ent", ent)):
        check(t, name, torch.int64, (2 * n,))
    check(scratch, "scratch", torch.int64, (None,))
    if not 1 <= i < L or L > 16 * lanes.shape[1]:
        raise ValueError(f"round {i} out of range for read length {L}")
    if on_cpu(lanes, nmask, active_s, active_p, h, p, h2, p2, keys, ent, scratch):
        return sweep_roll_entries_plain(lanes, nmask, active_s, active_p, i, L, h, p, h2, p2,
                                        keys, ent, scratch)
    dev = lanes.device
    launch("pgrc_sweep_roll_entries", dev, n, ptr(lanes), lanes.shape[1],
           ptr(nmask), 0 if nmask is None else nmask.shape[1], ptr(active_s),
           ptr(active_p), i, L, *round_powers(i, L), ptr(h), ptr(p), ptr(h2),
           ptr(p2), ptr(keys), ptr(ent), ptr(scratch), scratch.numel())
    launches["sweep_roll_entries"] += 1
    return scratch[TOTALS_WORD:TOTALS_WORD + 1]


def record_buffers(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(recs, scratch) of a sharded table of n rows, allocated once and
    reused every round: recs [2n, REC_WORDS] int64 at capacity, scratch the
    words of kernel D's scan with the round's count at TOTALS_WORD and its
    active prefixes in the next word."""
    device = torch.device(device)
    scratch = (scan_scratch(2 * n, device) if device.type == "cuda"
               else torch.empty((TOTALS_WORD + 2,), dtype=torch.int64, device=device))
    return torch.empty((2 * n, REC_WORDS), dtype=torch.int64, device=device), scratch


def sweep_roll_records_plain(lanes, nmask, active_s, active_p, i: int, L: int,
                             h, p, h2, p2, ids, recs, scratch) -> torch.Tensor:
    """Roll h, p, h2, p2 (IN PLACE) for round i, then write the active
    entries' records, prefixes then suffixes, each side in row order:
    recs[d] = [hash ^ SIGN64, side | gid | row, the rolled p2 or h2]."""
    roll_plain(lanes, nmask, i, L, h, p, h2, p2)
    pre = torch.nonzero(active_p).squeeze(1)
    suf = torch.nonzero(active_s).squeeze(1)
    mp, m = pre.numel(), pre.numel() + suf.numel()
    gid = ids.to(torch.int64) << GID_SHIFT
    recs[:mp, 0] = p[pre] ^ SIGN64
    recs[:mp, 1] = gid[pre] | pre
    recs[:mp, 2] = p2[pre]
    recs[mp:m, 0] = h[suf] ^ SIGN64
    recs[mp:m, 1] = gid[suf] | suf | SIDE_BIT
    recs[mp:m, 2] = h2[suf]
    scratch[TOTALS_WORD] = m
    scratch[TOTALS_WORD + 1] = mp
    return scratch[TOTALS_WORD:TOTALS_WORD + 2]


def sweep_roll_records(lanes: torch.Tensor, nmask: torch.Tensor | None,
                       active_s: torch.Tensor, active_p: torch.Tensor, i: int, L: int,
                       h: torch.Tensor, p: torch.Tensor, h2: torch.Tensor, p2: torch.Tensor,
                       ids: torch.Tensor, recs: torch.Tensor,
                       scratch: torch.Tensor) -> torch.Tensor:
    """Kernel D's sharded form: as `sweep_roll_entries`, with ids [n] int32
    the rows' global ids, and recs [2n, REC_WORDS] int64 and scratch from
    `record_buffers` -> the active entries' records in recs[:m], the mp
    active prefixes first, and (m, mp) as a two-element int64 view on the
    tensors' device. CUDA tensors run kernel D's sharded form."""
    n = lanes.shape[0]
    check(lanes, "lanes", torch.int32, (n, None))
    if nmask is not None:
        check(nmask, "nmask", torch.int32, (n, None))
    for name, t in (("active_s", active_s), ("active_p", active_p)):
        check(t, name, torch.bool, (n,))
    for name, t in (("h", h), ("p", p), ("h2", h2), ("p2", p2)):
        check(t, name, torch.int64, (n,))
    check(ids, "ids", torch.int32, (n,))
    check(recs, "recs", torch.int64, (2 * n, REC_WORDS))
    check(scratch, "scratch", torch.int64, (None,))
    if not 1 <= i < L or L > 16 * lanes.shape[1]:
        raise ValueError(f"round {i} out of range for read length {L}")
    if on_cpu(lanes, nmask, active_s, active_p, h, p, h2, p2, ids, recs, scratch):
        return sweep_roll_records_plain(lanes, nmask, active_s, active_p, i, L, h, p, h2, p2,
                                        ids, recs, scratch)
    launch("pgrc_sweep_roll_records", lanes.device, n, ptr(lanes), lanes.shape[1],
           ptr(nmask), 0 if nmask is None else nmask.shape[1], ptr(active_s),
           ptr(active_p), i, L, *round_powers(i, L), ptr(h), ptr(p), ptr(h2),
           ptr(p2), ptr(ids), ptr(recs), ptr(scratch), scratch.numel())
    launches["sweep_roll_entries.sharded"] += 1
    return scratch[TOTALS_WORD:TOTALS_WORD + 2]
