"""Kernel D, `sweep_roll_entries`: an overlap round's hash roll and its 2n
sort keys (csrc/sweep_round.cu). Replaces greedy_scs.py `round_fn`'s
roll (:235-240) and entry build (:251-258).
"""
from __future__ import annotations

import torch

from ..core.packed import col_vals
from ..overlap.host import HASH_BASE64, HASH_BASE64_INV, HASH_BASE64B, HASH_BASE64B_INV
from ..utils.uint import SIGN64, s64
from . import check, launch, launches, on_cpu, ptr

_M64 = (1 << 64) - 1


def round_powers(i: int, L: int) -> tuple[int, int, int, int]:
    """u64 (A^(L-i), B^(L-i), A^-1, B^-1) of round i."""
    return (pow(int(HASH_BASE64), L - i, 1 << 64), pow(int(HASH_BASE64B), L - i, 1 << 64),
            int(HASH_BASE64_INV) & _M64, int(HASH_BASE64B_INV) & _M64)


def sweep_roll_entries_plain(lanes, nmask, active_s, active_p, i: int, L: int,
                             h, p, h2, p2):
    """Roll h, p, h2, p2 (int64 bit patterns, IN PLACE) for round i and
    return the entries' order keys k1, prefixes first."""
    pa, pb, ia, ib = (s64(x) for x in round_powers(i, L))
    vi = col_vals(lanes, nmask, i - 1)
    vm = col_vals(lanes, nmask, L - i)
    h.sub_(vi * pa)
    h2.sub_(vi * pb)
    p.sub_(vm).mul_(ia)
    p2.sub_(vm).mul_(ib)
    return torch.cat([torch.where(active_p, p, -1), torch.where(active_s, h, -1)]) ^ SIGN64


def sweep_roll_entries(lanes: torch.Tensor, nmask: torch.Tensor | None,
                       active_s: torch.Tensor, active_p: torch.Tensor, i: int, L: int,
                       h: torch.Tensor, p: torch.Tensor, h2: torch.Tensor,
                       p2: torch.Tensor) -> torch.Tensor:
    """lanes [n, W+1] int32, nmask [n, Wn+1] int32 or None, active_s/active_p
    [n] bool, h/p/h2/p2 [n] int64 (rolled in place) -> k1 [2n] int64, the
    order keys of the round's entries (r < n: row r's prefix, n + r: its
    suffix). CUDA tensors run kernel D."""
    n = lanes.shape[0]
    check(lanes, "lanes", torch.int32, (n, None))
    if nmask is not None:
        check(nmask, "nmask", torch.int32, (n, None))
    for name, t in (("active_s", active_s), ("active_p", active_p)):
        check(t, name, torch.bool, (n,))
    for name, t in (("h", h), ("p", p), ("h2", h2), ("p2", p2)):
        check(t, name, torch.int64, (n,))
    if not 1 <= i < L or L > 16 * lanes.shape[1]:
        raise ValueError(f"round {i} out of range for read length {L}")
    if on_cpu(lanes, nmask, active_s, active_p, h, p, h2, p2):
        return sweep_roll_entries_plain(lanes, nmask, active_s, active_p, i, L, h, p, h2, p2)
    dev = lanes.device
    k1 = torch.empty((2 * n,), dtype=torch.int64, device=dev)
    launch("pgrc_sweep_roll_entries", dev, n, ptr(lanes), lanes.shape[1],
           ptr(nmask), 0 if nmask is None else nmask.shape[1], ptr(active_s),
           ptr(active_p), i, L, *round_powers(i, L), ptr(h), ptr(p), ptr(h2),
           ptr(p2), ptr(k1))
    launches["sweep_roll_entries"] += 1
    return k1
