"""Kernel D, `sweep_roll_entries`: an overlap round's hash roll and its 2n
sort entries (csrc/sweep_round.cu). Replaces greedy_scs.py `round_fn`'s
roll (:235-240) and entry build (:251-258).
"""
from __future__ import annotations

import torch

from ..core.packed import col_vals
from ..overlap.host import HASH_BASE64, HASH_BASE64_INV, HASH_BASE64B, HASH_BASE64B_INV
from ..utils.uint import SIGN64, U32_MASK, s64
from . import check, launch, launches, on_cpu, ptr

INV32 = U32_MASK
SUFFIX_BIT = 0x80000000
_M64 = (1 << 64) - 1


def round_powers(i: int, L: int) -> tuple[int, int, int, int]:
    """u64 (A^(L-i), B^(L-i), A^-1, B^-1) of round i."""
    return (pow(int(HASH_BASE64), L - i, 1 << 64), pow(int(HASH_BASE64B), L - i, 1 << 64),
            int(HASH_BASE64_INV) & _M64, int(HASH_BASE64B_INV) & _M64)


def sweep_roll_entries_plain(lanes, nmask, gid, active_s, active_p, i: int,
                             L: int, h, p, h2, p2):
    """Roll h, p, h2, p2 (int64 bit patterns, IN PLACE) for round i and
    return the entries (k1 order key, k2, orig, v2), prefixes first."""
    pa, pb, ia, ib = (s64(x) for x in round_powers(i, L))
    vi = col_vals(lanes, nmask, i - 1)
    vm = col_vals(lanes, nmask, L - i)
    h.sub_(vi * pa)
    h2.sub_(vi * pb)
    p.sub_(vm).mul_(ia)
    p2.sub_(vm).mul_(ib)
    n = gid.numel()
    g = gid.to(torch.int64)
    k1 = torch.cat([torch.where(active_p, p, -1), torch.where(active_s, h, -1)]) ^ SIGN64
    k2 = torch.cat([torch.where(active_p, g, INV32),
                    torch.where(active_s, g | SUFFIX_BIT, INV32)])
    orig = torch.arange(2 * n, dtype=torch.int32, device=gid.device)
    return k1, k2, orig, torch.cat([p2, h2])


def sweep_roll_entries(lanes: torch.Tensor, nmask: torch.Tensor | None,
                       gid: torch.Tensor, active_s: torch.Tensor,
                       active_p: torch.Tensor, i: int, L: int, h: torch.Tensor,
                       p: torch.Tensor, h2: torch.Tensor, p2: torch.Tensor):
    """lanes [n, W+1] int32, nmask [n, Wn+1] int32 or None, gid [n] int32,
    active_s/active_p [n] bool, h/p/h2/p2 [n] int64 (rolled in place) ->
    (k1 [2n] int64 order keys, k2 [2n] int64, orig [2n] int32, v2 [2n] int64).
    CUDA tensors run kernel D."""
    n = gid.numel()
    check(lanes, "lanes", torch.int32, (n, None))
    if nmask is not None:
        check(nmask, "nmask", torch.int32, (n, None))
    check(gid, "gid", torch.int32, (n,))
    for name, t in (("active_s", active_s), ("active_p", active_p)):
        check(t, name, torch.bool, (n,))
    for name, t in (("h", h), ("p", p), ("h2", h2), ("p2", p2)):
        check(t, name, torch.int64, (n,))
    if not 1 <= i < L or L > 16 * lanes.shape[1]:
        raise ValueError(f"round {i} out of range for read length {L}")
    if on_cpu(lanes, nmask, gid, active_s, active_p, h, p, h2, p2):
        return sweep_roll_entries_plain(lanes, nmask, gid, active_s, active_p,
                                        i, L, h, p, h2, p2)
    dev = lanes.device
    k1 = torch.empty((2 * n,), dtype=torch.int64, device=dev)
    k2 = torch.empty((2 * n,), dtype=torch.int64, device=dev)
    orig = torch.empty((2 * n,), dtype=torch.int32, device=dev)
    v2 = torch.empty((2 * n,), dtype=torch.int64, device=dev)
    launch("pgrc_sweep_roll_entries", dev, n, ptr(lanes), lanes.shape[1],
           ptr(nmask), 0 if nmask is None else nmask.shape[1], ptr(gid),
           ptr(active_s), ptr(active_p), i, L, *round_powers(i, L), ptr(h),
           ptr(p), ptr(h2), ptr(p2), ptr(k1), ptr(k2), ptr(orig), ptr(v2))
    launches["sweep_roll_entries"] += 1
    return k1, k2, orig, v2
