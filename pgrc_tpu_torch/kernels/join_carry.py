"""Kernel E, `join_carry`: the sort-merge join's carry and route
(csrc/join_carry.cu). Replaces matcher.py `_make_probe`'s seg_start and
pack cummaxes, confirm test and route sort (:239-260).
"""
from __future__ import annotations

import torch

from ..align.host import _POS_BITS as POS_BITS
from ..utils.uint import U32_MASK
from . import check, launch, launches, on_cpu, ptr, scan_scratch

POS_MASK = (1 << POS_BITS) - 1   # the position field of the carry pack
JOIN_MAX = 1 << 28   # entries: the pack stays below 2^63 while seg_start < 2^28


def join_carry_plain(skey: torch.Tensor, perm: torch.Tensor, ipos: torch.Tensor,
                     P: int) -> torch.Tensor:
    """A segmented cummax of seg_start << 35 | (POS_MASK - pos) over the
    index entries hands each probe its run's minimum position; a scatter
    routes the results to probe order (non-probes land in a dump slot)."""
    m2 = skey.numel()
    dev = skey.device
    hs = skey >> 32
    k2s = skey & U32_MASK
    pos = torch.cat([ipos.clamp(min=0).to(torch.int64),
                     torch.zeros((P,), dtype=torch.int64, device=dev)])[perm]
    idx = torch.arange(m2, dtype=torch.int64, device=dev)
    boundary = torch.ones((m2,), dtype=torch.bool, device=dev)
    boundary[1:] = hs[1:] != hs[:-1]
    seg_start = torch.cummax(torch.where(boundary, idx, 0), 0).values
    packv = torch.where(k2s == 0, (seg_start << POS_BITS) | (POS_MASK - pos), 0)
    carried = torch.cummax(packv, 0).values
    confirmed = (carried != 0) & ((carried >> POS_BITS) == seg_start)
    is_probe = (k2s >= 1) & (k2s != U32_MASK)
    res = torch.zeros((P + 1,), dtype=torch.int64, device=dev)
    res[torch.where(is_probe, k2s - 1, P)] = torch.where(
        is_probe & confirmed, POS_MASK - (carried & POS_MASK) + 1, 0)
    return res[:P]


def join_carry(skey: torch.Tensor, perm: torch.Tensor, ipos: torch.Tensor,
               P: int) -> torch.Tensor:
    """skey [m2] int64 sorted composed keys ((hash - 2^31) * 2^32 + key2;
    key2 = 0 index entry, U32INV inert, 1..P probe), perm [m2] int64 (the
    sort's permutation of the M index entries then the P probes), ipos [M]
    int32 or int64 -> res [P] int64: 1 + the lowest position of an index
    entry of the probe's hash, 0 = none. CUDA tensors run kernel E."""
    M = ipos.numel()
    m2 = M + P
    check(skey, "skey", torch.int64, (m2,))
    check(perm, "perm", torch.int64, (m2,))
    if ipos.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ipos: expected int32 or int64, got {ipos.dtype}")
    check(ipos, "ipos", ipos.dtype, (M,))
    if m2 >= JOIN_MAX:
        raise ValueError(f"join of {m2} entries overflows the carry pack")
    if on_cpu(skey, perm, ipos):
        return join_carry_plain(skey, perm, ipos, P)
    dev = skey.device
    # the kernel writes only the probes that hit (the route's scattered
    # writes are most of its time), so every other result is this zero
    res = torch.zeros((P,), dtype=torch.int64, device=dev)
    if m2 == 0:
        return res
    scratch = scan_scratch(m2, dev)
    launch("pgrc_join_carry", dev, m2, ptr(skey), ptr(perm), ptr(ipos),
           ipos.element_size(), ptr(res), ptr(scratch), scratch.numel())
    launches["join_carry.int64" if ipos.dtype == torch.int64 else "join_carry"] += 1
    return res
