"""Kernel F, `sweep_pair_claim`: an overlap round's ranks, pairing, claim and
link writes (csrc/sweep_pair_claim.cu). Replaces greedy_scs.py
`round_fn`'s rank cummaxes and sort-2 / sort-3 pairing (:267-322) and the
link flush (:381-385).
"""
from __future__ import annotations

import torch

from . import check, launch, launches, on_cpu, ptr, scan_scratch
from .sweep import SUFFIX_BIT


def sweep_pair_claim_plain(ks, ent, k2, v2, orig, ids, succ_g, ovl_g, a_s, a_p,
                           i: int, L: int) -> None:
    """A suffix of rank r (from its run's first suffix) pairs with the
    prefix of rank r (from the run's start), when the run has one; a pair
    with distinct gids and equal confirm hashes links; every paired prefix
    is claimed, confirmed or not."""
    n = ids.numel()
    k2s, v2s, origs = k2[ent], v2[ent], orig[ent].to(torch.int64)
    m = ent.numel()
    idx = torch.arange(m, dtype=torch.int64, device=ks.device)
    boundary = torch.ones((m,), dtype=torch.bool, device=ks.device)
    boundary[1:] = ks[1:] != ks[:-1]
    seg_start = torch.cummax(torch.where(boundary, idx, 0), 0).values
    is_suf = k2s >= SUFFIX_BIT
    prev_is_suf = torch.zeros_like(is_suf)
    prev_is_suf[1:] = is_suf[:-1]
    first_suf = is_suf & (~prev_is_suf | boundary)
    fs = torch.cummax(torch.where(first_suf, idx, -1), 0).values
    rank = idx - fs
    paired = is_suf & (rank < fs - seg_start)
    partner = torch.where(paired, seg_start + rank, idx)
    gid = k2s & 0x7FFFFFFF
    ok = paired & (gid[partner] != gid) & (v2s[partner] == v2s)
    srow = origs[ok] - n
    dst = ids[srow].to(torch.int64)
    succ_g[dst] = gid[partner[ok]].to(torch.int32)
    ovl_g[dst] = L - i
    a_s[srow] = False
    a_p[origs[partner[paired]]] = False


def sweep_pair_claim(ks: torch.Tensor, ent: torch.Tensor, k2: torch.Tensor,
                     v2: torch.Tensor, orig: torch.Tensor, ids: torch.Tensor,
                     succ_g: torch.Tensor, ovl_g: torch.Tensor, a_s: torch.Tensor,
                     a_p: torch.Tensor, i: int, L: int) -> None:
    """Round i of a table of n rows: ks [m] int64 stable-sorted order keys,
    ent [m] int64 their entry indices, k2 / v2 [2n] int64 and orig [2n]
    int32 (kernel D's entries), ids [n] int32 -> links into succ_g / ovl_g
    [N] int32 and cleared flags in a_s / a_p [n] bool, all IN PLACE. CUDA
    tensors run kernel F."""
    n = ids.numel()
    m = ks.numel()
    check(ks, "ks", torch.int64, (m,))
    check(ent, "ent", torch.int64, (m,))
    for name, t in (("k2", k2), ("v2", v2)):
        check(t, name, torch.int64, (2 * n,))
    check(orig, "orig", torch.int32, (2 * n,))
    check(ids, "ids", torch.int32, (n,))
    check(succ_g, "succ_g", torch.int32, (None,))
    check(ovl_g, "ovl_g", torch.int32, tuple(succ_g.shape))
    for name, t in (("a_s", a_s), ("a_p", a_p)):
        check(t, name, torch.bool, (n,))
    if m > 2 * n or not 1 <= i < L:
        raise ValueError(f"{m} entries of {n} rows, round {i} of read length {L}")
    if on_cpu(ks, ent, k2, v2, orig, ids, succ_g, ovl_g, a_s, a_p):
        sweep_pair_claim_plain(ks, ent, k2, v2, orig, ids, succ_g, ovl_g, a_s, a_p, i, L)
        return
    if m == 0:
        return
    dev = ks.device
    scratch = scan_scratch(m, dev)
    launch("pgrc_sweep_pair_claim", dev, m, n, ptr(ks), ptr(ent), ptr(k2), ptr(v2),
           ptr(orig), ptr(ids), ptr(succ_g), ptr(ovl_g), ptr(a_s), ptr(a_p), L - i,
           ptr(scratch), scratch.numel())
    launches["sweep_pair_claim"] += 1
