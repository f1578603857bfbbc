"""Kernel F, `sweep_pair_claim`: an overlap round's ranks, pairing, claim and
link writes (csrc/sweep_pair_claim.cu). Replaces greedy_scs.py
`round_fn`'s rank cummaxes and sort-2 / sort-3 pairing (:267-322) and the
link flush (:381-385).
"""
from __future__ import annotations

import torch

from . import check, launch, launches, on_cpu, ptr, scan_scratch


def sweep_pair_claim_plain(ks, ent, ids, p2, h2, succ_g, ovl_g, a_s, a_p,
                           i: int, L: int) -> None:
    """A suffix of rank r (from its run's first suffix) pairs with the
    prefix of rank r (from the run's start), when the run has one; a pair
    with distinct gids and equal confirm hashes links; every paired prefix
    is claimed, confirmed or not. Entry e < n is row e's prefix, n + r row
    r's suffix."""
    n = ids.numel()
    m = ent.numel()
    idx = torch.arange(m, dtype=torch.int64, device=ks.device)
    boundary = torch.ones((m,), dtype=torch.bool, device=ks.device)
    boundary[1:] = ks[1:] != ks[:-1]
    seg_start = torch.cummax(torch.where(boundary, idx, 0), 0).values
    is_suf = ent >= n
    prev_is_suf = torch.zeros_like(is_suf)
    prev_is_suf[1:] = is_suf[:-1]
    first_suf = is_suf & (~prev_is_suf | boundary)
    fs = torch.cummax(torch.where(first_suf, idx, -1), 0).values
    rank = idx - fs
    paired = is_suf & (rank < fs - seg_start)
    pe = ent[(seg_start + rank)[paired]]     # the partners: prefixes, so rows
    srow = ent[paired] - n
    gid_p = ids[pe]
    ok = (gid_p != ids[srow]) & (p2[pe] == h2[srow])
    dst = ids[srow[ok]].to(torch.int64)
    succ_g[dst] = gid_p[ok]
    ovl_g[dst] = L - i
    a_s[srow[ok]] = False
    a_p[pe] = False


def sweep_pair_claim(ks: torch.Tensor, ent: torch.Tensor, ids: torch.Tensor,
                     p2: torch.Tensor, h2: torch.Tensor, succ_g: torch.Tensor,
                     ovl_g: torch.Tensor, a_s: torch.Tensor, a_p: torch.Tensor,
                     i: int, L: int) -> None:
    """Round i of a table of n rows: ks [m] int64 stable-sorted order keys,
    ent [m] int64 their entry indices (r < n: row r's prefix, n + r: its
    suffix), ids [n] int32, p2 / h2 [n] int64 the rolled confirm hashes ->
    links into succ_g / ovl_g [N] int32 and cleared flags in a_s / a_p [n]
    bool, all IN PLACE. CUDA tensors run kernel F."""
    n = ids.numel()
    m = ks.numel()
    check(ks, "ks", torch.int64, (m,))
    check(ent, "ent", torch.int64, (m,))
    check(ids, "ids", torch.int32, (n,))
    for name, t in (("p2", p2), ("h2", h2)):
        check(t, name, torch.int64, (n,))
    check(succ_g, "succ_g", torch.int32, (None,))
    check(ovl_g, "ovl_g", torch.int32, tuple(succ_g.shape))
    for name, t in (("a_s", a_s), ("a_p", a_p)):
        check(t, name, torch.bool, (n,))
    if m > 2 * n or not 1 <= i < L:
        raise ValueError(f"{m} entries of {n} rows, round {i} of read length {L}")
    if on_cpu(ks, ent, ids, p2, h2, succ_g, ovl_g, a_s, a_p):
        sweep_pair_claim_plain(ks, ent, ids, p2, h2, succ_g, ovl_g, a_s, a_p, i, L)
        return
    if m == 0:
        return
    dev = ks.device
    scratch = scan_scratch(m, dev)
    launch("pgrc_sweep_pair_claim", dev, m, n, ptr(ks), ptr(ent), ptr(ids), ptr(p2),
           ptr(h2), ptr(succ_g), ptr(ovl_g), ptr(a_s), ptr(a_p), L - i,
           ptr(scratch), scratch.numel())
    launches["sweep_pair_claim"] += 1
