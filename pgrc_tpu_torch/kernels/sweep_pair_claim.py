"""Kernel F, `sweep_pair_claim`: an overlap round's ranks, pairing, claim and
link writes (csrc/sweep_pair_claim.cu). Replaces greedy_scs.py
`round_fn`'s rank cummaxes and sort-2 / sort-3 pairing (:267-322) and the
link flush (:381-385).

Its sharded form, `sweep_pair_records` (a mesh round, greedy_scs.py:243-263
with the scatter table and gather of :323-331), pairs the entries of every
rank (kernel D's sharded form) on each rank, reading them from the gathered
send buffers through the sort's permutation; `sharded_keys` lays the
gathered keys out for that sort (csrc/sweep_record.cuh).
"""
from __future__ import annotations

import torch

from . import check, launch, launches, on_cpu, ptr, scan_scratch
from .sweep import CHUNK_WORDS, GID_SHIFT, MASK31, key_words, payload_words

# ranks the kernels' (side, rank) table holds (csrc/sweep_record.cuh)
MAX_RANKS = 256


def pairs_plain(ks, is_suf):
    """The pairs of a round's sorted entries: a suffix of rank r (from its
    run's first suffix) pairs with the prefix of rank r (from the run's
    start), when the run has one. -> (positions of the paired suffixes,
    positions of their partners)."""
    m = ks.numel()
    idx = torch.arange(m, dtype=torch.int64, device=ks.device)
    boundary = torch.ones((m,), dtype=torch.bool, device=ks.device)
    boundary[1:] = ks[1:] != ks[:-1]
    seg_start = torch.cummax(torch.where(boundary, idx, 0), 0).values
    prev_is_suf = torch.zeros_like(is_suf)
    prev_is_suf[1:] = is_suf[:-1]
    first_suf = is_suf & (~prev_is_suf | boundary)
    fs = torch.cummax(torch.where(first_suf, idx, -1), 0).values
    rank = idx - fs
    paired = is_suf & (rank < fs - seg_start)
    return idx[paired], (seg_start + rank)[paired]


def sweep_pair_claim_plain(ks, ent, ids, p2, h2, succ_g, ovl_g, a_s, a_p,
                           i: int, L: int) -> None:
    """Each pair (`pairs_plain`) with distinct gids and equal confirm hashes
    links; every paired prefix is claimed, confirmed or not. Entry e < n is
    row e's prefix, n + r row r's suffix."""
    n = ids.numel()
    sp, pp = pairs_plain(ks, ent >= n)
    pe = ent[pp]     # the partners: prefixes, so rows
    srow = ent[sp] - n
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


def record_table(counts: torch.Tensor) -> torch.Tensor:
    """The (side, rank) table of a round from the ranks' counts [ranks, (m,
    active prefixes)] int64: [2 * ranks + 1] prefix sums over every rank's
    prefixes, rank after rank, then every rank's suffixes; table[ranks] is
    the count of all prefixes, table[-1] of all entries (the kernels build
    it in shared memory, csrc/sweep_record.cuh)."""
    sides = torch.cat([counts[:, 1], counts[:, 0] - counts[:, 1]])
    return torch.cat([sides.new_zeros(1), torch.cumsum(sides, 0)])


def gathered_rows(counts: torch.Tensor, pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions pos in (side, rank) order -> (rank, row in that rank's
    send buffer) of each: the map of csrc/sweep_record.cuh's gathered_row."""
    table = record_table(counts)
    ranks = counts.shape[0]
    seg = torch.searchsorted(table[1:2 * ranks], pos, right=True)
    suf = seg >= ranks
    r = torch.where(suf, seg - ranks, seg)
    d = pos - table[seg] + torch.where(suf, table[r + 1] - table[r], 0)
    return r, d


def _check_gathered(gathered, counts):
    ranks = gathered.shape[0]
    check(gathered, "gathered", torch.int64, (ranks, None, CHUNK_WORDS))
    check(counts, "counts", torch.int64, (ranks, 2))
    if not 1 <= ranks <= MAX_RANKS:
        raise ValueError(f"{ranks} ranks: the kernels take 1 to {MAX_RANKS}")


def sharded_keys_plain(gathered, counts, m: int) -> torch.Tensor:
    """The gathered keys in (side, rank) order: int64 [m]."""
    r, d = gathered_rows(counts, torch.arange(m, dtype=torch.int64, device=gathered.device))
    return gathered.view(gathered.shape[0], -1)[r, key_words(d)]


def sharded_keys(gathered: torch.Tensor, counts: torch.Tensor, m: int) -> torch.Tensor:
    """The key layout of a sharded round: gathered [ranks, chunks,
    CHUNK_WORDS] int64, every rank's send buffer (its first `chunks`
    chunks), counts [ranks, (m, active prefixes)] int64, as the count
    gather leaves them, m their total -> int64 [m]: every rank's prefix
    keys, rank after rank, then every rank's suffix keys, so that the
    entries stand in (side, gid) order before the round's stable sort.
    CUDA tensors run the key layout kernel (csrc/sweep_pair_claim.cu)."""
    _check_gathered(gathered, counts)
    if on_cpu(gathered, counts):
        return sharded_keys_plain(gathered, counts, m)
    keys = torch.empty((m,), dtype=torch.int64, device=gathered.device)
    launch("pgrc_sharded_keys", gathered.device, m, ptr(gathered), gathered[0].numel(),
           ptr(counts), gathered.shape[0], ptr(keys))
    launches["sweep_pair_claim.keys"] += 1
    return keys


def sweep_pair_records_plain(ks, perm, gathered, counts, succ_g, ovl_g, a_s, a_p,
                             gid_lo: int, gid_hi: int, i: int, L: int) -> None:
    """The pairs of the sorted entries (`pairs_plain`: a position below the
    count of all prefixes is a prefix), each entry's record and confirm
    hash read from its payload in the gathered buffer through perm, link
    into the replicated succ_g / ovl_g; the flags of entries whose gid lies
    in [gid_lo, gid_hi), this rank's, are cleared at the row their record
    names."""
    ranks = gathered.shape[0]
    sp, pp = pairs_plain(ks, perm >= counts[:, 1].sum())
    flat = gathered.view(ranks, -1)

    def payload(at):
        r, d = gathered_rows(counts, perm[at])
        w = payload_words(d)
        return flat[r, w], flat[r, w + 1]

    (rs, cs), (rp, cp) = payload(sp), payload(pp)
    gid_s, gid_p = (rs >> GID_SHIFT) & MASK31, (rp >> GID_SHIFT) & MASK31
    ok = (gid_p != gid_s) & (cp == cs)
    succ_g[gid_s[ok]] = gid_p[ok].to(torch.int32)
    ovl_g[gid_s[ok]] = L - i
    a_s[(rs & MASK31)[ok & (gid_s >= gid_lo) & (gid_s < gid_hi)]] = False
    a_p[(rp & MASK31)[(gid_p >= gid_lo) & (gid_p < gid_hi)]] = False


def sweep_pair_records(ks: torch.Tensor, perm: torch.Tensor, gathered: torch.Tensor,
                       counts: torch.Tensor, succ_g: torch.Tensor, ovl_g: torch.Tensor,
                       a_s: torch.Tensor, a_p: torch.Tensor, gid_lo: int, gid_hi: int,
                       i: int, L: int) -> None:
    """Kernel F's sharded form, round i on one rank: ks [m] int64 the
    gathered keys (`sharded_keys`) stably sorted and perm [m] int64 the
    sort's permutation (positions in (side, rank) order); gathered and
    counts as `sharded_keys` takes them, each entry's record and confirm
    hash read from its payload there -> links into succ_g / ovl_g [N]
    int32, the same on every rank, and cleared flags in a_s / a_p [n] bool,
    the rank's table, for the gids of its block [gid_lo, gid_hi); all IN
    PLACE. CUDA tensors run the kernel."""
    m, n = ks.numel(), a_s.numel()
    for name, t in (("ks", ks), ("perm", perm)):
        check(t, name, torch.int64, (m,))
    _check_gathered(gathered, counts)
    check(succ_g, "succ_g", torch.int32, (None,))
    check(ovl_g, "ovl_g", torch.int32, tuple(succ_g.shape))
    for name, t in (("a_s", a_s), ("a_p", a_p)):
        check(t, name, torch.bool, (n,))
    if not 1 <= i < L:
        raise ValueError(f"round {i} of read length {L}")
    if on_cpu(ks, perm, gathered, counts, succ_g, ovl_g, a_s, a_p):
        sweep_pair_records_plain(ks, perm, gathered, counts, succ_g, ovl_g, a_s, a_p, gid_lo,
                                 gid_hi, i, L)
        return
    if m == 0:
        return
    dev = ks.device
    scratch = scan_scratch(m, dev)
    launch("pgrc_sweep_pair_records", dev, m, ptr(ks), ptr(perm), ptr(gathered),
           gathered[0].numel(), ptr(counts), gathered.shape[0], gid_lo, gid_hi, ptr(succ_g),
           ptr(ovl_g), ptr(a_s), ptr(a_p), L - i, ptr(scratch), scratch.numel())
    launches["sweep_pair_claim.sharded"] += 1
