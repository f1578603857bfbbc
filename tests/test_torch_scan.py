"""The plain versions of kernels E (`join_carry`) and F (`sweep_pair_claim`)
against independent numpy statements of what the reference computes.

E: each probe gets 1 + the lowest position among the index entries of
exactly its hash (inert entries excluded), or 0. F: the reference's own
formulation of a round (greedy_scs.py:251-322 and its flush :381-385): a
sort by (hash, side|gid), ranks from two cummaxes, a second sort on
(hash, rank * 2 + side) that puts each suffix right after its rank
partner, links where the partner's gid differs and the confirm hashes
agree, and a claim of every prefix whose rank has a suffix. Every value is
an integer: equality is exact.
"""
import numpy as np
import pytest
import torch

from pgrc_tpu_torch.align import matcher
from pgrc_tpu_torch.kernels import join_carry as kjoin
from pgrc_tpu_torch.kernels import kmer_hash
from pgrc_tpu_torch.kernels import sweep as ksweep
from pgrc_tpu_torch.kernels import sweep_pair_claim as kpair
from pgrc_tpu_torch.overlap import greedy_scs

INV32 = 0xFFFFFFFF


# ---- E ----------------------------------------------------------------


def lowest_position(ihash, ipos, hashes):
    """1 + min position of a live index entry of each probe's hash, else 0."""
    live = ipos >= 0
    h, p = ihash[live].astype(np.uint32), ipos[live].astype(np.int64)
    best = {}
    for hv, pv in zip(h.tolist(), p.tolist()):
        best[hv] = min(best.get(hv, pv), pv)
    flat = hashes.astype(np.uint32).ravel().tolist()
    return np.array([best[v] + 1 if v in best else 0 for v in flat],
                    dtype=np.int64).reshape(hashes.shape)


def join_case(kind, rng):
    """(ihash u32 [M], ipos [M] with -1 = inert, probe hashes u32 [R, S])."""
    if kind == "collisions":        # many positions per hash, some probes miss
        M, R, S, nh = 3000, 300, 7, 150
        ihash = rng.integers(0, nh, M)
        ipos = rng.permutation(10 * M)[:M]
        hashes = rng.integers(0, nh + 40, (R, S))
    elif kind == "inert":           # inert entries share the probes' hashes
        M, R, S, nh = 2500, 200, 5, 60
        ihash = rng.integers(0, nh, M)
        ipos = np.where(rng.random(M) < 0.4, -1, rng.integers(0, 50_000, M))
        ihash[ihash == 7] = 8
        ihash[:30] = 7              # hash 7: inert only
        ipos[:30] = -1
        hashes = rng.integers(0, nh, (R, S))
        hashes[:, 0] = 7
    elif kind == "empty index":
        M, R, S = 0, 100, 9
        ihash, ipos = np.zeros(0, np.int64), np.zeros(0, np.int64)
        hashes = rng.integers(0, 1 << 32, (R, S))
    elif kind == "one hash":        # one run over every entry, past a tile
        M, R, S = 1500, 400, 9
        ihash = np.full(M, 0xDEADBEEF)
        ipos = rng.permutation(4 * M)[:M]
        hashes = np.full((R, S), 0xDEADBEEF)
    elif kind == "runs of one":     # every hash once: runs of length 1
        M, R, S = 2100, 1, 2049
        ihash = rng.permutation(1 << 20)[:M]
        ipos = rng.integers(0, 1 << 20, M)
        hashes = rng.permutation(1 << 20)[:R * S].reshape(R, S)
    elif kind == "tile edges":      # runs of 2048 and 256 entries, sorted
        M, R, S = 4096, 512, 8      # end at tile and warp-run edges
        ihash = np.repeat(np.arange(8) * 1000, 512)
        ipos = rng.permutation(1 << 16)[:M]
        hashes = np.repeat(np.arange(8) * 1000, 512).reshape(R, S)
    elif kind == "high hashes":     # hashes at both ends of the u32 range
        M, R, S = 1000, 100, 10
        vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF])
        ihash = rng.choice(vals, M)
        ipos = rng.integers(0, 1 << 30, M)
        hashes = rng.choice(vals, (R, S))
    else:
        raise ValueError(kind)
    return ihash.astype(np.uint32), np.asarray(ipos, np.int64), hashes.astype(np.uint32)


JOIN_KINDS = ["collisions", "inert", "empty index", "one hash", "runs of one",
              "tile edges", "high hashes"]


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("kind", JOIN_KINDS)
def test_join_carry_plain_is_lowest_position(kind, wide):
    rng = np.random.default_rng(JOIN_KINDS.index(kind))
    ihash, ipos, hashes = join_case(kind, rng)
    if wide:   # positions past 2^31, as the wide probe of a 2.3G pg has them
        ipos = np.where(ipos >= 0, ipos + (3 << 30), -1)
    want = lowest_position(ihash, ipos, hashes)
    ih_t = torch.from_numpy(ihash.view(np.int32).copy())
    ip_t = torch.from_numpy(ipos.astype(np.int64 if wide else np.int32))
    h_t = torch.from_numpy(hashes.view(np.int32).copy())
    keys = torch.cat([kmer_hash.index_keys(ih_t, ip_t), kmer_hash.probe_keys(h_t)])
    got = matcher.join_anchors(keys, ip_t, hashes.size)
    assert got.dtype == torch.int64 and tuple(got.shape) == (hashes.size,)
    np.testing.assert_array_equal(got.numpy(), want.ravel())
    if kind in ("collisions", "inert", "one hash"):
        assert 0 < (want > 0).sum() < want.size or kind == "one hash"


def test_join_carry_checks_its_inputs():
    skey, perm = torch.zeros(5, dtype=torch.int64), torch.arange(5)
    with pytest.raises(TypeError):
        kjoin.join_carry(skey, perm, torch.zeros(2, dtype=torch.int16), 3)
    with pytest.raises(ValueError):
        kjoin.join_carry(skey, perm, torch.zeros(3, dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        kjoin.join_carry(torch.zeros(10, dtype=torch.int64)[::2], perm,
                         torch.zeros(2, dtype=torch.int32), 3)


# ---- F ----------------------------------------------------------------


def reference_round(ids, a_s, a_p, p, h, p2, h2, i, L, succ, ovl):
    """greedy_scs.py:251-322 and the flush, in numpy, on one table; updates
    succ / ovl (global) and a_s / a_p (rows) in place. Hashes are u64."""
    n = ids.size
    inv64 = np.uint64(0xFFFFFFFFFFFFFFFF)
    k1 = np.concatenate([np.where(a_p, p, inv64), np.where(a_s, h, inv64)]).astype(np.uint64)
    gid = ids.astype(np.int64)
    k2 = np.concatenate([np.where(a_p, gid, INV32),
                         np.where(a_s, gid | 0x80000000, INV32)]).astype(np.int64)
    orig = np.arange(2 * n)
    v2 = np.concatenate([p2, h2]).astype(np.uint64)
    o = np.lexsort((k2, k1))                        # sort 1: (k1, k2)
    k1s, k2s, origs, v2s = k1[o], k2[o], orig[o], v2[o]
    m = 2 * n
    idx = np.arange(m)
    valid = k2s != INV32
    side_suf = (k2s & 0x80000000) != 0
    same_prev = np.concatenate([[False], k1s[1:] == k1s[:-1]])
    boundary = valid & ~same_prev
    is_suf = valid & side_suf
    seg_start = np.maximum.accumulate(np.where(boundary, idx, 0))
    prev_is_suf = np.concatenate([[False], is_suf[:-1]])
    first_suf = is_suf & (~prev_is_suf | boundary)
    fs = np.maximum.accumulate(np.where(first_suf, idx, -1))
    rank = np.where(is_suf, idx - np.maximum(fs, 0), idx - seg_start)
    skey = np.where(valid, (rank << 1) | (side_suf & (fs >= 0)), INV32)
    skey = np.where(is_suf & (fs < 0), INV32 - 1, skey)
    o2 = np.lexsort((skey, k1s))                    # sort 2: (k1, rank*2+side)
    k1t, skt, k2t, origt, v2t = k1s[o2], skey[o2], k2s[o2], origs[o2], v2s[o2]
    valid_t = k2t != INV32
    gid_t = k2t & 0x7FFFFFFF
    suf_t = valid_t & ((skt & 1) == 1)
    pref_t = valid_t & ((skt & 1) == 0)
    same_key = np.concatenate([[False], k1t[1:] == k1t[:-1]])
    step = np.concatenate([[False], skt[1:] == skt[:-1] + 1])
    prev_ok = np.concatenate([[False], valid_t[:-1]])
    partner = same_key & step & prev_ok             # previous entry is my partner
    gid_prev = np.concatenate([[-1], gid_t[:-1]])
    v2_prev = np.concatenate([[np.uint64(0)], v2t[:-1]])
    suf_ok = suf_t & partner & (gid_prev != gid_t) & (v2_prev == v2t)
    claimed = pref_t & np.concatenate([partner[1:], [False]])
    for j in np.nonzero(suf_ok)[0]:
        row = origt[j] - n
        succ[ids[row]] = gid_t[j - 1]
        ovl[ids[row]] = L - i
        a_s[row] = False
    a_p[origt[claimed]] = False
    return dict(self_pairs=int((suf_t & partner & (gid_prev == gid_t)).sum()),
                unconfirmed=int((suf_t & partner & (gid_prev != gid_t)
                                 & (v2_prev != v2t)).sum()),
                links=int(suf_ok.sum()))


def group_stats(a_s, a_p, p, h):
    """Counts of equal-hash groups by their make-up."""
    pref = dict(zip(*np.unique(p[a_p], return_counts=True)))
    suf = dict(zip(*np.unique(h[a_s], return_counts=True)))
    keys = set(pref) | set(suf)
    return dict(only_prefixes=sum(1 for k in keys if k not in suf),
                only_suffixes=sum(1 for k in keys if k not in pref),
                more_suffixes=sum(1 for k in keys if suf.get(k, 0) > pref.get(k, 0) > 0))


def pair_case(kind, rng):
    """(n_global, ids, a_s, a_p, p, h, p2, h2) of one table."""
    if kind == "mixed":
        n, nh, act = 3000, 400, 0.7
    elif kind == "dense groups":    # few hashes: long runs across tiles
        n, nh, act = 5000, 3, 0.9
    elif kind == "runs of one":
        n, nh, act = 2500, 1 << 40, 0.9
    elif kind == "one hash":
        n, nh, act = 3000, 1, 0.8
    else:
        raise ValueError(kind)
    N = 2 * n
    ids = np.sort(rng.choice(N, n, replace=False)).astype(np.int32)
    a_s = rng.random(n) < act
    a_p = rng.random(n) < act
    base = np.uint64(0x9E3779B97F4A7C15)
    p = rng.integers(0, nh, n).astype(np.uint64) * base
    h = rng.integers(0, nh, n).astype(np.uint64) * base
    same = rng.random(n) < 0.1          # a row whose prefix and suffix agree
    h[same] = p[same]
    p2 = rng.integers(0, 2, n).astype(np.uint64)   # confirm hashes: half agree
    h2 = rng.integers(0, 2, n).astype(np.uint64)
    return N, ids, a_s, a_p, p, h, p2, h2


def port_round(ids, a_s, a_p, p, h, p2, h2, i, L, succ, ovl):
    """The port's round after kernel D's roll: its active entries (order
    keys with the sign bit flipped, prefixes first), the round's sort, then
    F's plain version on the entry indices, ids and the confirm hashes."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    tp, th = t(p.view(np.int64)), t(h.view(np.int64))
    ta_s, ta_p = t(a_s.copy()), t(a_p.copy())
    keys, ent, scratch = ksweep.round_buffers(ids.size, "cpu")
    count = ksweep.round_entries_plain(ta_s, ta_p, th, tp, keys, ent, scratch)
    succ_t, ovl_t = t(succ.copy()), t(ovl.copy())
    order = greedy_scs.round_order(keys, ent, count)
    if order is not None:
        kpair.sweep_pair_claim(*order, t(ids), t(p2.view(np.int64)), t(h2.view(np.int64)),
                               succ_t, ovl_t, ta_s, ta_p, i, L)
    return succ_t.numpy(), ovl_t.numpy(), ta_s.numpy(), ta_p.numpy()


PAIR_KINDS = ["mixed", "dense groups", "runs of one", "one hash",
              "only prefixes", "only suffixes", "one row", "compacted, own key"]


def own_key_case(rng):
    """A table after compaction: sparse ids (a few rows of a large input) and
    every row's prefix and suffix on one key, a few keys in all, so a run
    holds a row's own prefix beside other rows' and a suffix may pair with
    its own row's prefix (a self pair) or another's."""
    n = 600
    N = 50 * n
    ids = np.sort(rng.choice(N, n, replace=False)).astype(np.int32)
    h = rng.integers(0, 5, n).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    p2 = rng.integers(0, 2, n).astype(np.uint64)
    return N, ids, rng.random(n) < 0.9, rng.random(n) < 0.9, h.copy(), h, p2, p2.copy()


@pytest.mark.parametrize("kind", PAIR_KINDS)
def test_sweep_pair_claim_plain_is_reference_pairing(kind):
    """F's side (entry >= n), gid (ids of the entry's row) and confirm hash
    (p2 or h2 of that row) from the entry index, against the reference's
    sort-2 pairing on its gathered entries."""
    rng = np.random.default_rng(100 + PAIR_KINDS.index(kind))
    if kind == "one row":         # one row: its suffix pairs with its own prefix
        N, ids = 7, np.array([5], np.int32)
        a_s, a_p = np.ones(1, bool), np.ones(1, bool)
        p = h = np.full(1, 0x1234, np.uint64)
        p2 = h2 = np.full(1, 3, np.uint64)
    elif kind == "compacted, own key":
        N, ids, a_s, a_p, p, h, p2, h2 = own_key_case(rng)
    else:
        N, ids, a_s, a_p, p, h, p2, h2 = pair_case(
            kind if kind in PAIR_KINDS[:4] else "mixed", rng)
    if kind == "only prefixes":
        a_s[:] = False
    elif kind == "only suffixes":
        a_p[:] = False
    stats = group_stats(a_s, a_p, p, h)
    L, i = 100, 37
    succ0 = np.where(rng.random(N) < 0.3, rng.integers(0, N, N), -1).astype(np.int32)
    ovl0 = np.where(succ0 >= 0, rng.integers(1, L, N), 0).astype(np.int32)
    got = port_round(ids, a_s, a_p, p, h, p2, h2, i, L, succ0, ovl0)
    want_s, want_o, want_as, want_ap = succ0.copy(), ovl0.copy(), a_s.copy(), a_p.copy()
    seen = reference_round(ids, want_as, want_ap, p, h, p2, h2, i, L, want_s, want_o)
    for g, w in zip(got, (want_s, want_o, want_as, want_ap)):
        np.testing.assert_array_equal(g, w)
    if kind in ("mixed", "compacted, own key"):   # every case of the pairing occurs
        assert seen["links"] > 0 and seen["self_pairs"] > 0 and seen["unconfirmed"] > 0
    if kind == "mixed":
        assert min(stats.values()) > 0, stats
    if kind in ("only prefixes", "only suffixes"):
        assert seen["links"] == 0 and (got[2] == a_s).all() and (got[3] == a_p).all()
    if kind == "one row":         # a self pair: no link, the prefix claimed
        assert seen == dict(self_pairs=1, unconfirmed=0, links=0)
        assert got[2].all() and not got[3].any()


def test_sweep_pair_claim_checks_its_inputs():
    n = 4
    z64 = torch.zeros(n, dtype=torch.int64)
    args = [torch.zeros(3, dtype=torch.int64), torch.arange(3),
            torch.arange(n, dtype=torch.int32), z64, z64, torch.zeros(8, dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32), torch.ones(n, dtype=torch.bool),
            torch.ones(n, dtype=torch.bool)]
    with pytest.raises(ValueError):      # round 0 does not exist
        kpair.sweep_pair_claim(*args, 0, 100)
    for pos, wrong in ((2, torch.arange(n)),                      # ids must be int32
                       (3, torch.zeros(n, dtype=torch.int32))):   # p2 must be int64
        bad = list(args)
        bad[pos] = wrong
        with pytest.raises(TypeError):
            kpair.sweep_pair_claim(*bad, 1, 100)
    bad = list(args)
    bad[4] = torch.zeros(2 * n, dtype=torch.int64)   # h2 has one hash per row
    with pytest.raises(ValueError):
        kpair.sweep_pair_claim(*bad, 1, 100)
