"""Greedy pseudogenome generation on torch: the device sweep of
pgrc_tpu/overlap/greedy_scs.py (:683-863) and the wrappers that call it.

Same semantics as the reference, bit for bit: the duplicate-linking init,
then overlap rounds L-1 .. 1 in which every active suffix pairs, rank for
rank inside its equal-hash group, with an active prefix (ranks by global
read id), confirmed by an independent second hash; a prefix is claimed when
a suffix of its rank exists. The table shrinks between segments of rounds.
Host pieces (the small-input numpy mirror, the exact link check, layout and
assembly) are the port's copy of the reference's, in `host.py`.

Where the TPU shaped the reference and the GPU does not, the port differs in
form only:
  * tables are sized exactly (no compile buckets, no padding rows);
  * each round sorts only its valid entries, with one stable sort on the
    64-bit key: entries are built in (side, gid) order, so stability keeps
    the reference's (key, side|gid) order;
  * a suffix finds its rank partner by one gather (seg_start + rank), not by
    a second sort, and results reach their rows by scatter, not by a third
    sort; links go straight to the global arrays instead of a per-segment
    flush (kernel F does ranks, pairing, claim and links in one pass);
    compaction keeps exactly the active rows.

On the card every device program of the sweep is a hand-written kernel but
the library's stable sorts: G hashes the rows (and writes the init's sort
key), G2 links the init's duplicates, D rolls a round's hashes and writes
its active entries compacted, F pairs and links, H compacts the table. The
host reads one count a round (D's entry count, before the sort) and three
at a segment end (H's kept rows and active sides), and nothing else until
the links come back. The table's lanes and N mask are column-major ([W+1,
n], `state.sweep_lanes_to_device`), so that each round reads the two
columns it rolls coalesced; the layout stays inside the sweep.

With a `mesh` of more than one rank (the reference's shard_map path,
greedy_scs.py:243-263, :323-331, :381-397, :514-528) every rank runs the
init over all rows, then keeps one contiguous block of rows, its shard
(sizes differ by at most one; n need not divide by the ranks, and a rank
may hold none). A round, on the card: D's sharded form writes each active
entry, prefixes first, into the rank's send buffer (its key apart from its
payload [side | gid | row, confirm hash]; kernels/csrc/sweep_record.cuh);
the ranks' counts are gathered (the round's one host read); one gather
brings every rank's send buffer to every rank, the buffer's head as it
lies; the key layout writes the gathered keys as one vector in (side,
rank) order, every rank's prefixes, then every rank's suffixes, so the
entries stand in (side, gid) order, as on one device; the library's stable
sort orders them by key; F's sharded form pairs them on every rank,
reading each entry's payload from the gathered buffer through the sort's
permutation, writes every link into the rank's replicated link arrays and
clears only the flags of the rank's own rows. Nothing copies or permutes
the records in between. H compacts each rank's table on its own; the
segment end all-reduces the kept rows and active counts (max), so every
rank takes the same number of rounds. The links are the one-device links,
bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import state
from ..core import packed
from ..kernels.sweep import (record_buffers, record_chunks, round_buffers, sweep_roll_entries,
                             sweep_roll_records)
from ..kernels.sweep_compact import sweep_compact
from ..kernels.sweep_init import link_defaults, sweep_full_hashes, sweep_init_links
from ..kernels.sweep_pair_claim import sharded_keys, sweep_pair_claim, sweep_pair_records
from ..parallel.mesh import active
from ..utils.trace import span
from .host import (  # noqa: F401  (re-exported host layer)
    HASH_BASE64, HASH_BASE64B, OverlapResult, _SEG_PLAN, _SEG_TAIL,
    _find_overlaps_host, _layout_and_assemble, _verify_links,
    both_sides_overlapped)

# inputs of at most this many reads run the reference's numpy mirror (same
# links; a device round is launch-bound at these sizes)
_HOST_SWEEP_MAX = 3072
# a table of at most this many rows runs all its remaining rounds as one
# segment (no more compaction)
_ONE_SEGMENT_MAX_ROWS = 32768
# rows of one sweep table, the reference's value (greedy_scs.py:559-565);
# larger inputs sweep in parts and repair across them. Read at call time, so
# setting it here reaches every call. Raising it changes the links (and so
# the archive bytes) of inputs past 48M rows.
_SWEEP_MAX_ROWS = 48_000_000
# the per-row arrays of a sweep table, in kernel H's order: the lanes
# [W+1, n] and N mask [Wn+1, n] column-major (core/packed.py `empty_cols`),
# the rest [n]
_TABLE = ("lanes", "nmask", "ids", "h", "p", "h2", "p2", "a_s", "a_p")


def _init_links(lanes, nmask, L: int):
    """The init (K1, greedy_scs.py:417-468): both full-read hashes and the
    init's sort key (kernel G), the library's stable sort of the keys, the
    rows' unlinked state (G2's fill) and the duplicate links of equal
    neighbours written over it (kernel G2). -> (h0, h0b, succ, ovl,
    active_s, active_p)."""
    h0, h0b, key = sweep_full_hashes(lanes, nmask, L, with_key=True)
    ks, sidx = torch.sort(key, stable=True)
    del key
    state = link_defaults(ks.numel(), ks.device)
    return (h0, h0b, *sweep_init_links(ks, sidx, h0b, L, state))


def round_order(keys, ent, count):
    """The round's sort: kernel D's active entries keys[:m], ent[:m] in
    construction order = (side, gid) order (ids ascend with the row, and
    compaction keeps row order), stably sorted by key, which keeps the
    reference's (key, side|gid) order. Reading m is the round's one host
    sync. -> (ks, ent), or None when no entry is active."""
    m = int(count)
    if m == 0:
        return None
    ks, perm = torch.sort(keys[:m], stable=True)
    return ks, ent[perm]


def _round(i: int, L: int, t: dict, succ_g, ovl_g) -> None:
    """One overlap round on table `t` (in place); links go to succ_g/ovl_g."""
    keys, ent, scratch = t["entries"]
    count = sweep_roll_entries(t["lanes"], t["nmask"], t["a_s"], t["a_p"], i, L,
                               t["h"], t["p"], t["h2"], t["p2"], keys, ent, scratch)
    order = round_order(keys, ent, count)
    if order is None:
        return
    # ranks, pairing, claim and links in one pass (kernel F)
    sweep_pair_claim(*order, t["ids"], t["p2"], t["h2"], succ_g, ovl_g,
                     t["a_s"], t["a_p"], i, L)


def _round_sharded(i: int, L: int, t: dict, succ_g, ovl_g, mesh) -> None:
    """One overlap round of a rank's table `t` under `mesh` (in place);
    every rank's links go to succ_g/ovl_g on every rank. D's sharded form,
    the count gather (the host read), one gather of the send buffers'
    heads, the key layout in (side, rank) order, its stable sort, and F's
    sharded form reading the gathered buffer through the permutation; the
    key layout and F take the counts where the count gather left them, on
    the card."""
    recs, scratch = t["entries"]
    counts = sweep_roll_records(t["lanes"], t["nmask"], t["a_s"], t["a_p"], i, L,
                                t["h"], t["p"], t["h2"], t["p2"], t["ids"], recs, scratch)
    # [ranks, (m, prefixes)], on the host (the host read) and on the card
    got, counts = mesh.gather_counts(counts)
    m, n_pref = int(got[:, 0].sum()), int(got[:, 1].sum())
    if n_pref == 0 or n_pref == m:
        return          # no pair can form: the round changes nothing
    gathered = mesh.all_gather_rows(recs, record_chunks(int(got[:, 0].max())))
    # the stable sort keeps the (side, gid) order of the layout in a run of
    # equal keys: the reference's (key, side|gid) order
    ks, perm = torch.sort(sharded_keys(gathered, counts, m), stable=True)
    sweep_pair_records(ks, perm, gathered, counts, succ_g, ovl_g, t["a_s"], t["a_p"],
                       *t["gids"], i, L)


def find_overlaps(codes: np.ndarray, coef: float = 1.0, init_active=None, *,
                  device, mesh=None, rows=None) -> OverlapResult:
    """Duplicate linking + overlap rounds on `device`; successor links.

    The reads are the rows of `codes`, or with `rows` ([n] ids) the rows
    codes[rows], packed and checked through the ids without a gathered
    copy (read x of the links is row rows[x]). `coef` limits the rounds to
    overlap lengths L-1 .. L-(int(L*coef)-1); `init_active` = (active_s,
    active_p) skips the init and runs the rounds with only those ends
    active (repair mode). With a `mesh`
    (`parallel.mesh.Mesh`) of more than one rank, every rank calls this on
    the same input and the rounds run sharded on each rank's `mesh.device`
    (the module docstring); every rank returns the one-device links. Port of
    pgrc_tpu.overlap.greedy_scs.find_overlaps."""
    mesh = active(mesh)
    if mesh is not None:
        device = mesh.device
    n, L = codes.shape[0] if rows is None else len(rows), codes.shape[1]
    if n == 0:
        return OverlapResult(np.zeros(0, np.int32), np.zeros(0, np.int32), L)
    if n == 1:
        return OverlapResult(np.full(1, -1, np.int32), np.zeros(1, np.int32), L)
    # under a mesh small inputs take the device rounds too (greedy_scs.py:717)
    if mesh is None and n <= _HOST_SWEEP_MAX:
        sub = codes if rows is None else codes[rows]
        if init_active is None:
            return _find_overlaps_host(sub, coef)
        a_s0, a_p0 = init_active
        return _find_overlaps_host(
            sub, coef, init_state=(np.full(n, -1, np.int32), np.zeros(n, np.int32),
                                   a_s0.copy(), a_p0.copy()))
    if n > _SWEEP_MAX_ROWS and init_active is None:
        return _find_overlaps_partitioned(codes, coef, device=device, mesh=mesh, rows=rows)
    if n >= (1 << 30):
        raise NotImplementedError("overlap rounds index reads with 31-bit ids")
    with span(f"sweep pack+upload n={n}"):
        # the table's lanes column-major ([W+1, n]): a round reads two
        # columns of every row, each coalesced (kernel D)
        lanes, nmask = state.sweep_lanes_to_device(*packed.pack_lanes(codes, rows=rows),
                                                   device)
    if init_active is None:
        h0, h0b, succ_g, ovl_g, a_s, a_p = _init_links(lanes, nmask, L)
    else:
        h0, h0b = sweep_full_hashes(lanes, nmask, L)
        succ_g = torch.full((n,), -1, dtype=torch.int32, device=device)
        ovl_g = torch.zeros((n,), dtype=torch.int32, device=device)
        a_s, a_p = (torch.from_numpy(np.ascontiguousarray(a, dtype=bool)).to(device)
                    for a in init_active)
    lo, hi = (0, n) if mesh is None else mesh.block(n)
    if mesh is not None:
        # the rank's shard: its block of rows (the init's links, in succ_g
        # and ovl_g, are every rank's)
        lanes, nmask, h0, h0b, a_s, a_p = (None if v is None else _block(v, lo, hi)
                                           for v in (lanes, nmask, h0, h0b, a_s, a_p))
    # the largest table of any rank decides the segments, the same on all,
    # and sizes every rank's send buffer
    rows_max = hi - lo if mesh is None else max(mesh.splits(n))
    # the round kernel rolls h, p, h2, p2 in place: four distinct buffers;
    # the table holds its rounds' entry buffers (kernel D's outputs)
    t = dict(lanes=lanes, nmask=nmask,
             ids=torch.arange(lo, hi, dtype=torch.int32, device=device),
             h=h0, p=h0.clone(), h2=h0b, p2=h0b.clone(), a_s=a_s, a_p=a_p, gids=(lo, hi),
             entries=_entry_buffers(rows_max, device, mesh))
    iters = int(L * coef)
    i, seg_idx = 1, 0
    with span(f"sweep rounds n={n}"):
        while i < iters:
            seg = _SEG_PLAN[seg_idx] if seg_idx < len(_SEG_PLAN) else _SEG_TAIL
            seg_idx += 1
            if rows_max <= _ONE_SEGMENT_MAX_ROWS:
                seg = iters - i
            i1 = min(i + seg, iters)
            for r in range(i, i1):
                if mesh is None:
                    _round(r, L, t, succ_g, ovl_g)
                else:
                    _round_sharded(r, L, t, succ_g, ovl_g, mesh)
            i = i1
            if i >= iters:
                break
            # compaction moves rows, never changes a link: every decision is
            # in global-id space (greedy_scs.py:824-826). Kernel H writes the
            # kept rows to the front of new arrays and counts the kept rows
            # and both active sides, the segment end's one host read; the
            # entry buffers go first, so they are not held through it
            n_rows = t["ids"].numel()
            del t["entries"]
            new, counts = sweep_compact(*(t[k] for k in _TABLE))
            kept, n_suf, n_pref = counts.tolist()
            rows_max = kept
            if mesh is not None:
                # the ranks' largest table, and whether any rank keeps an
                # active suffix and an active prefix
                rows_max, n_suf, n_pref = mesh.all_reduce(counts.clone(), "max").tolist()
            if n_suf == 0 or n_pref == 0:
                break
            if kept < n_rows:
                # the kept rows: the head of each array, and of each lane
                # and N-mask column (a view; the kernels take its stride)
                t.update((k, None if v is None else v[..., :kept]) for k, v in zip(_TABLE, new))
            del new
            t["entries"] = _entry_buffers(rows_max, device, mesh)
    res = OverlapResult(succ_g.cpu().numpy(), ovl_g.cpu().numpy(), L)
    with span("sweep verify_links"):
        _verify_links(res, codes, rows)
    return res


def _block(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows lo..hi of a table array, copied; the lanes and N mask stay
    column-major."""
    return packed.cols_copy(v[:, lo:hi]) if v.dim() == 2 else v[lo:hi].clone()


def _entry_buffers(rows_max: int, device, mesh):
    """A table's round buffers: kernel D's, or its sharded form's (sized
    from the largest table of any rank, rows_max rows)."""
    return round_buffers(rows_max, device) if mesh is None else record_buffers(rows_max, device)


def _find_overlaps_partitioned(codes: np.ndarray, coef: float, *,
                               device, mesh=None, rows=None) -> OverlapResult:
    """Inputs past `_SWEEP_MAX_ROWS` rows (port of
    greedy_scs._find_overlaps_partitioned, :1070-1094): equal row parts
    swept one after another, then a repair sweep across the parts with only
    the free suffix/prefix ends active. Each part is a range of row ids
    into `codes` (into `rows` with `rows`), not a copy."""
    n, L = codes.shape[0] if rows is None else len(rows), codes.shape[1]
    ids = np.arange(n, dtype=np.int64) if rows is None else rows
    parts = -(-n // _SWEEP_MAX_ROWS)
    per = -(-n // parts)
    res = OverlapResult(np.full(n, -1, dtype=np.int32), np.zeros(n, dtype=np.int32), L)
    for p in range(parts):
        lo, hi = p * per, min((p + 1) * per, n)
        with span(f"sweep part {p + 1}/{parts} rows={hi - lo}"):
            sub = find_overlaps(codes, coef=coef, device=device, mesh=mesh,
                                rows=ids[lo:hi])
        has = sub.succ >= 0
        res.succ[lo:hi][has] = sub.succ[has] + np.int32(lo)
        res.overlap[lo:hi][has] = sub.overlap[has]
    with span("sweep cross-part repair"):
        repair_links(codes, res, coef=coef, device=device, mesh=mesh, rows=rows)
    return res


def repair_links(codes: np.ndarray, res: OverlapResult, coef: float = 1.0, *,
                 device, mesh=None, rows=None) -> None:
    """Re-match the free suffix/prefix ends of a link set, in place, in
    tables of at most `_SWEEP_MAX_ROWS` rows (port of
    greedy_scs.repair_links, :1097-1124). Read x of `res` is row x of
    `codes`, or row rows[x] with `rows`; each table's reads are handed to
    the sweep as ids, not as a copy of their rows."""
    n = res.succ.shape[0]
    if n <= 1:
        return
    has_pred = np.zeros(n, dtype=bool)
    s = res.succ
    has_pred[s[s >= 0]] = True
    a_s = s < 0
    a_p = ~has_pred
    free = np.nonzero(a_s | a_p)[0]
    if free.size <= 1:
        return
    for lo in range(0, free.size, _SWEEP_MAX_ROWS):
        r = free[lo : lo + _SWEEP_MAX_ROWS]
        sub = find_overlaps(codes, coef=coef, init_active=(a_s[r], a_p[r]),
                            device=device, mesh=mesh, rows=r if rows is None else rows[r])
        new = sub.succ >= 0
        res.succ[r[new]] = r[sub.succ[new]].astype(np.int32)
        res.overlap[r[new]] = sub.overlap[new]


def divide_and_generate(codes: np.ndarray, coef: float, *, device, mesh=None,
                        rows=None):
    """Fused stages 2+3 (port of greedy_scs.divide_and_generate, :1127-1184):
    one full-depth sweep gives the generator-based division and, after the
    links touching dropped reads are cut and the weakest re-cut, a repair
    sweep relinks the free ends. Returns (keep [n], pg, order, pos). The
    reads are the rows of `codes`, or with `rows` ([n] ids) codes[rows];
    the kept reads go to the repair sweep and the assembly as ids, so no
    stage copies the code rows."""
    n, L = codes.shape[0] if rows is None else len(rows), codes.shape[1]
    with span(f"fused full sweep n={n}"):
        resf = find_overlaps(codes, coef=1.0, device=device, mesh=mesh, rows=rows)
    iters = int(L * coef)
    thr = L - iters + 1  # minimum overlap reachable by rounds [1, iters)
    part = resf.overlap >= thr
    snap = OverlapResult(np.where(part, resf.succ, -1).astype(np.int32),
                         np.where(part, resf.overlap, 0).astype(np.int32), L)
    keep = both_sides_overlapped(snap)
    kept = np.nonzero(keep)[0]
    remap = np.full(n, -1, dtype=np.int64)
    remap[kept] = np.arange(kept.size)
    sk = np.clip(resf.succ[kept], 0, max(n - 1, 0))
    good = (resf.succ[kept] >= 0) & keep[sk]
    # weak-link re-cut: cut the weakest links up to 8% of the kept reads
    # and let the repair sweep relink them at full depth
    ovl_k = resf.overlap[kept]
    budget = int(0.08 * kept.size)
    hist = np.bincount(np.where(good, np.minimum(ovl_k, L), L), minlength=L + 1)
    csum = np.cumsum(hist)  # csum[t-1] = count of good links with ovl < t
    relink_thr = 0
    for thr_t in range(min(75, L - 1), thr, -1):
        if csum[thr_t - 1] <= budget:
            relink_thr = thr_t
            break
    if relink_thr:
        good = good & (ovl_k >= relink_thr)
    res_k = OverlapResult(np.where(good, remap[sk], -1).astype(np.int32),
                          np.where(good, ovl_k, 0).astype(np.int32), L)
    # the full sweep's per-row arrays are not needed past here
    del resf, part, snap, remap, sk, good, ovl_k
    sub_rows = kept if rows is None else rows[kept]
    del kept
    with span(f"repair sweep kept={sub_rows.size}"):
        repair_links(codes, res_k, device=device, mesh=mesh, rows=sub_rows)
    with span("chainwalk+assemble"):
        pg, order, pos = _layout_and_assemble(res_k, codes, sub_rows)
    return keep, pg, order, pos


def generate_pseudogenome(codes: np.ndarray, coef: float = 1.0, *, device, mesh=None,
                          rows=None):
    """Overlaps -> cycle removal -> layout -> pg: (pg_codes, order, pos_sorted).
    The reads are the rows of `codes`, or with `rows` ([n] ids) codes[rows]."""
    res = find_overlaps(codes, coef, device=device, mesh=mesh, rows=rows)
    return _layout_and_assemble(res, codes, rows)
