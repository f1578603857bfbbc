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
"""
from __future__ import annotations

import numpy as np
import torch

from .. import state
from ..core import packed
from ..core.packed import col_vals
from ..kernels.sweep import sweep_roll_entries
from ..kernels.sweep_pair_claim import sweep_pair_claim
from ..utils.trace import span
from ..utils.uint import SIGN64, s64
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

_A = s64(int(HASH_BASE64))
_B = s64(int(HASH_BASE64B))


def _full_hashes(lanes, nmask, L: int):
    """Both full-read u64 hashes by Horner over the columns (K1/K4)."""
    n = lanes.shape[0]
    h = torch.zeros((n,), dtype=torch.int64, device=lanes.device)
    hb = torch.zeros_like(h)
    for t in range(L):
        v = col_vals(lanes, nmask, t)
        h = h * _A + v
        hb = hb * _B + v
    return h, hb


def _init_links(h0, h0b, L: int):
    """Duplicate linking (K1, greedy_scs.py:442-465): stable sort of the
    first hash (clamped below INV64); each row links to its sorted neighbour
    when both hashes match. The reference's wrap-around neighbour of the
    last sorted row never links (its key test is forced false), so only
    the n-1 adjacent pairs are tested."""
    n = h0.numel()
    ks = torch.where(h0 == -1, -2, h0)              # min(h0, INV64 - 1)
    _, sidx = torch.sort(ks ^ SIGN64, stable=True)  # unsigned order
    ks_s, hb_s = ks[sidx], h0b[sidx]
    matched = (ks_s[1:] == ks_s[:-1]) & (hb_s[1:] == hb_s[:-1])
    me, nx = sidx[:-1][matched], sidx[1:][matched]
    succ = torch.full((n,), -1, dtype=torch.int32, device=h0.device)
    ovl = torch.zeros((n,), dtype=torch.int32, device=h0.device)
    succ[me] = nx.to(torch.int32)
    ovl[me] = L
    has_pred = torch.zeros((n,), dtype=torch.bool, device=h0.device)
    has_pred[nx] = True
    return succ, ovl, succ < 0, ~has_pred


def round_order(k1, a_p, a_s):
    """The round's sort: the valid entries (active prefixes, then active
    suffixes) in construction order = (side, gid) order, because ids ascend
    with the row (compaction keeps row order), stably sorted by k1, which
    keeps the reference's (key, side|gid) order. -> (ks, ent), or None when
    no entry is valid."""
    sel = torch.nonzero(torch.cat([a_p, a_s])).squeeze(1)
    if sel.numel() == 0:
        return None
    ks, perm = torch.sort(k1[sel], stable=True)
    return ks, sel[perm]


def _round(i: int, L: int, t: dict, succ_g, ovl_g) -> None:
    """One overlap round on table `t` (in place); links go to succ_g/ovl_g."""
    k1, k2, orig, v2 = sweep_roll_entries(
        t["lanes"], t["nmask"], t["ids"], t["a_s"], t["a_p"], i, L,
        t["h"], t["p"], t["h2"], t["p2"])
    order = round_order(k1, t["a_p"], t["a_s"])
    if order is None:
        return
    # ranks, pairing, claim and links in one pass (kernel F)
    sweep_pair_claim(*order, k2, v2, orig, t["ids"], succ_g, ovl_g,
                     t["a_s"], t["a_p"], i, L)


def find_overlaps(codes: np.ndarray, coef: float = 1.0, init_active=None, *,
                  device) -> OverlapResult:
    """Duplicate linking + overlap rounds on `device`; successor links.

    `coef` limits the rounds to overlap lengths L-1 .. L-(int(L*coef)-1);
    `init_active` = (active_s, active_p) skips the init and runs the rounds
    with only those ends active (repair mode). Port of
    pgrc_tpu.overlap.greedy_scs.find_overlaps without `mesh`."""
    n, L = codes.shape
    if n == 0:
        return OverlapResult(np.zeros(0, np.int32), np.zeros(0, np.int32), L)
    if n == 1:
        return OverlapResult(np.full(1, -1, np.int32), np.zeros(1, np.int32), L)
    if n <= _HOST_SWEEP_MAX:
        if init_active is None:
            return _find_overlaps_host(codes, coef)
        a_s0, a_p0 = init_active
        return _find_overlaps_host(
            codes, coef, init_state=(np.full(n, -1, np.int32), np.zeros(n, np.int32),
                                     a_s0.copy(), a_p0.copy()))
    if n > _SWEEP_MAX_ROWS and init_active is None:
        return _find_overlaps_partitioned(codes, coef, device=device)
    if n >= (1 << 30):
        raise NotImplementedError("overlap rounds index reads with 31-bit ids")
    with span(f"sweep pack+upload n={n}"):
        lanes, nmask = state.lanes_to_device(*packed.pack_lanes(codes), device)
    h0, h0b = _full_hashes(lanes, nmask, L)
    if init_active is None:
        succ_g, ovl_g, a_s, a_p = _init_links(h0, h0b, L)
    else:
        succ_g = torch.full((n,), -1, dtype=torch.int32, device=device)
        ovl_g = torch.zeros((n,), dtype=torch.int32, device=device)
        a_s, a_p = (torch.from_numpy(np.ascontiguousarray(a, dtype=bool)).to(device)
                    for a in init_active)
    # the round kernel rolls h, p, h2, p2 in place: four distinct buffers
    t = dict(lanes=lanes, nmask=nmask,
             ids=torch.arange(n, dtype=torch.int32, device=device),
             h=h0, p=h0.clone(), h2=h0b, p2=h0b.clone(), a_s=a_s, a_p=a_p)
    iters = int(L * coef)
    i, seg_idx = 1, 0
    with span(f"sweep rounds n={n}"):
        while i < iters:
            seg = _SEG_PLAN[seg_idx] if seg_idx < len(_SEG_PLAN) else _SEG_TAIL
            seg_idx += 1
            if t["ids"].numel() <= _ONE_SEGMENT_MAX_ROWS:
                seg = iters - i
            i1 = min(i + seg, iters)
            for r in range(i, i1):
                _round(r, L, t, succ_g, ovl_g)
            i = i1
            if i >= iters or not (t["a_s"].any() and t["a_p"].any()):
                break
            # compaction moves rows, never changes a link: every decision is
            # in global-id space (greedy_scs.py:824-826)
            keep = torch.nonzero(t["a_s"] | t["a_p"]).squeeze(1)
            if keep.numel() < t["ids"].numel():
                for key, v in t.items():
                    if v is not None:
                        t[key] = v[keep]
    res = OverlapResult(succ_g.cpu().numpy(), ovl_g.cpu().numpy(), L)
    with span("sweep verify_links"):
        _verify_links(res, codes)
    return res


def _find_overlaps_partitioned(codes: np.ndarray, coef: float, *,
                               device) -> OverlapResult:
    """Inputs past `_SWEEP_MAX_ROWS` rows (port of
    greedy_scs._find_overlaps_partitioned, :1070-1094): equal row parts
    swept one after another, then a repair sweep across the parts with only
    the free suffix/prefix ends active."""
    n, L = codes.shape
    parts = -(-n // _SWEEP_MAX_ROWS)
    per = -(-n // parts)
    res = OverlapResult(np.full(n, -1, dtype=np.int32), np.zeros(n, dtype=np.int32), L)
    for p in range(parts):
        lo, hi = p * per, min((p + 1) * per, n)
        with span(f"sweep part {p + 1}/{parts} rows={hi - lo}"):
            sub = find_overlaps(codes[lo:hi], coef=coef, device=device)
        has = sub.succ >= 0
        res.succ[lo:hi][has] = sub.succ[has] + np.int32(lo)
        res.overlap[lo:hi][has] = sub.overlap[has]
    with span("sweep cross-part repair"):
        repair_links(codes, res, coef=coef, device=device)
    return res


def repair_links(codes: np.ndarray, res: OverlapResult, coef: float = 1.0, *,
                 device) -> None:
    """Re-match the free suffix/prefix ends of a link set, in place, in
    tables of at most `_SWEEP_MAX_ROWS` rows (port of
    greedy_scs.repair_links, :1097-1124)."""
    n = res.succ.shape[0]
    if n <= 1:
        return
    has_pred = np.zeros(n, dtype=bool)
    s = res.succ
    has_pred[s[s >= 0]] = True
    a_s = s < 0
    a_p = ~has_pred
    rows = np.nonzero(a_s | a_p)[0]
    if rows.size <= 1:
        return
    for lo in range(0, rows.size, _SWEEP_MAX_ROWS):
        r = rows[lo : lo + _SWEEP_MAX_ROWS]
        sub = find_overlaps(codes[r], coef=coef, init_active=(a_s[r], a_p[r]),
                            device=device)
        new = sub.succ >= 0
        res.succ[r[new]] = r[sub.succ[new]].astype(np.int32)
        res.overlap[r[new]] = sub.overlap[new]


def divide_and_generate(codes: np.ndarray, coef: float, *, device):
    """Fused stages 2+3 (port of greedy_scs.divide_and_generate, :1127-1184):
    one full-depth sweep gives the generator-based division and, after the
    links touching dropped reads are cut and the weakest re-cut, a repair
    sweep relinks the free ends. Returns (keep [n], pg, order, pos)."""
    n, L = codes.shape
    with span(f"fused full sweep n={n}"):
        resf = find_overlaps(codes, coef=1.0, device=device)
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
    sub_codes = codes[kept]
    with span(f"repair sweep kept={kept.size}"):
        repair_links(sub_codes, res_k, device=device)
    with span("chainwalk+assemble"):
        pg, order, pos = _layout_and_assemble(res_k, sub_codes)
    return keep, pg, order, pos


def generate_pseudogenome(codes: np.ndarray, coef: float = 1.0, *, device):
    """Overlaps -> cycle removal -> layout -> pg: (pg_codes, order, pos_sorted)."""
    res = find_overlaps(codes, coef, device=device)
    return _layout_and_assemble(res, codes)
