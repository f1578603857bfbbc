"""Host layer of the overlap sweep: a copy of pgrc_tpu/overlap/greedy_scs.py's
device-neutral pieces, with only the imports changed.

The hash bases of the rolling hashes (:36-57), `OverlapResult` (:60-72),
their power table (`_pow_table64`, :134-141), the segment plan (:545-548), the numpy mirror of the sweep that small inputs
take (`_find_overlaps_host`, :568-680) with its exact link check
(`_verify_links`, :866-888; a device table's links are checked on the
device, kernel J) and the post-processing after the rounds — cycle
removal, chain layout and pg assembly (:924-1057). The device rounds live
in `greedy_scs.py` beside this module. The assembly also takes the reads
as row ids into a larger matrix (`rows=`), so that the encoder hands it
its one code matrix and no gathered copy.
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np

from ..core.packed_host import row_chunks

HASH_BASE = np.uint32(0x9E3779B1)  # odd -> invertible mod 2^32


def _modinv_u32(b: int) -> int:
    """Inverse of odd b modulo 2^32 (Newton iteration)."""
    x = b
    for _ in range(5):
        x = (x * (2 - b * x)) & 0xFFFFFFFF
    return x


HASH_BASE_INV = np.uint32(_modinv_u32(int(HASH_BASE)))

# 64-bit rolling-hash bases for the overlap rounds: pairing is by full 64-bit
# hash equality under base A, candidate pairs are confirmed by equality of an
# INDEPENDENT base-B hash (2^-128-class false-accept odds), and the final
# links get one exact host-side verification after the rounds — so the hot
# round program needs no packed-lane gathers at all
HASH_BASE64 = np.uint64(0x9E3779B97F4A7C15)
HASH_BASE64_INV = np.uint64(pow(int(HASH_BASE64), -1, 1 << 64))
HASH_BASE64B = np.uint64(0xC2B2AE3D27D4EB4F)
HASH_BASE64B_INV = np.uint64(pow(int(HASH_BASE64B), -1, 1 << 64))


@dataclass
class OverlapResult:
    succ: np.ndarray        # [N] int32, -1 = no successor
    overlap: np.ndarray     # [N] int32, overlap with successor
    read_len: int

    @property
    def pred(self) -> np.ndarray:
        n = self.succ.shape[0]
        pred = np.full(n, -1, dtype=np.int32)
        has = self.succ >= 0
        pred[self.succ[has]] = np.nonzero(has)[0].astype(np.int32)
        return pred


def _pow_table64(L: int, base: np.uint64 = HASH_BASE64) -> np.ndarray:
    pows = np.ones(L + 1, dtype=np.uint64)
    b = int(base)
    v = 1
    for k in range(1, L + 1):
        v = (v * b) & 0xFFFFFFFFFFFFFFFF
        pows[k] = np.uint64(v)
    return pows


# segment lengths between host syncs: short early (active set collapses
# fastest in the first high-overlap rounds), longer later
_SEG_PLAN = (6, 6, 12, 12, 24, 24)
_SEG_TAIL = 48


def _find_overlaps_host(codes: np.ndarray, coef: float = 1.0,
                        init_state=None) -> OverlapResult:
    """Numpy mirror of the device sweep (init duplicate-linking + rounds).

    Semantics are identical to the device program — full-read 64-bit hash
    sort with stable-id dedup links, then per-round rank-pairing of
    equal-hash suffix/prefix groups with the same global-id tie-breaks,
    second-hash confirmation, and the conservative prefix claim — so host
    and device paths produce the same links for the same input."""
    n, L = codes.shape
    v = codes.astype(np.uint64)          # symbol value incl. N (= 4)
    pows64 = _pow_table64(L)
    pows64b = _pow_table64(L, HASH_BASE64B)
    inv64 = np.uint64(HASH_BASE64_INV)
    inv64b = np.uint64(HASH_BASE64B_INV)
    INV64 = np.uint64(0xFFFFFFFFFFFFFFFF)

    # full-read hashes (Horner)
    h0 = np.zeros(n, dtype=np.uint64)
    h0b = np.zeros(n, dtype=np.uint64)
    for t in range(L):
        h0 = h0 * HASH_BASE64 + v[:, t]
        h0b = h0b * HASH_BASE64B + v[:, t]

    if init_state is None:
        succ = np.full(n, -1, dtype=np.int32)
        ovl = np.zeros(n, dtype=np.int32)
        # duplicate linking: stable hash sort, equal-exact neighbors link
        ks = np.minimum(h0, INV64 - np.uint64(1))
        sidx = np.argsort(ks, kind="stable")
        ks_s = ks[sidx]
        nxt_same = np.zeros(n, dtype=bool)
        if n > 1:
            nxt_same[:-1] = ks_s[1:] == ks_s[:-1]
            eq = (codes[sidx[:-1]] == codes[sidx[1:]]).all(axis=1)
            m = nxt_same[:-1] & eq
            me, nx = sidx[:-1][m], sidx[1:][m]
            succ[me] = nx
            ovl[me] = L
            has_pred = np.zeros(n, dtype=bool)
            has_pred[nx] = True
        else:
            has_pred = np.zeros(n, dtype=bool)
        active_s = succ < 0
        active_p = ~has_pred
    else:
        succ0, ovl0, a_s0, a_p0 = init_state
        succ = succ0.astype(np.int32).copy()
        ovl = ovl0.astype(np.int32).copy()
        active_s = a_s0.copy()
        active_p = a_p0.copy()

    h, p = h0.copy(), h0.copy()
    h2, p2 = h0b.copy(), h0b.copy()
    iters = int(L * coef)
    for i in range(1, iters):
        # rolling updates (cumulative — run even when matching skips)
        h = h - v[:, i - 1] * pows64[L - i]
        h2 = h2 - v[:, i - 1] * pows64b[L - i]
        p = (p - v[:, L - i]) * inv64
        p2 = (p2 - v[:, L - i]) * inv64b
        sufs = np.nonzero(active_s)[0]
        prefs = np.nonzero(active_p)[0]
        if sufs.size == 0 or prefs.size == 0:
            break
        # group by hash value; prefixes before suffixes, each side by gid
        key = np.concatenate([p[prefs], h[sufs]])
        side = np.concatenate([np.zeros(prefs.size, np.uint8),
                               np.ones(sufs.size, np.uint8)])
        gid = np.concatenate([prefs, sufs]).astype(np.int64)
        order = np.lexsort((gid, side, key))
        k_s, s_s, g_s = key[order], side[order], gid[order]
        m = order.size
        idx = np.arange(m, dtype=np.int64)
        boundary = np.ones(m, dtype=bool)
        boundary[1:] = k_s[1:] != k_s[:-1]
        seg_start = np.maximum.accumulate(np.where(boundary, idx, 0))
        is_suf = s_s == 1
        prev_is_suf = np.zeros(m, dtype=bool)
        prev_is_suf[1:] = is_suf[:-1]
        first_suf = is_suf & (~prev_is_suf | boundary)
        fs_bwd = np.maximum.accumulate(np.where(first_suf, idx, -1))
        # suffix rank-k pairs the prefix with rank k of the same group
        srows = np.nonzero(is_suf & (fs_bwd >= 0))[0]
        rank = srows - fs_bwd[srows]
        npref = fs_bwd[srows] - seg_start[srows]
        paired = rank < npref
        sj = srows[paired]
        partner = seg_start[sj] + rank[paired]
        a = g_s[sj]                # suffix read
        b = g_s[partner]           # prefix read
        okl = (a != b) & (h2[a] == p2[b])
        succ[a[okl]] = b[okl].astype(np.int32)
        ovl[a[okl]] = np.int32(L - i)
        active_s[a[okl]] = False
        # prefix rank-k claimed iff a suffix of rank k exists (independent
        # of that pair's confirmation — the conservative over-claim)
        starts = idx[boundary]
        ends = np.concatenate([starts[1:], [m]])
        # group's first suffix: fs_bwd at the group's LAST entry is its own
        # first_suf when the group has suffixes (they are contiguous at the
        # group end), else an earlier group's (< starts -> no suffixes)
        fs_end = fs_bwd[ends - 1]
        fs = np.where(fs_end >= starts, fs_end, ends)
        n_suf_grp = ends - fs
        grp_id = np.cumsum(boundary) - 1
        prows = np.nonzero(~is_suf)[0]
        prank = prows - seg_start[prows]
        claimed = prank < n_suf_grp[grp_id[prows]]
        active_p[g_s[prows[claimed]]] = False
    res = OverlapResult(succ, ovl, L)
    _verify_links(res, codes)
    return res


def _verify_links(res: OverlapResult, codes: np.ndarray) -> None:
    """One exact host-side verification of the final links (in place).

    Round pairing (and init duplicate-linking) accepts on two independent
    64-bit hash matches; this pass compares the actual overlap bytes and
    cuts any link that fails, so even a double hash collision costs only a
    dropped link (a slightly longer pg), never a wrong pseudogenome byte.
    Vectorized per overlap length, including the overlap-L duplicates."""
    L = res.read_len
    has = np.nonzero(res.succ >= 0)[0]
    if not has.size:
        return
    ovl = res.overlap[has]
    chunk = 1 << 20  # bound the [rows, o] gather temporaries (~200 MB)
    for o in np.unique(ovl):
        rows_all = has[ovl == o]
        for lo in range(0, rows_all.size, chunk):
            sel = rows_all[lo : lo + chunk]
            bad = (codes[sel, L - o:] != codes[res.succ[sel], :o]).any(axis=1)
            if bad.any():
                cut = sel[bad]
                res.succ[cut] = -1
                res.overlap[cut] = 0


def both_sides_overlapped(res: OverlapResult) -> np.ndarray:
    """HQ filter (reference getBothSidesOverlappedReads,
    AbstractOverlapPseudoGenomeGenerator.cpp:67-98): keep reads overlapped on
    both sides, or duplicate-linked on either side."""
    n = res.succ.shape[0]
    L = res.read_len
    prev_overlap = np.zeros(n, dtype=np.int32)
    has = res.succ >= 0
    prev_overlap[res.succ[has]] = res.overlap[has]
    keep = ((prev_overlap > 0) & has) | (has & (res.overlap == L)) | (prev_overlap == L)
    return keep


def remove_cycles(res: OverlapResult) -> None:
    """Cut the minimum-overlap edge of every cycle (in place).

    Functional-graph cycles are found with pointer doubling; per cycle the
    edge with minimal (overlap, node) is removed — same effect as the
    reference's sequential walk (AbstractOverlap...cpp:6-41).
    """
    n = res.succ.shape[0]
    if n == 0:
        return
    f = res.succ.astype(np.int64).copy()
    terminal = f < 0
    f[terminal] = np.nonzero(terminal)[0]
    reaches_terminal = terminal.copy()
    # min node id reachable (propagated along the walk) for cycle ids
    mmin = np.arange(n, dtype=np.int64)
    steps = 1
    while steps < 2 * n:
        reaches_terminal |= reaches_terminal[f]
        mmin = np.minimum(mmin, mmin[f])
        f = f[f]
        steps *= 2
    in_cycle = ~reaches_terminal
    if not in_cycle.any():
        return
    cyc_nodes = np.nonzero(in_cycle)[0]
    cyc_id = mmin[cyc_nodes]  # min node of each cycle
    # pick per cycle the node with min (overlap, node) and cut its edge
    order = np.lexsort((cyc_nodes, res.overlap[cyc_nodes], cyc_id))
    sorted_ids = cyc_id[order]
    first_of_group = np.ones(sorted_ids.size, dtype=bool)
    first_of_group[1:] = sorted_ids[1:] != sorted_ids[:-1]
    cut = cyc_nodes[order[first_of_group]]
    res.succ[cut] = -1
    res.overlap[cut] = 0


@dataclass
class ChainLayout:
    order: np.ndarray       # [N] read indexes in pseudogenome order
    pos: np.ndarray         # [N] pg position per read (aligned with `order`? no: per read idx)
    pg_len: int


def layout_chains(res: OverlapResult) -> ChainLayout:
    """Compute each read's pseudogenome position via pointer doubling.

    Chains are laid out consecutively in increasing head-read order
    (mirroring the reference's head-order assembly); within a chain read x
    sits at head_start + sum(L - overlap) over its predecessors. Duplicate
    reads share positions; the reads-list order is (pos, rank-in-chain).
    """
    succ = res.succ
    n = succ.shape[0]
    L = res.read_len
    if n == 0:
        return ChainLayout(np.zeros(0, np.int64), np.zeros(0, np.int64), 0)
    pred = np.full(n, -1, dtype=np.int64)
    has = succ >= 0
    pred[succ[has]] = np.nonzero(has)[0]

    g = pred.copy()
    heads = g < 0
    g[heads] = np.nonzero(heads)[0]
    # weight of edge pred->x = L - overlap[pred[x]]
    w = np.zeros(n, dtype=np.int64)
    nz = pred >= 0
    w[nz] = L - res.overlap[pred[nz]]
    rank = nz.astype(np.int64)
    steps = 1
    while steps < 2 * n:
        w = w + w[g]
        rank = rank + rank[g]
        g = g[g]
        steps *= 2
    head = g  # chain head per read
    # chain length = max local offset + L, per head
    chain_end = np.zeros(n, dtype=np.int64)
    np.maximum.at(chain_end, head, w + L)
    head_ids = np.nonzero(heads)[0]
    lengths = chain_end[head_ids]
    starts = np.zeros(head_ids.size, dtype=np.int64)
    starts[1:] = np.cumsum(lengths)[:-1]
    start_per_head = np.zeros(n, dtype=np.int64)
    start_per_head[head_ids] = starts
    pos = start_per_head[head] + w
    pg_len = int(lengths.sum())
    order = np.lexsort((rank, pos))
    return ChainLayout(order=order.astype(np.int64), pos=pos, pg_len=pg_len)


def assemble_pg(codes: np.ndarray, layout: ChainLayout, rows=None) -> np.ndarray:
    """Materialise the pseudogenome sequence: every read scatters its full
    content at its position (overlapping bytes agree by construction).
    Read x is row x of `codes`, or row rows[x] with `rows` ([n] ids),
    scattered a chunk of reads at a time."""
    L = codes.shape[1]
    pg = np.zeros(layout.pg_len, dtype=np.uint8)
    cols = np.arange(L, dtype=np.int64)[None, :]
    for lo, c in row_chunks(codes, rows):
        pg[layout.pos[lo:lo + c.shape[0], None] + cols] = c
    return pg


def _layout_and_assemble(res: OverlapResult, codes: np.ndarray, rows=None):
    """Chain layout + pg materialisation for a final link set; read x is
    row x of `codes`, or row rows[x] with `rows` ([n] ids).

    Normally one sequential native pass (native/chainwalk.cpp — the
    reference's chain-walk assembly, AbstractOverlapPseudoGenomeGenerator
    .cpp:181-219); the numpy pointer-doubling path is the semantic
    reference and fallback."""
    if res.succ.size:
        from .. import native

        fast = native.chain_walk_assemble(res.succ, res.overlap, codes, rows)
        if fast is not None:
            pos, order, pg = fast
            return pg, order, pos
    remove_cycles(res)
    layout = layout_chains(res)
    pg = assemble_pg(codes, layout, rows)
    return pg, layout.order, layout.pos[layout.order]
