"""Stage-7 pg-vs-pg exact matching (SimplePgMatcher re-design).

Finds long (>= target_match_length) exact matches of the lq / N / hq-self
pseudogenomes against the hq pg under reverse-complement matching, replaces
them with a MARK token + (source offset, length) streams, and restores them
on decode — the TPU-friendly equivalent of matching/SimplePgMatcher.cpp:
69-148 (markAndRemoveExactMatches), :160-173 (self collision resolution),
:259-351 (restore).

Anchors come from the same rolling-hash CSR index as the read matcher;
anchor pairs are extended to maximal runs with block-wise vectorized
comparison rounds instead of per-symbol loops.
"""
from __future__ import annotations

import numpy as np

from .. import native
from ..align import host as align_matcher
from ..streams import props
from ..streams.container import StreamReader
from ..streams.varlen_dna import MARK
from ..utils import dna
from ..utils.errors import PgtcFormatError
from ..utils.trace import span
from ..utils.varint import encode_varints, decode_varints, write_varint, read_varint

# copMEM sampling guarantee (CopMEMMatcher.cpp:111-137): with coprime strides
# k1 (source) and k2 (query), every exact match of length >= k + k1*k2 - 1
# contains a sampled source k-mer aligned with a probed query k-mer (CRT on
# the diagonal). 24 + 7*3 - 1 = 44 <= default target length 45.
ANCHOR_K = 24
SRC_STRIDE = 7
DEST_STRIDE = 3
CAP = 4
EXTEND_BLOCK = 64


def _find_matches(src: np.ndarray, index, query: np.ndarray, min_len: int) -> np.ndarray:
    """Maximal exact matches (>= min_len) of query vs src via sampled anchors.

    Returns [M, 3] (src_pos, query_pos, length), deduplicated.
    """
    nq = query.shape[0]
    k = index.k
    if nq < k or index.positions.size == 0:
        return np.zeros((0, 3), dtype=np.int64)
    qh = align_matcher._window_hashes(query, k)
    probes = np.arange(0, nq - k + 1, DEST_STRIDE, dtype=np.int64)
    qh_p = qh[probes]
    # equal-range lookup in the hash-sorted index (v2: no CSR buckets)
    lo = np.searchsorted(index.hash_sorted, qh_p, side="left")
    cnt = np.searchsorted(index.hash_sorted, qh_p, side="right") - lo
    slot = np.arange(CAP, dtype=np.int64)
    cand = lo[:, None] + slot[None, :]
    valid = slot[None, :] < np.minimum(cnt, CAP)[:, None]
    cand = np.clip(cand, 0, max(index.pos_sorted.size - 1, 0))
    spos = index.pos_sorted[cand]                      # [P, C]
    qpos = np.broadcast_to(probes[:, None], spos.shape)
    spos = spos[valid]
    qpos = qpos[valid]
    if spos.size == 0:
        return np.zeros((0, 3), dtype=np.int64)
    # confirm the anchor k-mer is a true match (hash bucket is lossy)
    ok = np.ones(spos.size, dtype=bool)
    for t in range(0, k, 8):
        w = min(8, k - t)
        ok &= (src[spos[:, None] + np.arange(t, t + w)] ==
               query[qpos[:, None] + np.arange(t, t + w)]).all(axis=1)
    spos, qpos = spos[ok], qpos[ok]
    if spos.size == 0:
        return np.zeros((0, 3), dtype=np.int64)
    # anchors on one diagonal inside one maximal run are redundant — extending
    # each would redo O(run length) work per anchor (quadratic on a
    # pg-sized repeat). Iteratively: extend only the FIRST remaining anchor
    # per diagonal, then discard anchors covered by the found runs.
    diag = spos - qpos
    order = np.lexsort((qpos, diag))
    spos, qpos, diag = spos[order], qpos[order], diag[order]
    dedup = np.ones(spos.size, dtype=bool)
    dedup[1:] = (diag[1:] != diag[:-1]) | (qpos[1:] != qpos[:-1])
    spos, qpos, diag = spos[dedup], qpos[dedup], diag[dedup]
    runs = []
    while spos.size:
        first = np.ones(spos.size, dtype=bool)
        first[1:] = diag[1:] != diag[:-1]
        fs, fq = spos[first], qpos[first]
        left = _extend(src, query, fs, fq, direction=-1)
        right = _extend(src, query, fs + ANCHOR_K, fq + ANCHOR_K, direction=+1)
        q0 = fq - left
        s0 = fs - left
        ln = left + ANCHOR_K + right
        runs.append(np.stack([s0, q0, ln], axis=1))
        # drop anchors whose k-mer lies inside a run found on their diagonal
        run_of_anchor = np.cumsum(first) - 1      # index into this pass's runs
        covered = (qpos >= q0[run_of_anchor]) & \
                  (qpos + ANCHOR_K <= q0[run_of_anchor] + ln[run_of_anchor])
        spos, qpos, diag = spos[~covered], qpos[~covered], diag[~covered]
    m = np.concatenate(runs, axis=0)
    m = m[m[:, 2] >= min_len]
    if m.size == 0:
        return np.zeros((0, 3), dtype=np.int64)
    return np.unique(m, axis=0)


def _extend(src, query, spos, qpos, direction: int) -> np.ndarray:
    """Length of the maximal equal run from (spos, qpos) in `direction`
    (exclusive of the anchor). Block-compare rounds, then a final per-symbol
    pass inside the failing block."""
    ns, nq = src.shape[0], query.shape[0]
    ext = np.zeros(spos.shape[0], dtype=np.int64)
    active = np.ones(spos.shape[0], dtype=bool)
    while active.any():
        ai = np.nonzero(active)[0]
        if direction > 0:
            s = spos[ai] + ext[ai]
            q = qpos[ai] + ext[ai]
            room = np.minimum(ns - s, nq - q)
        else:
            s = spos[ai] - ext[ai]
            q = qpos[ai] - ext[ai]
            room = np.minimum(s, q)
        blk = np.minimum(room, EXTEND_BLOCK)
        can = blk > 0
        if not can.any():
            active[ai] = False
            break
        off = np.arange(EXTEND_BLOCK, dtype=np.int64)
        if direction > 0:
            si = s[:, None] + off[None, :]
            qi = q[:, None] + off[None, :]
        else:
            si = s[:, None] - 1 - off[None, :]
            qi = q[:, None] - 1 - off[None, :]
        si = np.clip(si, 0, ns - 1)
        qi = np.clip(qi, 0, nq - 1)
        eq = src[si] == query[qi]
        eq &= off[None, :] < blk[:, None]
        # first inequality position = run length in this block
        run = np.where(eq.all(axis=1), blk, eq.argmin(axis=1))
        run = np.minimum(run, blk)
        ext[ai] += run
        active[ai] = can & (run == blk) & (blk == EXTEND_BLOCK)
    return ext


def _mark_and_remove(
    src: np.ndarray, index, dest: np.ndarray, min_len: int, self_match: bool
):
    """Replace matches of revcomp(dest) vs src, found through `index` (a
    `scan_index` of src), with MARK tokens.

    Returns (new_dest, offsets int64 array, lengths int64 array).
    """
    dest_len = dest.shape[0]
    # (an index of a src shorter than one anchor has no entry)
    if dest_len < min_len or src.shape[0] < ANCHOR_K:
        return dest, np.zeros(0, np.int64), np.zeros(0, np.int64)
    with span(_SCAN[self_match], dest=dest_len) as sp:
        query = dna.COMPL_VAL[dest[::-1]]  # revcomp(dest)
        m, sp.attrs["threads"] = _scan(src, index, query, min_len)
        sp.attrs["runs"] = m.shape[0]
    if m.size == 0:
        return dest, np.zeros(0, np.int64), np.zeros(0, np.int64)
    with span(_SELECT[self_match], matches=m.shape[0]):
        return _select(dest, m, min_len, self_match)


# span names of a mark & remove's two parts, by self_match: the native or
# numpy scan for matches, and the Python selection of the marks
_SCAN = ("pgmatch.scan", "selfmatch.scan")
_SELECT = ("pgmatch.select", "selfmatch.select")


def _scan(src, index, query, min_len: int):
    """The matches of query vs src through `index` (a `scan_index`) and the
    threads the scan took: -> ([M, 3] (src_pos, query_pos, length), n)."""
    if isinstance(index, native.PgIndex):
        threads = native.scan_threads(query.size, ANCHOR_K, DEST_STRIDE)
        return index.find_matches(query, min_len, DEST_STRIDE, CAP * 4, threads), threads
    return _find_matches(src, index, query, min_len), 1


def _select(dest, m, min_len: int, self_match: bool):
    """The greedy non-overlapping selection of `_mark_and_remove`'s matches
    m [M, 3] (src_pos, query_pos, length): -> (new_dest, offsets, lengths)."""
    dest_len = dest.shape[0]
    # convert query coords back to dest coords (reference
    # correctDestPositionDueToRevComplMatching, SimplePgMatcher.cpp:58-61)
    sposs = m[:, 0]
    dpos = dest_len - (m[:, 1] + m[:, 2])
    length = m[:, 2]
    if self_match:
        # canonicalize: source part must precede dest part
        swap = sposs > dpos
        sposs2 = np.where(swap, dpos, sposs)
        dpos = np.where(swap, sposs, dpos)
        sposs = sposs2
        # trim palindromic self-overlap (src run must end before dest starts)
        over = np.maximum(sposs + length - dpos, 0)
        margin = (over + 1) // 2
        length = length - margin
        dpos = dpos + margin
        keepm = (length >= min_len) & (sposs + length <= dpos)
        sposs, dpos, length = sposs[keepm], dpos[keepm], length[keepm]
    order = np.lexsort((sposs, -length, dpos))
    sposs, dpos, length = sposs[order], dpos[order], length[order]
    # greedy non-overlapping selection on dest, with overflow trimming
    # (reference markAndRemoveExactMatches loop, SimplePgMatcher.cpp:104-133)
    out_parts = []
    offs = []
    lens = []
    pos = 0
    for i in range(dpos.shape[0]):
        d, s, ln = int(dpos[i]), int(sposs[i]), int(length[i])
        if d < pos:
            overflow = pos - d
            if overflow >= ln:
                continue
            d += overflow
            ln -= overflow
            # revcomp matching: trimming the dest head trims the src TAIL
            if ln < min_len or (self_match and s + ln > d):
                continue
        if ln < min_len:
            continue
        out_parts.append(dest[pos:d])
        out_parts.append(np.array([MARK], dtype=np.uint8))
        offs.append(s)
        lens.append(ln)
        pos = d + ln
    out_parts.append(dest[pos:])
    new_dest = np.concatenate(out_parts) if out_parts else dest
    return new_dest, np.asarray(offs, dtype=np.int64), np.asarray(lens, dtype=np.int64)


def src_index(src):
    """The sampled k-mer index of a source pg that the numpy scanner
    (`_find_matches`) probes."""
    return align_matcher.build_index(src, k=ANCHOR_K, k1=SRC_STRIDE)


def scan_index(src):
    """The index of a source pg that `_mark_and_remove` scans through, built
    once and shared by every scan against src: the native `PgIndex`, or
    without the native library the numpy scanner's (`src_index`)."""
    index = native.pg_index(src, ANCHOR_K, SRC_STRIDE)
    return index if index is not None else src_index(src)


def self_match_precompute(hq, target_len: int):
    """The hq-self part of stage 7 (index build + hq-vs-hq mark&remove).

    Depends only on the stage-3 pg, so the encoder runs it in a worker
    thread concurrently with the device-bound stage-4 matcher (the native
    scanner releases the GIL); the reference runs the whole of stage 7
    serially at the end (SimplePgMatcher.cpp:175-257). The index
    (`scan_index`) is returned with the marks, for `match_pgs_in_pg`'s LQ
    and N scans against the same pg, which free it."""
    with span("selfmatch", pg=len(hq)):
        index = scan_index(hq)
        return index, _mark_and_remove(hq, index, hq, target_len, True)


def match_pgs_in_pg(hq, lq, npg, target_len: int, pre=None):
    """Returns rewritten (hq, lq, n) and the extra compression jobs
    (offset/length streams per destination, in lq, n, hq order).

    `pre` supplies a self_match_precompute result (index + hq-self marks)
    computed earlier in a worker thread."""
    if pre is None:
        pre = self_match_precompute(hq, target_len)
    index, (hq_new, hq_off, hq_len) = pre
    with span("pgseq.match_lq_n", lq=len(lq), n=len(npg)):
        lq_new, lq_off, lq_len = _mark_and_remove(hq, index, lq, target_len, False)
        n_new, n_off, n_len = _mark_and_remove(hq, index, npg, target_len, False)
    if isinstance(index, native.PgIndex):
        index.close()  # the last scan against hq
    streams = []
    for name, offs, lens in (
        ("lq", lq_off, lq_len), ("n", n_off, n_len), ("hq", hq_off, hq_len)
    ):
        # explicit format tag byte: b'U' = raw u32 LE array, b'V' = varints
        # (the decoder must never sniff the encoding from the byte count)
        if offs.size == 0 or offs.max() <= 0xFFFFFFFF:
            off_blob = b"U" + np.ascontiguousarray(offs, dtype=np.uint32).tobytes()
        else:
            off_blob = b"V" + encode_varints(offs.astype(np.uint64))
        streams.append(props.job("pgmatch_offsets",
                                 f"pgmatch {name} offsets", off_blob))
        streams.append(props.job(
            "pgmatch_lengths", f"pgmatch {name} lengths",
            encode_varints((lens - target_len).astype(np.uint64))))
    return hq_new, lq_new, n_new, streams



def _restore_one(src_getter, dest: np.ndarray, offs, lens) -> np.ndarray:
    """Expand MARK tokens: out = dest with each MARK replaced by
    revcomp(src[off : off + len])."""
    marks = np.nonzero(dest == MARK)[0]
    if not (marks.size == offs.size == lens.size):
        raise PgtcFormatError("pg-match MARK/offset/length count desync")
    parts = []
    pos = 0
    for i, mk in enumerate(marks):
        parts.append(dest[pos:mk])
        seg = src_getter(int(offs[i]), int(lens[i]))
        parts.append(dna.COMPL_VAL[seg[::-1]])
        pos = mk + 1
    parts.append(dest[pos:])
    return np.concatenate(parts) if parts else dest


def restore_matched_pgs(reader: StreamReader, hq, lq, npg, orig_hq_len: int,
                        target_len: int):
    lq_off, lq_len = _read_match_streams(reader, target_len)
    n_off, n_len = _read_match_streams(reader, target_len)
    hq_off, hq_len = _read_match_streams(reader, target_len)
    # hq self-restore: matches reference earlier (already restored) content
    restored = np.zeros(orig_hq_len, dtype=np.uint8)
    rpos = 0
    marks = np.nonzero(hq == MARK)[0]
    if marks.size != hq_off.size:
        raise PgtcFormatError("hq self-match MARK/offset count desync")
    pos = 0
    for i, mk in enumerate(marks):
        seg = hq[pos:mk]
        restored[rpos : rpos + seg.size] = seg
        rpos += seg.size
        ln = int(hq_len[i])
        off = int(hq_off[i])
        src_seg = restored[off : off + ln]
        restored[rpos : rpos + ln] = dna.COMPL_VAL[src_seg[::-1]]
        rpos += ln
        pos = mk + 1
    seg = hq[pos:]
    restored[rpos : rpos + seg.size] = seg
    rpos += seg.size
    hq_full = restored[:rpos]
    getter = lambda o, l: hq_full[o : o + l]  # noqa: E731
    lq_full = _restore_one(getter, lq, lq_off, lq_len)
    n_full = _restore_one(getter, npg, n_off, n_len)
    return hq_full, lq_full, n_full


def _read_match_streams(reader: StreamReader, target_len: int):
    raw_off = reader.read_one()
    raw_len = reader.read_one()
    # lengths are stored target-relative varints (count = number of tokens)
    lens = _decode_all_varints(raw_len) + target_len
    if not raw_off:
        raise PgtcFormatError("pg-match offsets stream is empty")
    tag, body = raw_off[:1], raw_off[1:]
    if tag == b"U":
        if len(body) % 4:
            raise PgtcFormatError("pg-match u32 offsets stream length not 4-aligned")
        offs = np.frombuffer(body, dtype=np.uint32).astype(np.int64)
    elif tag == b"V":
        try:
            offs = decode_varints(body, lens.size).astype(np.int64)
        except (IndexError, ValueError) as e:
            raise PgtcFormatError("pg-match varint offsets truncated") from e
    else:
        raise PgtcFormatError(f"unknown pg-match offsets tag {tag!r}")
    if offs.size != lens.size:
        raise PgtcFormatError("pg-match offset/length stream desync")
    return offs, lens


def _decode_all_varints(buf: bytes) -> np.ndarray:
    if not buf:
        return np.zeros(0, dtype=np.int64)
    data = np.frombuffer(buf, dtype=np.uint8)
    count = int(((data & 0x80) == 0).sum())
    return decode_varints(buf, count).astype(np.int64)


