"""Stage-7 pg-vs-pg exact matching (SimplePgMatcher re-design).

Finds long (>= target_match_length) exact matches of the lq / N / hq-self
pseudogenomes against the hq pg under reverse-complement matching, replaces
them with a MARK token + (source offset, length) streams, and restores them
on decode — the TPU-friendly equivalent of matching/SimplePgMatcher.cpp:
69-148 (markAndRemoveExactMatches), :160-173 (self collision resolution),
:259-351 (restore).

The matches are found by the native scanner (`native.PgIndex`,
native/pgmatch.cpp): one sampled k-mer index of the hq pg, built once and
scanned by every query on threads.
"""
from __future__ import annotations

import numpy as np

from .. import native
from ..streams import props
from ..streams.container import StreamReader
from ..streams.varlen_dna import MARK
from ..utils import dna
from ..utils.errors import PgtcFormatError
from ..utils.trace import span
from ..utils.varint import encode_varints, decode_varints

# copMEM sampling guarantee (CopMEMMatcher.cpp:111-137): with coprime strides
# k1 (source) and k2 (query), every exact match of length >= k + k1*k2 - 1
# contains a sampled source k-mer aligned with a probed query k-mer (CRT on
# the diagonal). 24 + 7*3 - 1 = 44 <= default target length 45.
ANCHOR_K = 24
SRC_STRIDE = 7
DEST_STRIDE = 3
CAP = 4


def _mark_and_remove(
    src: np.ndarray, index, dest: np.ndarray, min_len: int, self_match: bool
):
    """Replace matches of revcomp(dest) vs src, found through `index` (the
    `scan_index` of src), with MARK tokens.

    Returns (new_dest, offsets int64 array, lengths int64 array).
    """
    dest_len = dest.shape[0]
    # (an index of a src shorter than one anchor has no entry)
    if dest_len < min_len or src.shape[0] < ANCHOR_K:
        return dest, np.zeros(0, np.int64), np.zeros(0, np.int64)
    with span(_SCAN[self_match], dest=dest_len) as sp:
        query = dna.COMPL_VAL[dest[::-1]]  # revcomp(dest)
        threads = native.scan_threads(query.size, ANCHOR_K, DEST_STRIDE)
        m = index.find_matches(query, min_len, DEST_STRIDE, CAP * 4, threads)
        sp.attrs.update(threads=threads, runs=m.shape[0])
    if m.size == 0:
        return dest, np.zeros(0, np.int64), np.zeros(0, np.int64)
    with span(_SELECT[self_match], matches=m.shape[0]):
        return _select(dest, m, min_len, self_match)


# span names of a mark & remove's two parts, by self_match: the native
# scan for matches, and the Python selection of the marks
_SCAN = ("pgmatch.scan", "selfmatch.scan")
_SELECT = ("pgmatch.select", "selfmatch.select")


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


def scan_index(src):
    """The native `PgIndex` of a source pg that `_mark_and_remove` scans
    through, built once and shared by every scan against src."""
    return native.pg_index(src, ANCHOR_K, SRC_STRIDE)


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


