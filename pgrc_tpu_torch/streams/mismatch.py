"""Mismatch-stream decomposition (the reference's v1.3 scheme, re-designed
vectorized).

Mirrors the information layout of:
  * zero/non-zero mismatch-count split (SeparatedPseudoGenomePersistence.cpp
    toStringAndSeparateZeros + loader SeparatedExtendedReadsList.cpp:255-259)
  * exclusive mismatched-symbol codes with global frequency reordering
    (utils/helper.cpp:347-377 mismatch2code, reorderSymAndVal :379-407)
  * reversed delta-from-end offset coding (utils/helper.h:51-63
    convertMisRevOffsets2Offsets) split into per-mismatch-count substreams
    with fixed-count streams transposed (SeparatedPseudoGenomePersistence.cpp
    :830-905)

All transforms are numpy-vectorized; per-read loops are replaced by flat
segment index arithmetic.
"""
from __future__ import annotations

import numpy as np

COUNT_STREAM_LIMIT = 6  # reads with >= LIMIT mismatches pool into one stream


# ---------------------------------------------------------------------------
# exclusive symbol codes
# ---------------------------------------------------------------------------


def symbol_order(read_vals: np.ndarray) -> np.ndarray:
    """Global mismatched-symbol value order, most frequent first (the
    reorderSymAndVal role): [5] uint8 permutation of values 0..4."""
    freq = np.bincount(read_vals, minlength=5)
    return np.argsort(-freq, kind="stable").astype(np.uint8)


def exclusive_encode(pg_vals: np.ndarray, read_vals: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Code each mismatch as the rank of its read symbol among the values
    != pg symbol, ranked by the global `order` (code 0..3; a mismatch never
    equals the pg symbol, so one value is excluded)."""
    rank = np.empty(5, dtype=np.int8)
    rank[order] = np.arange(5, dtype=np.int8)
    rr = rank[read_vals]
    return (rr - (rr > rank[pg_vals])).astype(np.uint8)


def exclusive_decode_lut(order: np.ndarray) -> np.ndarray:
    """[5, 4] uint8 LUT: lut[pg_val, code] -> read value."""
    rank = np.empty(5, dtype=np.int64)
    rank[order] = np.arange(5)
    lut = np.zeros((5, 4), dtype=np.uint8)
    for a in range(5):
        vals = sorted((v for v in range(5) if v != a), key=lambda v: rank[v])
        for c, v in enumerate(vals):
            lut[a, c] = v
    return lut


# ---------------------------------------------------------------------------
# reversed delta-from-end offsets
# ---------------------------------------------------------------------------


def _segment_layout(mis_cnt: np.ndarray):
    cnt = mis_cnt.astype(np.int64)
    cum = np.zeros(cnt.size + 1, dtype=np.int64)
    np.cumsum(cnt, out=cum[1:])
    total = int(cum[-1])
    read_of = np.repeat(np.arange(cnt.size, dtype=np.int64), cnt)
    within = np.arange(total, dtype=np.int64) - cum[read_of]
    return cnt, cum, total, read_of, within


def rev_offset_encode(mis_cnt: np.ndarray, flat_off: np.ndarray, read_len: int) -> np.ndarray:
    """offsets (ascending per read) -> reversed gap-from-end coding: the
    stored stream per read is [L-1-off[m-1], off[m-1]-off[m-2]-1, ...,
    off[1]-off[0]-1] (the inverse of convertMisRevOffsets2Offsets)."""
    if flat_off.size == 0:
        return np.zeros(0, dtype=np.uint8)
    cnt, cum, total, read_of, within = _segment_layout(mis_cnt)
    off = flat_off.astype(np.int64)
    # gap[j] = off[j+1]-off[j]-1 for j < m-1; last slot = L-1-off[m-1]
    gaps = np.empty(total, dtype=np.int64)
    gaps[:-1] = off[1:] - off[:-1] - 1
    is_last = within == (cnt[read_of] - 1)
    gaps[is_last] = read_len - 1 - off[is_last]
    # reverse within each read: stored[cum + (m-1-j)] = gaps[cum + j]
    dst = cum[read_of] + (cnt[read_of] - 1 - within)
    stored = np.empty(total, dtype=np.int64)
    stored[dst] = gaps
    return stored.astype(np.uint8 if read_len <= 256 else np.uint16)


def rev_offset_decode(mis_cnt: np.ndarray, stored: np.ndarray, read_len: int) -> np.ndarray:
    """Inverse of rev_offset_encode: stored gap stream -> ascending offsets."""
    if stored.size == 0:
        return np.zeros(0, dtype=np.uint8 if read_len <= 256 else np.uint16)
    cnt, cum, total, read_of, within = _segment_layout(mis_cnt)
    s = stored.astype(np.int64)
    # un-reverse, then offsets from the end: off[j] = L - sum_{t>=j}(gap[t]+1)
    gaps = np.empty(total, dtype=np.int64)
    gaps[cum[read_of] + (cnt[read_of] - 1 - within)] = s
    csum = np.cumsum(gaps + 1)
    seg_end = csum[cum[1:][cnt > 0] - 1]  # inclusive total per nonzero read
    run_base = np.zeros(total, dtype=np.int64)
    nz_first = cum[:-1][cnt > 0]
    run_base[nz_first[1:]] = seg_end[:-1]
    run_base = np.maximum.accumulate(run_base)
    suffix_sum_excl = csum - (gaps + 1) - run_base  # sum of earlier gaps in read
    seg_total = np.repeat(seg_end - np.concatenate([[0], seg_end[:-1]]), cnt[cnt > 0])
    off = read_len - (seg_total - suffix_sum_excl)
    return off.astype(np.uint8 if read_len <= 256 else np.uint16)


# ---------------------------------------------------------------------------
# per-mismatch-count substreams
# ---------------------------------------------------------------------------


def split_by_count(mis_cnt: np.ndarray, flat_vals: np.ndarray,
                   limit: int = COUNT_STREAM_LIMIT) -> list[bytes]:
    """Split the flat per-read value stream into substreams by the read's
    mismatch count: exact streams for m = 1..limit-1 (stored transposed:
    all 1st values, then all 2nd values, ...), plus one pooled stream for
    m >= limit (read-major). Returns `limit` byte strings."""
    cnt, cum, total, read_of, within = _segment_layout(mis_cnt)
    m_of = cnt[read_of]
    out = []
    for m in range(1, limit):
        sel = m_of == m
        vals = flat_vals[sel]
        if m > 1 and vals.size:
            vals = vals.reshape(-1, m).T.copy()  # transpose: column-major
        out.append(vals.tobytes())
    out.append(flat_vals[m_of >= limit].tobytes())
    return out


def merge_by_count(mis_cnt: np.ndarray, streams: list[bytes], dtype,
                   limit: int = COUNT_STREAM_LIMIT) -> np.ndarray:
    """Inverse of split_by_count."""
    cnt, cum, total, read_of, within = _segment_layout(mis_cnt)
    m_of = cnt[read_of]
    flat = np.zeros(total, dtype=dtype)
    for m in range(1, limit):
        sel = m_of == m
        vals = np.frombuffer(streams[m - 1], dtype=dtype)
        if m > 1 and vals.size:
            vals = vals.reshape(m, -1).T.reshape(-1)
        flat[sel] = vals
    sel = m_of >= limit
    flat[sel] = np.frombuffer(streams[limit - 1], dtype=dtype)
    return flat
