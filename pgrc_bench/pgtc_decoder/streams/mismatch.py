"""Mismatch-stream decomposition, the decoding side (the reference's v1.3
scheme, re-designed vectorized).

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


def merge_by_count(mis_cnt: np.ndarray, streams: list[bytes], dtype,
                   limit: int = COUNT_STREAM_LIMIT) -> np.ndarray:
    """The flat per-read value stream from its substreams by the read's
    mismatch count: exact streams for m = 1..limit-1 (stored transposed:
    all 1st values, then all 2nd values, ...), plus one pooled stream for
    m >= limit (read-major)."""
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
