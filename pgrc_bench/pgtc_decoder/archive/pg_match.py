"""Stage-7 pg-vs-pg matches, decode side: a frozen copy of
`pgrc_tpu_torch/archive/pg_match.py`'s restore functions, unchanged
(the encode side, which needs the port's matcher, is left out).
"""
from __future__ import annotations

import numpy as np

from ..streams.container import StreamReader
from ..streams.varlen_dna import MARK
from ..utils import dna
from ..utils.errors import PgtcFormatError
from ..utils.varint import decode_varints


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


