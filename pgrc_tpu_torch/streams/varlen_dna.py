"""Variable-length DNA codebook coder (vectorized).

Re-design of the reference's VarLenDNACoder (coders/VarLenDNACoder.cpp):
a codebook of <=256 variable-length strings over the 6-symbol alphabet
{A,C,G,T,N,'%' match-mark} (value codes 0..5) maps each greedy
longest-match token to one output byte.

Unlike the reference's sequential 27-bit-LUT parse loop (VarLenDNACoder.cpp:
greedy encode), the greedy parse here is extracted with *pointer doubling*:
token length at every position comes from a vectorized LUT lookup, giving a
jump array next[i] = i + len(i); positions visited by the parse starting at 0
are then marked in O(log n) scatter rounds. Decoding is a fully vectorized
codebook concat (cumsum + scatter).

Three tuned codebooks (the reference ships three hand-tuned tables,
VarLenDNACoder.cpp:200-254; ours are designed for this coder's greedy
maxlen-LUT parse, not copied):

  0 "balanced":   6 singles (ACGTN%), 16 ACGT pairs, 64 triples,
                  170 leading ACGT 4-grams = 256 codes
  1 "quad-heavy": 6 singles, 64 triples, 186 4-grams — favors long tokens
                  on low-entropy (match-removed residual) sequence
  2 "penta":      6 singles, 16 pairs, 64 triples, 85 4-grams, 85 5-grams
                  — max token length 5 for highly repetitive sequence

The codebook id is the codec's p1 byte in the stream header, so encoders
can probe all books and keep the smallest (per-stream selection).
"""
from __future__ import annotations

import numpy as np

NSYM = 6  # A C G T N %
MARK = 5  # '%' value code


def _grams(ln: int) -> list[bytes]:
    out = [b""]
    for _ in range(ln):
        out = [e + bytes([s]) for e in out for s in range(4)]
    return out


def _build_codebook0():
    entries: list[bytes] = [bytes([s]) for s in range(NSYM)]
    entries.extend(_grams(2))
    entries.extend(_grams(3))
    entries.extend(_grams(4)[: 256 - len(entries)])
    assert len(entries) == 256
    return entries


def _build_codebook1():
    entries: list[bytes] = [bytes([s]) for s in range(NSYM)]
    entries.extend(_grams(3))
    entries.extend(_grams(4)[: 256 - len(entries)])
    assert len(entries) == 256
    return entries


def _build_codebook2():
    entries: list[bytes] = [bytes([s]) for s in range(NSYM)]
    entries.extend(_grams(2))
    entries.extend(_grams(3))
    entries.extend(_grams(4)[:85])
    entries.extend(_grams(5)[: 256 - len(entries)])
    assert len(entries) == 256
    return entries


_CODEBOOKS = {0: _build_codebook0(), 1: _build_codebook1(),
              2: _build_codebook2()}
_MAXLEN = {0: 4, 1: 4, 2: 5}
CODEBOOK_IDS = tuple(sorted(_CODEBOOKS))


def _luts(codebook_id: int):
    """Greedy-parse LUTs: for every maxlen-gram key, the longest codebook
    entry that is a prefix of it, as (code byte, length)."""
    entries = _CODEBOOKS[codebook_id]
    maxlen = _MAXLEN[codebook_id]
    by_str = {e: i for i, e in enumerate(entries)}
    keys = NSYM ** maxlen
    code_lut = np.zeros(keys, dtype=np.uint8)
    len_lut = np.zeros(keys, dtype=np.uint8)
    digits = np.zeros((keys, maxlen), dtype=np.uint8)
    k = np.arange(keys)
    for j in range(maxlen):
        digits[:, maxlen - 1 - j] = k % NSYM
        k = k // NSYM
    for key in range(keys):
        g = digits[key]
        for ln in range(maxlen, 0, -1):
            e = bytes(g[:ln])
            if e in by_str:
                code_lut[key] = by_str[e]
                len_lut[key] = ln
                break
    # decode tables
    dec_sym = np.zeros((256, maxlen), dtype=np.uint8)
    dec_len = np.zeros(256, dtype=np.uint8)
    for i, e in enumerate(entries):
        dec_len[i] = len(e)
        dec_sym[i, : len(e)] = np.frombuffer(e, dtype=np.uint8)
    return code_lut, len_lut, dec_sym, dec_len, maxlen


_LUT_CACHE: dict[int, tuple] = {}


def _get_luts(codebook_id: int):
    if codebook_id not in _LUT_CACHE:
        _LUT_CACHE[codebook_id] = _luts(codebook_id)
    return _LUT_CACHE[codebook_id]


def encode(data: bytes, codebook_id: int = 0) -> bytes:
    """data: value-code bytes (0..5) -> one byte per greedy token."""
    code_lut, len_lut, _, _, maxlen = _get_luts(codebook_id)
    vals = np.frombuffer(data, dtype=np.uint8)
    n = vals.size
    if n == 0:
        return b""
    if vals.max() >= NSYM:
        raise ValueError("varlen_dna input must be value codes 0..5")
    # maxlen-gram key at every position (tail padded with 0s)
    pad = np.concatenate([vals.astype(np.int64),
                          np.zeros(maxlen - 1, dtype=np.int64)])
    key = pad[:n].copy()
    for j in range(1, maxlen):
        key *= NSYM
        key += pad[j : j + n]
    tok_len = len_lut[key].astype(np.int64)
    tok_code = code_lut[key]
    # Tail fix-up: the last <maxlen positions may have matched an entry that
    # runs past the end (their keys include padding). Re-parse them greedily
    # against the codebook dict (all singles are present, so a parse always
    # exists).
    entries = _CODEBOOKS[codebook_id]
    by_str = {e: i for i, e in enumerate(entries)}
    for i in range(max(0, n - maxlen + 1), n):
        room = n - i
        if tok_len[i] <= room:
            continue
        for ln in range(min(maxlen, room), 0, -1):
            e = vals[i : i + ln].tobytes()
            if e in by_str:
                tok_len[i] = ln
                tok_code[i] = by_str[e]
                break
    nxt = np.minimum(np.arange(n) + tok_len, n)
    # pointer doubling: mark positions visited by the parse chain from 0
    visited = np.zeros(n + 1, dtype=bool)
    visited[0] = True
    jump = np.concatenate([nxt, [n]])
    while True:
        new = np.zeros(n + 1, dtype=bool)
        vis_idx = np.nonzero(visited)[0]
        new[jump[vis_idx]] = True
        grew = new & ~visited
        visited |= new
        if not grew[:n].any():
            break
        jump = jump[jump]
    out_pos = np.nonzero(visited[:n])[0]
    return tok_code[out_pos].tobytes()


def decode(data: bytes, raw_len: int, codebook_id: int = 0) -> bytes:
    _, _, dec_sym, dec_len, maxlen = _get_luts(codebook_id)
    codes = np.frombuffer(data, dtype=np.uint8)
    lens = dec_len[codes].astype(np.int64)
    ends = np.cumsum(lens)
    starts = ends - lens
    total = int(ends[-1]) if codes.size else 0
    out = np.zeros(total, dtype=np.uint8)
    for j in range(maxlen):
        mask = lens > j
        out[starts[mask] + j] = dec_sym[codes[mask], j]
    if total != raw_len:
        raise ValueError(f"varlen_dna decode length mismatch: {total} != {raw_len}")
    return out.tobytes()
