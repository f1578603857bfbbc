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


# positions whose tokens one step of `encode` finds and marks at once: the
# working set is a few 4-byte words a position of one block, not six 8-byte
# words a position of the whole stream (a pg of tens of millions of symbols)
_BLOCK = 1 << 20


def encode(data: bytes, codebook_id: int = 0) -> bytes:
    """data: value-code bytes (0..5) -> one byte per greedy token.

    The stream is parsed a block of `_BLOCK` positions at a time: the
    parse enters a block where the last token of the block before it ends,
    and within the block it is marked by pointer doubling, as over the
    whole stream; the tokens are the same, so are the bytes."""
    code_lut, len_lut, _, _, maxlen = _get_luts(codebook_id)
    vals = np.frombuffer(data, dtype=np.uint8)
    n = vals.size
    if n == 0:
        return b""
    if vals.max() >= NSYM:
        raise ValueError("varlen_dna input must be value codes 0..5")
    entries = _CODEBOOKS[codebook_id]
    by_str = {e: i for i, e in enumerate(entries)}
    out = []
    start = 0   # where the parse's next token starts
    for lo in range(0, n, _BLOCK):
        hi = min(lo + _BLOCK, n)
        if start >= hi:
            continue
        tok_len, tok_code = _block_tokens(vals, lo, hi, code_lut, len_lut, maxlen, by_str)
        vis = _parse_marks(tok_len, start - lo)
        out.append(tok_code[vis])
        start = lo + int(vis[-1]) + int(tok_len[vis[-1]])
    return b"".join(a.tobytes() for a in out)


def _block_tokens(vals, lo: int, hi: int, code_lut, len_lut, maxlen: int, by_str):
    """(tok_len int32, tok_code uint8) of the greedy token at every position
    lo..hi-1: the maxlen-gram key (past the stream's end padded with 0s)
    through the LUTs."""
    n, m = vals.size, hi - lo
    seg = np.zeros(m + maxlen - 1, dtype=np.int32)
    tail = vals[lo:min(hi + maxlen - 1, n)]
    seg[:tail.size] = tail
    key = seg[:m].copy()
    for j in range(1, maxlen):
        key *= NSYM
        key += seg[j : j + m]
    tok_len = len_lut[key].astype(np.int32)
    tok_code = code_lut[key]
    # Tail fix-up: the last <maxlen positions may have matched an entry that
    # runs past the end (their keys include padding). Re-parse them greedily
    # against the codebook dict (all singles are present, so a parse always
    # exists).
    for i in range(max(lo, n - maxlen + 1), hi):
        room = n - i
        if tok_len[i - lo] <= room:
            continue
        for ln in range(min(maxlen, room), 0, -1):
            e = vals[i : i + ln].tobytes()
            if e in by_str:
                tok_len[i - lo] = ln
                tok_code[i - lo] = by_str[e]
                break
    return tok_len, tok_code


def _parse_marks(tok_len, s: int):
    """Positions of a block visited by the greedy parse that enters it at
    position s (block-local), ascending: pointer doubling, positions past
    the block folded into a sentinel."""
    m = tok_len.size
    jump = np.empty(m + 1, dtype=np.int32)
    np.minimum(np.arange(m, dtype=np.int32) + tok_len, m, out=jump[:m])
    jump[m] = m
    visited = np.zeros(m + 1, dtype=bool)
    visited[s] = True
    while True:
        new = np.zeros(m + 1, dtype=bool)
        new[jump[np.nonzero(visited)[0]]] = True
        grew = new & ~visited
        visited |= new
        if not grew[:m].any():
            break
        jump = jump[jump]
    return np.nonzero(visited[:m])[0]


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
