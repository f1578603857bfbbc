"""Variable-length DNA codebook coder, the decoding side (vectorized).

Re-design of the reference's VarLenDNACoder (coders/VarLenDNACoder.cpp):
a codebook of <=256 variable-length strings over the 6-symbol alphabet
{A,C,G,T,N,'%' match-mark} (value codes 0..5) maps each greedy
longest-match token to one output byte. Decoding is a vectorized codebook
concat (cumsum + scatter).

Three tuned codebooks (the reference ships three hand-tuned tables,
VarLenDNACoder.cpp:200-254; ours are designed for this coder's greedy
maxlen-LUT parse, not copied):

  0 "balanced":   6 singles (ACGTN%), 16 ACGT pairs, 64 triples,
                  170 leading ACGT 4-grams = 256 codes
  1 "quad-heavy": 6 singles, 64 triples, 186 4-grams — favors long tokens
                  on low-entropy (match-removed residual) sequence
  2 "penta":      6 singles, 16 pairs, 64 triples, 85 4-grams, 85 5-grams
                  — max token length 5 for highly repetitive sequence

The codebook id is the codec's p1 byte in the stream header.
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


def _dec_luts(codebook_id: int):
    """Decode tables: each code byte's symbols and length."""
    entries = _CODEBOOKS[codebook_id]
    maxlen = _MAXLEN[codebook_id]
    dec_sym = np.zeros((256, maxlen), dtype=np.uint8)
    dec_len = np.zeros(256, dtype=np.uint8)
    for i, e in enumerate(entries):
        dec_len[i] = len(e)
        dec_sym[i, : len(e)] = np.frombuffer(e, dtype=np.uint8)
    return dec_sym, dec_len, maxlen


_LUT_CACHE: dict[int, tuple] = {}


def decode(data: bytes, raw_len: int, codebook_id: int = 0) -> bytes:
    if codebook_id not in _LUT_CACHE:
        _LUT_CACHE[codebook_id] = _dec_luts(codebook_id)
    dec_sym, dec_len, maxlen = _LUT_CACHE[codebook_id]
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
