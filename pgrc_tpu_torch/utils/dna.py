"""DNA symbol tables and mismatch codes (numpy, host side).

Covers the reference's LUT utilities (utils/helper.cpp:247-407): symbol<->value
maps, reverse complement, the exclusive 3-value mismatch code and the 4-bit
context mismatch code, and the quality-score->correct-probability table.
Symbol order is fixed to "ACGTN" (values 0..4); unlike the reference we do not
reorder values per archive (reorderSymAndVal) — our archive stores raw code
bytes and lets the entropy layer model their distribution.
"""
from __future__ import annotations

import numpy as np

SYMBOLS = b"ACGTN"
A, C, G, T, N = range(5)

# symbol byte -> value (0..4); unknown bytes map to N's value.
SYM2VAL = np.full(256, N, dtype=np.uint8)
for _v, _s in enumerate(SYMBOLS):
    SYM2VAL[_s] = _v
    SYM2VAL[ord(chr(_s).lower())] = _v

VAL2SYM = np.frombuffer(SYMBOLS, dtype=np.uint8).copy()

# value -> complement value (A<->T, C<->G, N->N)
COMPL_VAL = np.array([T, G, C, A, N], dtype=np.uint8)

# quality score (phred+33) -> probability the base call is correct
# (reference utils/helper.cpp:284-326: 1 - 10^(-q/10), clamped to 1 at q>=41)
_q = np.arange(0, 100, dtype=np.float64)
_p = 1.0 - np.power(10.0, -_q / 10.0)
_p[41:] = 1.0
QUALITY2PROB = np.zeros(256, dtype=np.float64)
QUALITY2PROB[33:133] = _p


def seq_to_codes(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII DNA -> uint8 value codes."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    return SYM2VAL[arr]


def codes_to_seq(codes: np.ndarray) -> bytes:
    """uint8 value codes -> ASCII DNA bytes."""
    return VAL2SYM[codes].tobytes()


def revcomp_codes(codes: np.ndarray, axis: int = -1) -> np.ndarray:
    """Reverse complement along `axis` (value-code domain)."""
    return COMPL_VAL[np.flip(codes, axis=axis)]


def mismatch_to_code(actual: np.ndarray, mismatch: np.ndarray) -> np.ndarray:
    """Exclusive mismatch code: the mismatching value with the actual value's
    slot removed (reference mismatch2code, utils/helper.cpp:347-351)."""
    actual = actual.astype(np.int16)
    mismatch = mismatch.astype(np.int16)
    return (mismatch - (mismatch > actual)).astype(np.uint8)


def code_to_mismatch(actual: np.ndarray, code: np.ndarray) -> np.ndarray:
    """Inverse of mismatch_to_code (reference code2mismatch)."""
    actual = actual.astype(np.int16)
    code = code.astype(np.int16)
    return np.where(code < actual, code, code + 1).astype(np.uint8)


def mismatch_to_cxt_code(actual: np.ndarray, mismatch: np.ndarray) -> np.ndarray:
    """Context mismatch code (actual<<4)|mismatch (reference mismatch2CxtCode)."""
    return ((actual.astype(np.uint8) << 4) | mismatch.astype(np.uint8)).astype(np.uint8)


def cxt_code_split(code: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return (code >> 4).astype(np.uint8), (code & 0x0F).astype(np.uint8)
