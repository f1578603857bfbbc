"""The benchmark's reference: is each archive the timed encodes wrote lossless?

PgRC's guarantee for its SE and PE modes (without `-o`) is that decoding
gives back the input's reads as a multiset, of reads in SE and of pairs
(mate 1, mate 2) in PE, each base exact. The reference decodes an archive
with the frozen decoder copy in `pgtc_decoder` and counts the reads (or
pairs) by which the decoded multiset and the input's differ: every read the
input has that the decode lacks, and every read the decode has that the
input lacks. A lossless archive reads 0.

Plain NumPy: it reads the input FASTQ files the program read and the
archive files the program wrote, and nothing else of the program's.
"""
from __future__ import annotations

import numpy as np

from .pgtc_decoder.archive import decoder

_SYM2VAL = np.full(256, 4, dtype=np.uint8)
for _v, _s in enumerate(b"ACGT"):
    _SYM2VAL[_s] = _v


def fastq_codes(path: str) -> np.ndarray:
    """The sequence lines of a FASTQ file of one read length as [n, L]
    uint8 codes (A C G T N = 0..4). Records that follow each other at one
    stride (ids of one number of digits) are read as one strided view."""
    data = np.fromfile(path, dtype=np.uint8)
    nl = np.flatnonzero(data == ord("\n"))
    if nl.size % 4:
        raise ValueError(f"{path}: {nl.size} lines, not whole records")
    starts = nl[0::4] + 1
    lens = nl[1::4] - starts
    L = int(lens[0]) if lens.size else 0
    if (lens != L).any():
        raise ValueError(f"{path}: reads of more than one length")
    out = np.empty((starts.size, L), dtype=np.uint8)
    if not starts.size:
        return out
    steps = np.diff(starts)
    cuts = np.concatenate([[0], np.flatnonzero(np.diff(steps)) + 1, [steps.size]])
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        # rows lo..hi (inclusive) lie steps[lo] bytes apart
        rows = np.lib.stride_tricks.as_strided(
            data[starts[lo]:], shape=(hi - lo + 1, L), strides=(int(steps[lo]) if hi > lo else 1, 1))
        out[lo : hi + 1] = _SYM2VAL[rows]
    return out


def keys(mats: list[np.ndarray]) -> np.ndarray:
    """One key a read (one matrix) or a pair (two: mate 1 then mate 2):
    its codes as a fixed-width byte string, equal where the reads are."""
    rows = np.ascontiguousarray(np.hstack(mats) if len(mats) > 1 else mats[0])
    return rows.view(np.dtype((np.void, max(rows.shape[1], 1)))).ravel()


def multiset_difference(a_sorted: np.ndarray, b_sorted: np.ndarray) -> int:
    """How many keys the two multisets (each sorted) differ by: the keys of
    `a` that `b` lacks plus those of `b` that `a` lacks, counted with their
    multiplicity."""
    if a_sorted.dtype != b_sorted.dtype:
        return a_sorted.size + b_sorted.size
    if a_sorted.size == b_sorted.size and np.array_equal(a_sorted.view(np.uint8),
                                                         b_sorted.view(np.uint8)):
        return 0
    both = np.concatenate([a_sorted, b_sorted])
    side = np.concatenate([np.ones(a_sorted.size, np.int64), -np.ones(b_sorted.size, np.int64)])
    order = np.argsort(both, kind="stable")
    rows = both[order]
    new = np.ones(rows.size, dtype=bool)
    new[1:] = rows[1:] != rows[:-1]
    net = np.bincount(np.cumsum(new) - 1, weights=side[order])
    return int(np.abs(net).sum())


def input_keys(files: list[str]) -> np.ndarray:
    """The input's sorted keys: of each read (one file), or of each pair
    (two files)."""
    return np.sort(keys([fastq_codes(p) for p in files]))


def archive_keys(path: str, files: int) -> np.ndarray:
    """The sorted keys of the reads (or pairs) the archive decodes to."""
    mats = decoder.decode_to_matrices(decoder.load(path))
    if len(mats) != files:
        raise ValueError(f"archive decodes to {len(mats)} files, the input has {files}")
    if len({m.shape[0] for m in mats}) != 1:
        raise ValueError("the decoded files hold different numbers of reads")
    return np.sort(keys(mats))


def judge(path: str, want: np.ndarray, files: int) -> int:
    """Reads (or pairs) by which the archive's decode differs from the input."""
    return multiset_difference(want, archive_keys(path, files))


def native_ready() -> bool:
    """Whether the decoder copy's native library is built and loads: its
    Python fallbacks would take minutes on an archive of millions of reads."""
    from .pgtc_decoder import native

    return native.get_lib() is not None
