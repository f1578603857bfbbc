"""The benchmark's reference: does each archive the timed encodes wrote keep
the guarantee of the mode its configuration asks for?

PgRC's modes (`-o`, `-s` / `-I`, `-S` and whether the input is paired pick
one, by PgRC's own precedence: `Guarantee.of`) each promise the input's
reads back, every base exact, and differ in what else they keep:

    mode     configuration                 compared                         in order
    SE       unpaired; or paired with -S   reads (of both files, with -S)   no
    PE       paired                        pairs (mate 1, mate 2)           no
    MIN_PE   paired, -s or -I              pairs, mates in either order     no
    SE_ORD   unpaired, -o                  reads                            yes
    PE_ORD   paired, -o                    pairs (mate 1, mate 2)           yes

The reference decodes an archive with the frozen decoder copy in
`pgtc_decoder` and checks, each a count that a sound archive reads 0 in:

- the header's mode byte is the configuration's (else `ModeMismatch`: an
  archive of a weaker mode is never judged by a weaker rule);
- `reads_differ`: the reads (or pairs) by which the decoded multiset and the
  input's differ: every one the input has that the decode lacks, and every
  one the decode has that the input lacks;
- `reads_out_of_order`, in the order-keeping modes only: the indices `i` at
  which decoded read (pair) `i` is not input read (pair) `i`.

Plain NumPy: it reads the input FASTQ files the program read and the
archive files the program wrote, and nothing else of the program's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from .pgtc_decoder.archive import decoder

# the header's mode byte, by name
MODES = {0: "SE", 1: "PE", 2: "SE_ORD", 3: "PE_ORD", 4: "MIN_PE"}

_SYM2VAL = np.full(256, 4, dtype=np.uint8)
for _v, _s in enumerate(b"ACGT"):
    _SYM2VAL[_s] = _v


@dataclass(frozen=True)
class Guarantee:
    """What an archive of one mode gives back of its input."""
    mode: str        # the header's mode, a name of MODES
    inputs: int      # input files: 2 for paired input
    unit: str        # "reads": each read alone; "pairs": (mate 1, mate 2);
                     # "unordered pairs": a pair's two mates in either order
    in_order: bool   # decoded read (pair) i is input read (pair) i

    @property
    def outputs(self) -> int:
        """The files the archive decodes to."""
        return 1 if self.unit == "reads" else 2

    @classmethod
    def of(cls, paired: bool, preserve_order: bool = False, single_reads: bool = False,
           ignore_pair_order: bool = False) -> Guarantee:
        """The guarantee of PgRC's flags, by its precedence (PgRCParams::mode):
        `-S` first, then `-o`, then `-s` / `-I`; unpaired input without `-o`
        is SE."""
        inputs = 2 if paired else 1
        if single_reads or not (paired or preserve_order):
            return cls("SE", inputs, "reads", False)
        if preserve_order:
            return cls("PE_ORD", 2, "pairs", True) if paired else cls("SE_ORD", 1, "reads", True)
        if ignore_pair_order:
            return cls("MIN_PE", 2, "unordered pairs", False)
        return cls("PE", 2, "pairs", False)


class Expected(NamedTuple):
    """The input by a guarantee's rule: its keys sorted, and in file order
    where the guarantee keeps the order (else None)."""
    keys: np.ndarray
    in_order: np.ndarray | None


class ModeMismatch(ValueError):
    """The archive's header names another mode than its configuration's."""


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


def lower_first(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each pair (a[i], b[i]) with its lexicographically lower read first:
    the same for a pair and its mates swapped."""
    diff = a != b
    first = diff.argmax(axis=1)
    rows = np.arange(a.shape[0])
    swap = (a[rows, first] > b[rows, first])[:, None]
    return np.where(swap, b, a), np.where(swap, a, b)


def unit_keys(mats: list[np.ndarray], g: Guarantee) -> np.ndarray:
    """The keys of the reads or pairs in `mats` (the input's files, or the
    files an archive decodes to), in file order, by the guarantee's rule."""
    if g.unit == "reads":
        return keys([np.concatenate(mats) if len(mats) > 1 else mats[0]])
    if len({m.shape[0] for m in mats}) != 1:
        raise ValueError("the two files hold different numbers of reads")
    if g.unit == "unordered pairs":
        return keys(list(lower_first(*mats)))
    return keys(mats)


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


def out_of_order(want: np.ndarray, got: np.ndarray) -> int:
    """The indices i at which key i of `got` is not key i of `want` (both in
    file order); an index that only one of them has counts too."""
    if want.dtype != got.dtype:
        return max(want.size, got.size)
    n = min(want.size, got.size)
    w = want.dtype.itemsize
    a = want[:n].view(np.uint8).reshape(n, w)
    b = got[:n].view(np.uint8).reshape(n, w)
    return int((a != b).any(axis=1).sum()) + abs(want.size - got.size)


def expected(files: list[str], g: Guarantee) -> Expected:
    """The input's keys by the guarantee's rule."""
    k = unit_keys([fastq_codes(p) for p in files], g)
    return Expected(np.sort(k), k if g.in_order else None)


def input_keys(files: list[str]) -> np.ndarray:
    """The input's sorted keys: of each read (one file), or of each pair
    (two files)."""
    return expected(files, Guarantee.of(paired=len(files) == 2)).keys


def verdict(path: str, want: Expected, g: Guarantee) -> dict[str, int]:
    """The archive's checks under the guarantee: `reads_differ`, and where
    the guarantee keeps the order `reads_out_of_order`. Raises ModeMismatch
    where the archive's mode is not the guarantee's."""
    ar = decoder.load(path)
    mode = MODES.get(ar.mode, f"unknown ({ar.mode})")
    if mode != g.mode:
        raise ModeMismatch(f"the archive's mode is {mode}, its configuration's {g.mode}")
    mats = decoder.decode_to_matrices(ar)
    if len(mats) != g.outputs:
        raise ValueError(f"archive decodes to {len(mats)} files, {g.mode} to {g.outputs}")
    got = unit_keys(mats, g)
    out = {"reads_differ": multiset_difference(want.keys, np.sort(got))}
    if g.in_order:
        if want.in_order is None:
            raise ValueError(f"{g.mode} needs the input's keys in file order")
        out["reads_out_of_order"] = out_of_order(want.in_order, got)
    return out


def judge(path: str, want: np.ndarray, files: int, guarantee: Guarantee | None = None) -> int:
    """Reads (or pairs) by which the archive's decode differs from the input
    (`want`, its sorted keys), under a guarantee that does not keep the
    order; by default SE's for one input file, PE's for two."""
    g = guarantee or Guarantee.of(paired=files == 2)
    return verdict(path, Expected(want, None), g)["reads_differ"]


def native_ready() -> bool:
    """Whether the decoder copy's native library is built and loads: its
    Python fallbacks would take minutes on an archive of millions of reads."""
    from .pgtc_decoder import native

    return native.get_lib() is not None
