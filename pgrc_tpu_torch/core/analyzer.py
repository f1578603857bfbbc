"""Reads-set analyzer: one pass computing count/length/alphabet properties.

Fills the ReadsSetAnalyzer role (readsset/tools/ReadsSetAnalyzer.cpp:5-49):
the reference scans the input once to derive read count, min/max/constant
length, the symbol alphabet, and quality presence before choosing packed
representations. Here the scan runs over the chunked reader, so it works
at any input size with bounded memory.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils import dna
from . import fastq


@dataclass
class ReadsSetProperties:
    count: int = 0
    min_len: int = 0
    max_len: int = 0
    constant_len: bool = True
    all_reads_length: int = 0        # the constant length (0 if variable)
    symbols: str = ""                # sorted distinct symbols, e.g. "ACGT"
    contains_n: bool = False
    n_reads: int = 0                 # reads containing at least one N
    has_quality: bool = False
    total_bases: int = 0
    sym_counts: dict = field(default_factory=dict)

    def summary(self) -> str:
        return (
            f"reads: {self.count}\n"
            f"length: {'constant ' + str(self.all_reads_length) if self.constant_len else f'{self.min_len}..{self.max_len}'}\n"
            f"bases: {self.total_bases}\n"
            f"alphabet: {self.symbols}\n"
            f"reads with N: {self.n_reads}\n"
            f"quality: {'yes' if self.has_quality else 'no'}"
        )


def analyze_reads_set(path: str, pair_path: str | None = None) -> ReadsSetProperties:
    """Scan input file(s) chunk-wise and derive set properties."""
    props = ReadsSetProperties()
    counts = np.zeros(5, dtype=np.int64)  # A C G T N
    paths = [path] + ([pair_path] if pair_path else [])
    for p in paths:
        for chunk in fastq.iter_reads_chunked(p):
            n, L = chunk.codes.shape
            props.count += n
            props.total_bases += n * L
            if props.min_len == 0:
                props.min_len = props.max_len = L
            else:
                # the chunked reader enforces constant length inside one
                # file; across files lengths may differ
                props.min_len = min(props.min_len, L)
                props.max_len = max(props.max_len, L)
            counts += np.bincount(chunk.codes.ravel(), minlength=5)[:5]
            props.n_reads += int((chunk.codes == dna.N).any(axis=1).sum())
            props.has_quality = props.has_quality or chunk.quality is not None
    props.constant_len = props.min_len == props.max_len
    props.all_reads_length = props.min_len if props.constant_len else 0
    syms = "ACGTN"
    props.symbols = "".join(s for i, s in enumerate(syms) if counts[i] > 0)
    props.contains_n = counts[4] > 0
    props.sym_counts = {s: int(counts[i]) for i, s in enumerate(syms)}
    return props
