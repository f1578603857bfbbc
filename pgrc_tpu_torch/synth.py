"""Synthetic FASTQ input of the benchmark: a copy of bench.py's
`synth_fastq` (:34-91) with only its import changed, so the port's smoke
run makes bench.py's inputs (same seeds, same bytes) without importing
bench.py, which imports `pgrc_tpu`.
"""
from __future__ import annotations

import numpy as np


def synth_fastq(path, n_reads, read_len, genome_len, seed=0, pair=None,
                repeats=False):
    """Synthetic WGS-like FASTQ; with `pair`, writes a mate file whose reads
    are sampled nearby on the genome (insert ~300) for PE benching.

    With `repeats`, the genome gets realistic repeat structure instead of
    uniform randomness: ~45% of it is built from a 300 bp ALU-like element
    and a 6 kb LINE-like element re-inserted many times at 5-15% divergence,
    plus short tandem repeats — the regime that stresses k-mer bucket
    truncation, the rescue pass, and pg self-matching (VERDICT r3 #6)."""
    from .utils import dna

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    if repeats:
        def insert(elem, copies, divergence):
            for _ in range(copies):
                e = elem.copy()
                mut = rng.random(e.size) < divergence
                e[mut] = (e[mut] + rng.integers(1, 4, size=int(mut.sum()))) % 4
                at = rng.integers(0, genome_len - e.size)
                genome[at : at + e.size] = e

        alu = rng.integers(0, 4, size=300, dtype=np.uint8)
        line = rng.integers(0, 4, size=6000, dtype=np.uint8)
        insert(alu, max(genome_len // 1000, 4), 0.10)    # ~30% ALU-like
        insert(line, max(genome_len // 50_000, 2), 0.05)  # ~12% LINE-like
        tandem = np.tile(rng.integers(0, 4, size=4, dtype=np.uint8),
                         rng.integers(20, 80))
        insert(tandem, max(genome_len // 40_000, 2), 0.02)
    starts = rng.integers(0, genome_len - read_len, size=n_reads)

    def make(starts, path):
        codes = genome[starts[:, None] + np.arange(read_len)[None, :]].copy()
        flip = rng.random(n_reads) < 0.5
        codes[flip] = dna.COMPL_VAL[codes[flip][:, ::-1]]
        err = rng.random(codes.shape) < 0.004
        codes[err] = (codes[err] + rng.integers(1, 4, size=int(err.sum()))) % 4
        qual = np.full((n_reads, read_len), ord("I"), dtype=np.uint8)
        lowq = rng.random(n_reads) < 0.12
        qual[lowq, read_len // 2:] = ord("#")
        with open(path, "wb") as f:
            chunk = []
            for i in range(n_reads):
                chunk.append(b"@r%d\n%s\n+\n%s\n" % (
                    i, dna.VAL2SYM[codes[i]].tobytes(), qual[i].tobytes()))
                if len(chunk) == 65536:
                    f.write(b"".join(chunk))
                    chunk = []
            f.write(b"".join(chunk))
        return codes

    codes = make(starts, path)
    if pair:
        mate_starts = np.clip(starts + rng.integers(150, 450, size=n_reads),
                              0, genome_len - read_len)
        make(mate_starts, pair)
    return codes
