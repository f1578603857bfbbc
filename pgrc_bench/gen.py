"""The benchmark's input generator: synthetic whole-genome FASTQ from a seed.

A frozen copy of `pgrc_tpu_torch/synth.py`'s `synth_fastq` (itself bench.py's),
with three of its constants made parameters (`lq_share`, its 0.12;
`error_rate`, its 0.004; `n_share`, reads carrying one N, which it has not)
and its per-read write loop replaced by a vectorised writer. Its random draws
are the original's, in the original's order, and the N draws come last and
only where `n_share` > 0, so at lq_share 0.12, error_rate 0.004 and no N it
writes the original's bytes for the same seed and sizes. With `genome_seed`
the genome (and its repeats) is drawn from that seed and the reads from
`seed`, so that every seed samples reads of one genome.

Run as a script it reads one JSON object of `synth_fastq`'s arguments
(`path`, `n_reads`, `read_len`, `genome_len`, `seed`, and optionally `pair`,
`repeats`, `lq_share`, `error_rate`, `n_share`, `genome_seed`) from its
first argument and writes the file(s); the harness starts it in a process of
its own, so that its temporaries count in no reading of the harness's
resident size.
"""
from __future__ import annotations

import json
import sys

import numpy as np

VAL2SYM = np.frombuffer(b"ACGTN", dtype=np.uint8)
COMPL_VAL = np.array([3, 2, 1, 0, 4], dtype=np.uint8)   # A<->T, C<->G, N->N
N_CODE = 4
# rows of the error draw at a time: the same stream as one draw of the
# whole matrix, without its [n, L] float64 temporary
_DRAW_ROWS = 1 << 16
_WRITE_ROWS = 1 << 18


def synth_fastq(path, n_reads, read_len, genome_len, seed=0, pair=None,
                repeats=False, lq_share=0.12, error_rate=0.004, n_share=0.0,
                genome_seed=None):
    """Synthetic WGS-like FASTQ; with `pair`, writes a mate file whose reads
    are sampled nearby on the genome (insert ~300).

    With `repeats`, ~45% of the genome is built from a 300 bp ALU-like
    element and a 6 kb LINE-like element re-inserted many times at 5-15%
    divergence, plus short tandem repeats. Returns the first file's codes."""
    rng = np.random.default_rng(seed if genome_seed is None else genome_seed)
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
    if genome_seed is not None:
        rng = np.random.default_rng(seed)
    starts = rng.integers(0, genome_len - read_len, size=n_reads)

    def make(starts, path):
        codes = genome[starts[:, None] + np.arange(read_len)[None, :]]
        flip = rng.random(n_reads) < 0.5
        codes[flip] = COMPL_VAL[codes[flip][:, ::-1]]
        err = np.empty(codes.shape, dtype=bool)
        for lo in range(0, n_reads, _DRAW_ROWS):
            hi = min(lo + _DRAW_ROWS, n_reads)
            err[lo:hi] = rng.random((hi - lo, read_len)) < error_rate
        codes[err] = (codes[err] + rng.integers(1, 4, size=int(err.sum()))) % 4
        del err
        lowq = rng.random(n_reads) < lq_share
        if n_share > 0:
            has_n = np.nonzero(rng.random(n_reads) < n_share)[0]
            codes[has_n, rng.integers(0, read_len, size=has_n.size)] = N_CODE
        write_fastq(path, codes, lowq)
        return codes

    codes = make(starts, path)
    if pair:
        mate_starts = np.clip(starts + rng.integers(150, 450, size=n_reads),
                              0, genome_len - read_len)
        make(mate_starts, pair)
    return codes


def write_fastq(path, codes, lowq):
    """Write `@r<i>`, the read, `+` and its quality (all `I`, or a second
    half of `#` where `lowq`) for every row of `codes`. Records whose ids
    have the same number of digits have one length, so each such run of
    rows is laid out as one [rows, record] byte matrix."""
    n, L = codes.shape
    half = np.full(L, ord("I"), dtype=np.uint8)
    low = half.copy()
    low[L // 2:] = ord("#")
    with open(path, "wb") as f:
        lo = 0
        while lo < n:
            d = len(str(lo))
            hi = min(n, 10 ** d, lo + _WRITE_ROWS)
            ids = np.arange(lo, hi, dtype=np.int64)
            rec = np.empty((hi - lo, 2 * L + 7 + d), dtype=np.uint8)
            rec[:, 0] = ord("@")
            rec[:, 1] = ord("r")
            powers = 10 ** np.arange(d - 1, -1, -1, dtype=np.int64)
            rec[:, 2 : 2 + d] = ids[:, None] // powers % 10 + ord("0")
            rec[:, 2 + d] = ord("\n")
            s = 3 + d
            rec[:, s : s + L] = VAL2SYM[codes[lo:hi]]
            rec[:, s + L : s + L + 3] = np.frombuffer(b"\n+\n", dtype=np.uint8)
            rec[:, s + L + 3 : s + 2 * L + 3] = np.where(lowq[lo:hi, None], low, half)
            rec[:, -1] = ord("\n")
            f.write(rec.data)
            lo = hi


if __name__ == "__main__":
    synth_fastq(**json.loads(sys.argv[1]))
