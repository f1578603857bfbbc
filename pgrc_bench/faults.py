"""Faults planted in the program, for the benchmark's control and its tests.

Each is a context manager that patches `pgrc_tpu_torch` in this process and
restores it on exit. No run of the benchmark enters one: `control.py` and
`tests/` do, to show that the comparison that decides `correct` fails them.

- `lossy`, the control: the matched reads' mismatches are dropped, so the
  archive is smaller and its decode wrong. PgRC states no precision; this
  breaks its one guarantee, lossless reads, the way a shortcut in the
  matcher or the mismatch coder would.
- `unchanged`: the encode returns at once and writes no archive.
- `half`: half of the input's reads (pairs kept whole) are left out.
- `altered`: one base of the HQ pseudogenome is changed where the sweep
  produces it, so the HQ reads over it decode wrong.

The exchange between chips, a fault of four-chip cells, has none here: every
cell runs on one card.
"""
from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _no_mismatches(n):
    return np.zeros(n, np.uint8), np.zeros(0, np.uint8), np.zeros(0, np.uint8)


@contextlib.contextmanager
def lossy():
    from pgrc_tpu_torch import native
    from pgrc_tpu_torch.archive import encoder

    with _patched(native, "extract_mismatches",
                  lambda orig: lambda pg, pos, *a, **k: _no_mismatches(len(pos))), \
         _patched(encoder, "extract_mismatches",
                  lambda orig: lambda codes, *a, **k: _no_mismatches(len(codes))):
        yield


@contextlib.contextmanager
def unchanged():
    from pgrc_tpu_torch.archive import encoder

    with _patched(encoder, "encode", lambda orig: lambda params, out_path=None, **k:
                  encoder.EncodeStats(stage_times={})):
        yield


@contextlib.contextmanager
def half():
    from pgrc_tpu_torch.archive import encoder
    from pgrc_tpu_torch.core import fastq

    def make(orig):
        def read_divided(*a, **k):
            r = orig(*a, **k)
            h = r.count // 2 // 2 * 2
            return fastq.DividedInput(r.codes[:h], r.hq_mask[:h], r.n_mask[:h], r.read_len)
        return read_divided

    with _patched(encoder.fastq, "read_divided", make):
        yield


@contextlib.contextmanager
def altered():
    from pgrc_tpu_torch.overlap import greedy_scs

    def make(orig):
        def divide_and_generate(*a, **k):
            keep, hq_pg, *rest = orig(*a, **k)
            hq_pg = hq_pg.copy()
            mid = len(hq_pg) // 2
            hq_pg[mid] = (hq_pg[mid] + 1) % 4
            return (keep, hq_pg, *rest)
        return divide_and_generate

    with _patched(greedy_scs, "divide_and_generate", make):
        yield


FAULTS = {"lossy": lossy, "unchanged": unchanged, "half": half, "altered": altered}
