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
- `reordered`, of the `-o` modes alone: two reads (in PE_ORD two pairs)
  whose bases differ exchange their places in the order stream, so the
  archive decodes to the input's multiset in another order. Elsewhere it
  changes nothing.

The exchange between chips, a fault of four-chip cells, has none here: every
cell runs on one card.
"""
from __future__ import annotations

import contextlib
import sys

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


def _exchangeable(pos, per, stage):
    """Two units (reads, or with `per` 2 pairs) of the order stream `pos`
    whose exchange moves reads without altering any: slot by slot both raw
    (an LQ or N pg read), or both HQ entries without mismatches on the same
    strand, since an ORD archive gives the k-th HQ read in input order the
    k-th HQ entry's strand and mismatches. Of those, two whose bases differ.
    `stage` is the encoder's frame at stage 6: its pgs and HQ entries."""
    hq_pg, L, entries = stage["hq_pg"], stage["L"], stage["hq_entries"]
    joined = np.concatenate([hq_pg, stage["lq_pg"], stage["n_pg"]])
    kind = np.zeros(pos.size, np.int64)          # 0: raw
    org = entries["org"]
    kind[org] = np.where(entries["mis_cnt"] > 0, -1, 1 + entries["rc"].astype(np.int64))
    units = min(pos.size // per, 1 << 14)
    sig = kind[: units * per].reshape(units, per)
    win = joined[pos[: units * per, None] + np.arange(L)[None, :]].reshape(units, per * L)
    first = {}
    for u in np.flatnonzero((sig >= 0).all(axis=1)):
        key = sig[u].tobytes()
        v = first.setdefault(key, u)
        if v != u and not np.array_equal(win[u], win[v]):
            return v, u
    raise RuntimeError("no two units of the order stream can exchange places")


@contextlib.contextmanager
def reordered():
    """Patches the ORD modes' position coders (`encode_positions_se`,
    `encode_positions_pe`), which the encoder calls at stage 6 with the
    position of every read in input order."""
    from pgrc_tpu_torch.archive import order

    def make(per):
        def wrap(orig):
            def encode_positions(out, pos):
                a, b = _exchangeable(pos, per, sys._getframe(1).f_locals)
                pos = pos.copy()
                ia, ib = np.arange(a * per, a * per + per), np.arange(b * per, b * per + per)
                pos[ia], pos[ib] = pos[ib], pos[ia]
                return orig(out, pos)
            return encode_positions
        return wrap

    with _patched(order, "encode_positions_se", make(1)), \
         _patched(order, "encode_positions_pe", make(2)):
        yield


FAULTS = {"lossy": lossy, "unchanged": unchanged, "half": half, "altered": altered,
          "reordered": reordered}
