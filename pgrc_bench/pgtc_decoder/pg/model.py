"""The reads list of a pseudogenome, as struct-of-arrays.

Replaces the reference's SeparatedPseudoGenome + ExtendedReadsList...
(pseudogenome/SeparatedPseudoGenome.h:12-65,
pseudogenome/readslist/SeparatedExtendedReadsList.h:18-94) with plain numpy
struct-of-arrays. Mismatch sym-codes/offsets are stored flat with a cumulative
count index (the reference's misCumCount), in read order.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ReadsList:
    """Per-read records of a pseudogenome, in pg (position) order."""

    pos: np.ndarray                 # [R] int64 pg positions (non-decreasing)
    org_idx: np.ndarray             # [R] int64 original read index (or empty)
    rev_comp: np.ndarray            # [R] bool (empty = all False)
    mis_cnt: np.ndarray             # [R] uint8 (empty = all 0)
    mis_sym_code: np.ndarray        # [sum mis_cnt] uint8 cxt codes (pg<<4|read),
                                    # or exclusive codes 0..3 when mis_dec_lut set
    mis_off: np.ndarray             # [sum mis_cnt] uint8/uint16 read-local offsets
    # [5, 4] uint8 LUT (window value, exclusive code) -> read value; when set,
    # mis_sym_code holds exclusive codes (utils/helper.cpp:347-377 role)
    mis_dec_lut: np.ndarray | None = None
    # lazily-built mismatch CSR cumsum; cached because chunked decode calls
    # take_rows once per chunk and an O(R) recompute per chunk is O(R^2/C)
    # across a decode (misCumCount role, SeparatedExtendedReadsList.h:18-94)
    _mis_cum: np.ndarray | None = field(default=None, repr=False, compare=False)

    @property
    def count(self) -> int:
        return self.pos.shape[0]

    @property
    def mis_cum(self) -> np.ndarray:
        if self._mis_cum is None or self._mis_cum.size != self.count + 1:
            c = np.zeros(self.count + 1, dtype=np.int64)
            if self.mis_cnt.size:
                np.cumsum(self.mis_cnt, out=c[1:])
            self._mis_cum = c
        return self._mis_cum

    def take_rows(self, sel: np.ndarray, pos: np.ndarray | None = None) -> "ReadsList":
        """Row-gather (chunked decode): entry rows `sel`, with the flat
        mismatch streams re-gathered through the CSR cumsum. `pos` overrides
        the gathered positions (ORD modes supply output-order positions)."""
        cum = self.mis_cum
        cnt = (self.mis_cnt[sel].astype(np.int64) if self.mis_cnt.size
               else np.zeros(sel.size, np.int64))
        total = int(cnt.sum())
        if total:
            starts = cum[sel]
            local_start = np.concatenate([np.zeros(1, np.int64),
                                          np.cumsum(cnt)[:-1]])
            flat = np.repeat(starts - local_start, cnt) + np.arange(total)
            sym = self.mis_sym_code[flat]
            off = self.mis_off[flat]
        else:
            sym = np.zeros(0, dtype=self.mis_sym_code.dtype)
            off = np.zeros(0, dtype=self.mis_off.dtype)
        return ReadsList(
            pos=self.pos[sel] if pos is None else pos,
            org_idx=np.zeros(0, dtype=np.int64),
            rev_comp=self.rev_comp[sel] if self.rev_comp.size else self.rev_comp,
            mis_cnt=cnt.astype(np.uint8),
            mis_sym_code=sym,
            mis_off=off,
            mis_dec_lut=self.mis_dec_lut,
        )

