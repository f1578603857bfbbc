"""Batched read reconstruction from a pseudogenome (the decoder hot loop).

Replaces the reference's per-read getRead/getRead_Unsafe loop
(pseudogenome/SeparatedPseudoGenome.cpp:74-130) with one vectorized program:
gather [R, L] windows from the pg sequence, reverse-complement flagged rows,
and scatter mismatch symbols at their read-local offsets.
"""
from __future__ import annotations

import numpy as np

from ..utils import dna
from .model import ReadsList


def reconstruct_at(
    seq: np.ndarray, pos: np.ndarray, read_len: int, reads: ReadsList | None = None
) -> np.ndarray:
    """Gather read windows at `pos`; apply rev-comp flags and mismatches when
    a reads list is given (its rows align with `pos`)."""
    n = pos.shape[0]
    if n == 0:
        return np.zeros((0, read_len), dtype=np.uint8)
    idx = pos[:, None] + np.arange(read_len, dtype=np.int64)[None, :]
    out = seq[idx]
    if reads is None:
        return out
    if reads.rev_comp.size:
        rc = reads.rev_comp
        if rc.any():
            out[rc] = dna.COMPL_VAL[out[rc][:, ::-1]]
    if reads.mis_cnt.size and reads.mis_sym_code.size:
        cum = reads.mis_cum
        total = int(cum[-1])
        if total:
            read_of_mis = np.repeat(np.arange(n, dtype=np.int64), reads.mis_cnt)
            offs = reads.mis_off.astype(np.int64)
            if reads.mis_dec_lut is not None:
                # exclusive code: actual value depends on the window symbol
                cur = out[read_of_mis, offs]
                out[read_of_mis, offs] = reads.mis_dec_lut[cur, reads.mis_sym_code]
            else:
                # cxt code low nibble = the read's symbol (mismatch2CxtCode)
                out[read_of_mis, offs] = reads.mis_sym_code & 0x0F
    return out

