"""Kernel I, `strand_rows`: a take of packed read rows and their reverse
complements in one pass (csrc/strand_rows.cu).

Replaces the matcher's strand prep, `pgrc_tpu.align.matcher.match_reads`
"rcprep" (:654-678, `packed.revcomp_lanes` at packed.py:205-253 with a
concatenate), and its pass-2 row take "p2gather" (:700-710): pass 1 takes
every row, pass 2 the rows it did not accept, each with both strands.
"""
from __future__ import annotations

import torch

from ..core.packed import revcomp_lanes
from . import check, launch, launches, on_cpu, ptr


def strand_rows_plain(lanes, nmask, L: int, rows=None) -> torch.Tensor:
    """`revcomp_lanes` after a row take: [lanes[rows]; revcomp(lanes[rows])]."""
    if rows is not None:
        lanes = lanes.index_select(0, rows)
        nmask = None if nmask is None else nmask.index_select(0, rows)
    return torch.cat([lanes, revcomp_lanes(lanes, L, nmask)])


def strand_rows(lanes: torch.Tensor, nmask: torch.Tensor | None, L: int,
                rows: torch.Tensor | None = None) -> torch.Tensor:
    """lanes [n, W+1] int32 (the `pack_lanes` layout, W = ceil(L/16)),
    nmask [n, Wn+1] int32 or None, rows int64 [R] ids into them (None: the
    n rows in order) -> [2R, W+1] int32: rows r < R are lanes[rows[r]],
    rows R + r their reverse complements, N groups cleared to A (the
    matcher's strand rows). CUDA tensors launch kernel I, which trusts
    `rows` to lie in [0, n)."""
    W, Wn = (L + 15) // 16, (L + 31) // 32
    n = lanes.shape[0]
    if not 1 <= L <= 256:
        raise ValueError(f"read length {L} needs 1..16 lanes per read")
    check(lanes, "lanes", torch.int32, (n, W + 1))
    if nmask is not None:
        check(nmask, "nmask", torch.int32, (n, Wn + 1))
    if rows is not None:
        check(rows, "rows", torch.int64, (None,))
    if on_cpu(lanes, nmask, rows):
        return strand_rows_plain(lanes, nmask, L, rows)
    R = n if rows is None else rows.numel()
    out = torch.empty((2 * R, W + 1), dtype=torch.int32, device=lanes.device)
    if R:
        launch("pgrc_strand_rows", lanes.device, ptr(lanes), ptr(nmask), Wn + 1, ptr(rows),
               R, L, ptr(out))
        launches["strand_rows" if rows is None else "strand_rows.take"] += 1
    return out
