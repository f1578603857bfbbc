"""Kernel A, `verify_best`: best-of-n packed pg-window verify (csrc/verify.cu).

Replaces `exp_pallas_verify.kernel` (the repo's one Pallas kernel) and
`pgrc_tpu.align.matcher._make_probe._verify` with its best-of-n loop
(matcher.py:191-206, :268-308), with int32 or (the wide probe, :180-181)
int64 positions. It takes the join's anchors as they come and turns them
into starts itself (matcher.py:262-266), so no elementwise pass runs
between the join and the verify.
"""
from __future__ import annotations

import torch

from ..core.packed import popcount_u32
from ..utils.uint import U32_MASK, i32_to_u32
from . import check, launch, launches, on_cpu, ptr
from .kmer_hash import offsets_tensor


def lane_mask(L: int) -> list[int]:
    """Per-lane u32 masks of a read of length L (the last lane's tail)."""
    W = (L + 15) // 16
    tail = L - (W - 1) * 16
    return [U32_MASK] * (W - 1) + [(U32_MASK << (32 - 2 * tail)) & U32_MASK]


def window_mismatches(read_lanes: torch.Tensor, starts: torch.Tensor,
                      pg_lanes: torch.Tensor, L: int) -> torch.Tensor:
    """Packed mismatch count of the pg window at each start [R] against each
    read [R, >=W] (plain version of matcher._verify)."""
    W = (L + 15) // 16
    masks = lane_mask(L)
    pg = i32_to_u32(pg_lanes)
    last = pg.numel() - 1
    q = starts >> 4
    s2 = (starts & 15) << 1
    mis = torch.zeros_like(starts)
    for c in range(W):
        a = pg[(q + c).clamp(max=last)]
        b = pg[(q + c + 1).clamp(max=last)]
        # int64 carrier: b < 2^32, so b >> 32 == 0 covers the s2 == 0 case
        # that a 32-bit shift would leave undefined
        aligned = (((a << s2) & U32_MASK) | (b >> (32 - s2))) & masks[c]
        x = aligned ^ (i32_to_u32(read_lanes[:, c]) & masks[c])
        mis += popcount_u32((x | (x >> 1)) & 0x55555555)
    return mis


def verify_best_plain(read_lanes, start_all, in_range, pg_lanes, pg_top: int,
                      L: int, max_mis: int, n_verify: int):
    """Per read: verify the first `n_verify` in-range starts in slot order,
    each clipped to [0, pg_top]; keep the (mismatches, position) minimum;
    accept it when mismatches <= max_mis. -> (mis uint8 [R], 255 = none;
    pos [R] of start_all's dtype, int32 or int64, -1 = none)."""
    R, S = start_all.shape
    taken = in_range & (torch.cumsum(in_range.to(torch.int32), dim=1) <= n_verify)
    st_all = start_all.to(torch.int64).clamp(0, pg_top)
    best_mis = torch.full((R,), 255, dtype=torch.int64, device=read_lanes.device)
    best_pos = torch.full((R,), torch.iinfo(start_all.dtype).max, dtype=torch.int64,
                          device=read_lanes.device)
    for j in range(S):
        st = st_all[:, j]
        mis = window_mismatches(read_lanes, st, pg_lanes, L)
        better = taken[:, j] & ((mis < best_mis) | ((mis == best_mis) & (st < best_pos)))
        best_mis = torch.where(better, mis, best_mis)
        best_pos = torch.where(better, st, best_pos)
    ok = best_mis <= max_mis
    return (torch.where(ok, best_mis, 255).to(torch.uint8),
            torch.where(ok, best_pos, -1).to(start_all.dtype))


def probe_starts_plain(res, offs: tuple, pg_len: int, L: int, wide: bool):
    """The join's anchors -> candidate starts (matcher.py:262-266): res [R, S]
    int64 (position + 1, 0 = none), offs the S probe offsets -> (start_all
    [R, S], int64 when `wide`, else int32; in_range [R, S] bool: the anchor
    exists and its window lies inside the pg)."""
    start_all = res - 1 - offsets_tensor(offs, res.device).to(torch.int64)[None, :]
    in_range = (res > 0) & (start_all >= 0) & (start_all <= pg_len - L)
    if not wide:
        start_all = start_all.to(torch.int32)
    return start_all, in_range


def verify_best(read_lanes: torch.Tensor, res: torch.Tensor, offs: tuple,
                pg_lanes: torch.Tensor, pg_len: int, L: int, max_mis: int,
                n_verify: int, wide: bool):
    """read_lanes [R, W+1] int32, res [R, S] int64 the join's anchors
    (position + 1, 0 = none) at the S probe offsets `offs` (host ints),
    pg_lanes [PGL] int32 (zero pad lane included) of a pg of pg_len symbols
    -> (mis uint8 [R], 255 = none; pos [R], int64 when `wide` (pgs past
    2^31 symbols), else int32, -1 = none): `probe_starts_plain`, then
    `verify_best_plain` with the starts clipped to [0, max(pg_len - L, 0)].
    CUDA tensors run kernel A, which computes the starts itself. pg_lanes
    must start on 16 bytes (kernel A reads it in 16-byte chunks), on either
    device, so the two behave alike."""
    offs = tuple(offs)
    W = (L + 15) // 16
    R, S = read_lanes.shape[0], len(offs)
    check(read_lanes, "read_lanes", torch.int32, (R, None))
    check(res, "res", torch.int64, (R, S))
    check(pg_lanes, "pg_lanes", torch.int32, (None,))
    if not 1 <= W <= 16 or read_lanes.shape[1] < W:
        raise ValueError(f"read length {L} needs 1..16 lanes per read")
    if not 0 <= max_mis < 255:
        raise ValueError("max_mis must lie in [0, 255): 255 means 'no match'")
    if not wide and pg_len - L >= 1 << 31:
        raise ValueError("int32 starts end at 2^31: use the wide (int64) form")
    if pg_lanes.data_ptr() % 16:
        raise ValueError("kernel A reads pg_lanes in 16-byte chunks: pass a tensor "
                         "that starts on 16 bytes, not an offset view")
    if on_cpu(read_lanes, res, pg_lanes):
        return verify_best_plain(read_lanes, *probe_starts_plain(res, offs, pg_len, L, wide),
                                 pg_lanes, max(pg_len - L, 0), L, max_mis, n_verify)
    dev = read_lanes.device
    out_mis = torch.empty((R,), dtype=torch.uint8, device=dev)
    out_pos = torch.empty((R,), dtype=torch.int64 if wide else torch.int32, device=dev)
    launch("pgrc_verify_best", dev, ptr(read_lanes), R, W, read_lanes.shape[1], ptr(res),
           ptr(offsets_tensor(offs, dev)), S, ptr(pg_lanes), pg_lanes.numel(), pg_len, L,
           lane_mask(L)[-1], max_mis, n_verify, int(wide), ptr(out_mis), ptr(out_pos))
    launches["verify_best.int64" if wide else "verify_best"] += 1
    return out_mis, out_pos
