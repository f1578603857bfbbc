"""Kernels B and C: u32 k-mer hashes of packed lanes (csrc/kmer_hash.cu).

B, `index_kmer_hash`, replaces matcher.py `_build_index_build_fn` (:469-517),
one index block per launch, int32 or (wide) int64 positions;
C, `probe_kmer_hash`, replaces the anchor hashes of `_make_probe` (:213-223).
H = sum_t v[t] * HASH_BASE^(k-1-t) mod 2^32 over the k 2-bit symbols.
"""
from __future__ import annotations

import torch

from pgrc_tpu.overlap.greedy_scs import HASH_BASE

from ..utils.uint import U32_MASK, i32_to_u32, u32_to_i32
from . import check, launch, launches, on_cpu, ptr

_B = int(HASH_BASE)


def _horner(lanes_u: torch.Tensor, sym0: torch.Tensor, k: int) -> torch.Tensor:
    """Hash of the k symbols from symbol index sym0 (per element) of one
    flat u32 lane row; lanes past the end read as zero."""
    n_lanes = lanes_u.numel()
    h = torch.zeros_like(sym0)
    for t in range(k):
        s = sym0 + t
        c = s >> 4
        lane = torch.where(c < n_lanes, lanes_u[c.clamp(max=n_lanes - 1)], 0)
        h = (h * _B + ((lane >> (2 * (15 - (s & 15)))) & 3)) & U32_MASK
    return h


def index_kmer_hash_plain(pg_lanes, k: int, k1: int, pg_len: int, m: int,
                          lane_off: int = 0, wide: bool = False):
    """Entries e = 0..m-1 of the block starting at lane `lane_off`, at pg
    position lane_off*16 + e*k1: (hash int32 bits, position, -1 past
    pg_len - k). Positions are int64 when `wide`, else int32."""
    pos = lane_off * 16 + torch.arange(m, dtype=torch.int64, device=pg_lanes.device) * k1
    h = _horner(i32_to_u32(pg_lanes), pos, k)
    ipos = torch.where(pos <= pg_len - k, pos, -1)
    return u32_to_i32(h), ipos if wide else ipos.to(torch.int32)


def index_kmer_hash(pg_lanes: torch.Tensor, k: int, k1: int, pg_len: int, m: int,
                    lane_off: int = 0, wide: bool = False):
    """One block of the sampled k-mer table of the packed pg: `m` entries
    from lane `lane_off` on, one every k1 symbols. CUDA tensors run kernel B."""
    check(pg_lanes, "pg_lanes", torch.int32, (None,))
    if not wide and pg_len - k >= 1 << 31:
        raise ValueError("int32 index positions end at 2^31: use the wide form")
    if on_cpu(pg_lanes):
        return index_kmer_hash_plain(pg_lanes, k, k1, pg_len, m, lane_off, wide)
    ihash = torch.empty((m,), dtype=torch.int32, device=pg_lanes.device)
    ipos = torch.empty((m,), dtype=torch.int64 if wide else torch.int32,
                       device=pg_lanes.device)
    launch("pgrc_index_kmer_hash", pg_lanes.device, ptr(pg_lanes),
           pg_lanes.numel(), k, k1, lane_off, pg_len, m, int(wide), ptr(ihash),
           ptr(ipos))
    launches["index_kmer_hash.int64" if wide else "index_kmer_hash"] += 1
    return ihash, ipos


def probe_kmer_hash_plain(read_lanes, offs, k: int):
    """[R, S] int32 hash bits of the k symbols at each offset of each read."""
    lanes_u = i32_to_u32(read_lanes)
    R, S = read_lanes.shape[0], offs.numel()
    out = torch.empty((R, S), dtype=torch.int64, device=read_lanes.device)
    for j, o in enumerate(offs.tolist()):
        h = torch.zeros((R,), dtype=torch.int64, device=read_lanes.device)
        for t in range(k):
            c, oo = divmod(o + t, 16)
            h = (h * _B + ((lanes_u[:, c] >> (2 * (15 - oo))) & 3)) & U32_MASK
        out[:, j] = h
    return u32_to_i32(out)


def probe_kmer_hash(read_lanes: torch.Tensor, offs: torch.Tensor, k: int):
    """read_lanes [R, W+1] int32, offs [S] int32 -> [R, S] int32 hash bits.
    CUDA tensors run kernel C."""
    R = read_lanes.shape[0]
    check(read_lanes, "read_lanes", torch.int32, (R, None))
    check(offs, "offs", torch.int32, (None,))
    if offs.numel() and (int(offs.min()) < 0 or
                         int(offs.max()) + k > 16 * read_lanes.shape[1]):
        raise ValueError("probe offsets reach past the read lanes")
    if on_cpu(read_lanes, offs):
        return probe_kmer_hash_plain(read_lanes, offs, k)
    out = torch.empty((R, offs.numel()), dtype=torch.int32, device=read_lanes.device)
    launch("pgrc_probe_kmer_hash", read_lanes.device, ptr(read_lanes), R,
           read_lanes.shape[1], ptr(offs), offs.numel(), k, ptr(out))
    launches["probe_kmer_hash"] += 1
    return out
