"""Kernels B and C: u32 k-mer hashes of packed lanes, written as the join's
sort keys (csrc/kmer_hash.cu).

B, `index_kmer_hash`, replaces matcher.py `_build_index_build_fn` (:469-517),
one index block per launch, int32 or (wide) int64 positions;
C, `probe_kmer_hash`, replaces the anchor hashes of `_make_probe` (:208-223).
H = sum_t v[t] * HASH_BASE^(k-1-t) mod 2^32 over the k 2-bit symbols.

Both return the join's composed key (`index_keys`, `probe_keys`): the
reference's (hash, key2) order (matcher.py:228-238) as one int64, high word
hash - 2^31, low word key2 = 0 for a live index entry, U32INV for an inert
one, 1 + p for probe p. Given an output view, B writes the head of a join's
key buffer and C its tail, so the join sorts the buffer as it stands.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import state
from ..overlap.host import HASH_BASE
from ..utils.uint import U32_MASK, i32_to_u32, u32_to_i32
from . import check, launch, launches, on_cpu, ptr

_B = int(HASH_BASE)
_SIGN32 = -(1 << 31)   # int32 with only bit 31 set


def index_keys(ihash: torch.Tensor, ipos: torch.Tensor) -> torch.Tensor:
    """Join keys of index entries: int32 hash bits [M] and positions [M]
    (-1 = inert) -> int64 (hash - 2^31) * 2^32 + (0 live, U32INV inert)."""
    return ((ihash ^ _SIGN32).to(torch.int64) * (1 << 32)
            + torch.where(ipos >= 0, 0, U32_MASK))


def probe_keys(hashes: torch.Tensor) -> torch.Tensor:
    """Join keys of probes: int32 hash bits [R, S] -> int64 [R * S],
    (hash - 2^31) * 2^32 + 1 + p for probe p in row-major order."""
    P = hashes.numel()
    return ((hashes.reshape(P) ^ _SIGN32).to(torch.int64) * (1 << 32)
            + torch.arange(1, P + 1, dtype=torch.int64, device=hashes.device))


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


def _out(t: torch.Tensor | None, name: str, dtype: torch.dtype, n: int, device):
    if t is None:
        return torch.empty((n,), dtype=dtype, device=device)
    check(t, name, dtype, (n,))
    return t


def index_kmer_hash_plain(pg_lanes, k: int, k1: int, pg_len: int, m: int,
                          lane_off: int = 0, wide: bool = False):
    """Entries e = 0..m-1 of the block starting at lane `lane_off`, at pg
    position lane_off*16 + e*k1: (join key, position, -1 past pg_len - k).
    Positions are int64 when `wide`, else int32."""
    pos = lane_off * 16 + torch.arange(m, dtype=torch.int64, device=pg_lanes.device) * k1
    h = _horner(i32_to_u32(pg_lanes), pos, k)
    ipos = torch.where(pos <= pg_len - k, pos, -1)
    return index_keys(u32_to_i32(h), ipos), ipos if wide else ipos.to(torch.int32)


def index_kmer_hash(pg_lanes: torch.Tensor, k: int, k1: int, pg_len: int, m: int,
                    lane_off: int = 0, wide: bool = False, key: torch.Tensor | None = None,
                    ipos: torch.Tensor | None = None):
    """One block of the sampled k-mer table of the packed pg: `m` entries
    from lane `lane_off` on, one every k1 symbols, as (join keys [m] int64,
    positions [m]), written into `key` and `ipos` where given (the head of
    a join's key buffer). CUDA tensors run kernel B."""
    check(pg_lanes, "pg_lanes", torch.int32, (None,))
    if k < 1 or 16 % k1:
        raise ValueError("kernel B needs k >= 1 and k1 dividing 16")
    if not wide and pg_len - k >= 1 << 31:
        raise ValueError("int32 index positions end at 2^31: use the wide form")
    dev = pg_lanes.device
    key = _out(key, "key", torch.int64, m, dev)
    ipos = _out(ipos, "ipos", torch.int64 if wide else torch.int32, m, dev)
    if on_cpu(pg_lanes, key, ipos):
        want = index_kmer_hash_plain(pg_lanes, k, k1, pg_len, m, lane_off, wide)
        key.copy_(want[0])
        ipos.copy_(want[1])
        return key, ipos
    launch("pgrc_index_kmer_hash", dev, ptr(pg_lanes), pg_lanes.numel(), k, k1,
           lane_off, pg_len, m, pow(_B, k, 1 << 32), int(wide), ptr(key), ptr(ipos))
    launches["index_kmer_hash.int64" if wide else "index_kmer_hash"] += 1
    return key, ipos


@functools.lru_cache(maxsize=32)
def offsets_tensor(offs: tuple, device: torch.device) -> torch.Tensor:
    """Probe offsets (a tuple of ints) as an int32 tensor on `device`, made
    once per offsets and device (kernels C and A of a probe read the same
    tensor: a probe makes no upload of its offsets)."""
    return state.to_device(np.array(offs, dtype=np.int32), device)


def probe_kmer_hash_plain(read_lanes, offs: tuple, k: int):
    """[R * S] join keys of the k symbols at each offset of each read."""
    lanes_u = i32_to_u32(read_lanes)
    R, S = read_lanes.shape[0], len(offs)
    out = torch.empty((R, S), dtype=torch.int64, device=read_lanes.device)
    for j, o in enumerate(offs):
        h = torch.zeros((R,), dtype=torch.int64, device=read_lanes.device)
        for t in range(k):
            c, oo = divmod(o + t, 16)
            h = (h * _B + ((lanes_u[:, c] >> (2 * (15 - oo))) & 3)) & U32_MASK
        out[:, j] = h
    return probe_keys(u32_to_i32(out))


def probe_kmer_hash(read_lanes: torch.Tensor, offs: tuple, k: int,
                    out: torch.Tensor | None = None):
    """read_lanes [R, W+1] int32 and S probe offsets (host ints, checked
    here without reading the device) -> [R * S] int64 join keys of the
    anchor at each offset of each read, row-major, written into `out` where
    given (the tail of a join's key buffer). CUDA tensors run kernel C."""
    offs = tuple(offs)
    R, S = read_lanes.shape[0], len(offs)
    check(read_lanes, "read_lanes", torch.int32, (R, None))
    if k < 1:
        raise ValueError("kernel C needs k >= 1")
    max_off = max(offs, default=0)
    if S and (min(offs) < 0 or max_off + k > 16 * read_lanes.shape[1]):
        raise ValueError("probe offsets reach past the read lanes")
    if R * S >= U32_MASK:
        raise ValueError("probe ordinals 1..R*S must stay below U32INV")
    out = _out(out, "out", torch.int64, R * S, read_lanes.device)
    if on_cpu(read_lanes, out):
        out.copy_(probe_kmer_hash_plain(read_lanes, offs, k))
        return out
    offs_t = offsets_tensor(offs, read_lanes.device)
    launch("pgrc_probe_kmer_hash", read_lanes.device, ptr(read_lanes), R,
           read_lanes.shape[1], ptr(offs_t), S, max_off, k, pow(_B, k, 1 << 32), ptr(out))
    launches["probe_kmer_hash"] += 1
    return out
