"""Read -> pseudogenome matcher on torch: the single-pass path of
pgrc_tpu/align/matcher.py `match_reads` (:584-760).

Per read and strand: hash a k-mer anchor at every probe offset (kernel C),
join the anchors with the pg's sampled k-mer table (kernel B) so each gets
the lowest-position index entry of exactly its hash, turn anchors into
candidate starts, and verify the first n_verify in-range starts against the
packed pg, keeping the (mismatches, position) minimum (kernel A). Reads both
strands missed go to the reference's host rescue. Results are bit-identical
to the reference's; the host pieces (offsets, batch cap, rescue) are its own.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from pgrc_tpu.align.matcher import (  # noqa: F401  (re-exported host layer)
    DEFAULT_CAP, DEFAULT_K2, KmerIndex, MatchResult,
    _MAX_INDEX_BLOCK, _POS_BITS, _batch_cap, _build_rescue_index,
    _interleaved_rescue, build_index, probe_offsets)
from pgrc_tpu.core import packed as ref_packed
from pgrc_tpu.utils.trace import span

from .. import state
from ..core.packed import revcomp_lanes
from ..kernels.kmer_hash import index_kmer_hash, probe_kmer_hash
from ..kernels.verify import verify_best
from ..utils.uint import U32_MASK, i32_to_u32

_POS_MASK = (1 << _POS_BITS) - 1
_JOIN_MAX = 1 << 28   # the carry pack stays below 2^63 while seg_start < 2^28


def device_index(index: KmerIndex, pg_codes: np.ndarray, device):
    """(ihash int32 bits, ipos int32, pg_lanes int32) on `device`.

    A lazy index (`build_index(..., device_sort=True)`, the encoder's) is
    built by kernel B from the packed pg, one entry every k1 symbols over the
    pg's lanes, positions past pg_len - k inert (-1). A host-built table is
    moved across as it is."""
    pg_lanes = state.pg_lanes_to_device(pg_codes, device)
    if index.hash_sorted is None:
        if 16 % index.k1:
            raise ValueError("the device index build needs k1 to divide 16")
        m = (pg_lanes.numel() - 1) * 16 // index.k1
        if m > _MAX_INDEX_BLOCK:
            raise NotImplementedError(
                f"a {m}-entry index needs blocked probing (ROADMAP queue 1 item 8)")
        ihash, ipos = index_kmer_hash(pg_lanes, index.k, index.k1, index.pg_len, m)
    else:
        if index.pos_sorted.size > _MAX_INDEX_BLOCK:
            raise NotImplementedError("blocked index probing is ROADMAP queue 1 item 8")
        ihash, ipos = state.index_to_device(index.hash_sorted, index.pos_sorted, device)
    return ihash, ipos, pg_lanes


def join_anchors(hashes: torch.Tensor, ihash: torch.Tensor, ipos: torch.Tensor):
    """Sort-merge join (matcher.py:225-260): for each probe hash [R, S], the
    lowest position of an index entry with exactly that hash, + 1 (0 = none).

    One sort on a composed int64 key (hash - 2^31) * 2^32 + key2, whose signed
    order is the reference's (hash, key2) order; key2 = 0 for index entries,
    U32INV for inert ones, 1..P for the probes. A segmented cummax of
    seg_start << 35 | (POS_MASK - pos) hands each probe its run's minimum
    position; a scatter routes results back to probe order."""
    R, S = hashes.shape
    P, M = R * S, ihash.numel()
    m2 = M + P
    if m2 >= _JOIN_MAX:
        raise ValueError(f"join of {m2} entries overflows the carry pack")
    dev = hashes.device
    kh = torch.cat([i32_to_u32(ihash), i32_to_u32(hashes.reshape(P))])
    key2 = torch.cat([torch.where(ipos >= 0, 0, U32_MASK),
                      torch.arange(1, P + 1, dtype=torch.int64, device=dev)])
    skey, perm = torch.sort((kh - (1 << 31)) * (1 << 32) + key2)
    del kh, key2
    hs = skey >> 32
    k2s = skey & U32_MASK
    pos = torch.cat([ipos.clamp(min=0).to(torch.int64),
                     torch.zeros((P,), dtype=torch.int64, device=dev)])[perm]
    idx = torch.arange(m2, dtype=torch.int64, device=dev)
    boundary = torch.ones((m2,), dtype=torch.bool, device=dev)
    boundary[1:] = hs[1:] != hs[:-1]
    seg_start = torch.cummax(torch.where(boundary, idx, 0), 0).values
    packv = torch.where(k2s == 0, (seg_start << _POS_BITS) | (_POS_MASK - pos), 0)
    carried = torch.cummax(packv, 0).values
    confirmed = (carried != 0) & ((carried >> _POS_BITS) == seg_start)
    is_probe = (k2s >= 1) & (k2s != U32_MASK)
    # scatter to probe order; non-probes land in a dump slot at P
    res = torch.zeros((P + 1,), dtype=torch.int64, device=dev)
    res[torch.where(is_probe, k2s - 1, P)] = torch.where(
        is_probe & confirmed, _POS_MASK - (carried & _POS_MASK) + 1, 0)
    return res[:P].reshape(R, S)


def probe(read_lanes, offs_t, ihash, ipos, pg_lanes, pg_len: int, L: int,
          k: int, max_mis: int, n_verify: int):
    """Probe + verify of one row batch (matcher.py:208-308): (mis uint8,
    pos int32) per row."""
    hashes = probe_kmer_hash(read_lanes, offs_t, k)
    res = join_anchors(hashes, ihash, ipos)
    start_all = res - 1 - offs_t.to(torch.int64)[None, :]
    in_range = (res > 0) & (start_all >= 0) & (start_all <= pg_len - L)
    return verify_best(read_lanes, start_all.to(torch.int32), in_range, pg_lanes,
                       max(pg_len - L, 0), L, max_mis, n_verify)


def match_reads(read_codes: np.ndarray, index: KmerIndex, pg_codes: np.ndarray,
                max_mismatches: int, cap: int = DEFAULT_CAP, k2: int = DEFAULT_K2,
                accept_mis: int = 0, *, device) -> MatchResult:
    """Match every read against the indexed pg, both strands, in one
    full-fan-out pass (the reference's single-pass mode, accept_mis <= 0,
    which the NORMAL level uses). N symbols probe as A; the encoder
    re-verifies N rows exactly."""
    n, L = read_codes.shape
    out_pos = np.full(n, -1, dtype=np.int64)
    out_rc = np.zeros(n, dtype=bool)
    out_mis = np.full(n, 255, dtype=np.uint8)
    if n == 0 or index.n_entries == 0 or index.pg_len < L:
        return MatchResult(out_pos, out_rc, out_mis)
    if accept_mis > 0 or os.environ.get("PGRC_TPU_TWO_PASS"):
        raise NotImplementedError("two-pass matching (-l N) is ROADMAP queue 1 item 8")
    if index.pg_len > 0x7FFF0000 - L:
        raise NotImplementedError("pgs past 2^31 symbols need the wide i64 probe "
                                  "(ROADMAP queue 1 item 8)")
    with span(f"match device_index pg={index.pg_len}"):
        ihash, ipos, pg_lanes = device_index(index, pg_codes, device)
    offs = probe_offsets(L, index.k, k2)
    offs_t = torch.tensor(offs, dtype=torch.int32, device=pg_lanes.device)
    n_verify = max(2, min(cap, 6))
    batch = _batch_cap(ihash.numel(), len(offs))
    with span(f"match pack n={n}"):
        lanes, nmask = state.lanes_to_device(*ref_packed.pack_lanes(read_codes),
                                             pg_lanes.device)
        # rows [0, n) forward, [n, 2n) reverse complement
        lanes_fr = torch.cat([lanes, revcomp_lanes(lanes, L, nmask)])
    mis_parts, pos_parts = [], []
    with span(f"match probe rows=2x{n} offs={len(offs)}"):
        for lo in range(0, 2 * n, batch):
            mis_b, pos_b = probe(lanes_fr[lo:lo + batch], offs_t, ihash, ipos,
                                 pg_lanes, index.pg_len, L, index.k,
                                 max_mismatches, n_verify)
            mis_parts.append(mis_b)
            pos_parts.append(pos_b)
        bm, bp = state.match_from_device(torch.cat(mis_parts), torch.cat(pos_parts))
    fm, rm = bm[:n].copy(), bm[n:].copy()
    fp, rp = bp[:n].copy(), bp[n:].copy()

    # interleaved-anchor rescue for reads both strands missed (host, the
    # reference's own pass 3, matcher.py:726-752)
    rows = np.nonzero(np.minimum(fm, rm) == 255)[0]
    k_resc = min(index.k, 16)
    k1_r = 2 if index.pg_len < (4 << 20) else 4 if index.pg_len < (32 << 20) else 8
    if rows.size >= 16 and L >= 2 * k_resc and pg_codes.size >= 2 * k_resc:
        with span(f"match rescue-index rows={rows.size} k1={k1_r}"):
            ridx = _build_rescue_index(pg_codes, k_resc, k1=k1_r)
        im, ip = _interleaved_rescue(read_codes[rows], pg_codes, k_resc,
                                     max_mismatches, k1=k1_r, ridx=ridx)
        better = im < fm[rows]
        fm[rows] = np.where(better, im, fm[rows])
        fp[rows] = np.where(better, ip, fp[rows])
        rc_sub = ref_packed.revcomp_codes_matrix(read_codes[rows])
        rc_sub[rc_sub > 3] = 0
        im, ip = _interleaved_rescue(rc_sub, pg_codes, k_resc, max_mismatches,
                                     ridx=ridx)
        better = im < rm[rows]
        rm[rows] = np.where(better, im, rm[rows])
        rp[rows] = np.where(better, ip, rp[rows])

    take_r = rm < fm  # strict: forward wins ties (deterministic)
    out_mis[:] = np.where(take_r, rm, fm)
    out_pos[:] = np.where(take_r, rp, fp)
    out_rc[:] = take_r & (rm != 255)
    out_pos[out_mis == 255] = -1
    return MatchResult(out_pos, out_rc, out_mis)
