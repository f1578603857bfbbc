"""Read -> pseudogenome matcher on torch: pgrc_tpu/align/matcher.py
`match_reads` (:584-760) on one device.

Per read and strand: hash a k-mer anchor at every probe offset (kernel C),
join the anchors with each block of the pg's sampled k-mer table (kernel B)
so each gets the block's lowest-position index entry of exactly its hash
(B and C write the join's sort keys into one buffer, and the join sorts it),
and verify the first n_verify in-range candidate starts (anchor - offset)
against the packed pg, keeping the (mismatches, position) minimum (kernel
A, which reads the join's anchors itself). Blocks merge by the reference's rule (matcher.py:447-458).
With `accept_mis > 0` (`-l N`) a spread-offset first pass accepts reads
early and only the others fan out (:625-724). Reads both strands missed go
to the reference's interleaved-anchor rescue, on the device: kernel K
builds its candidate table from the packed pg, kernel L takes each read's
best window on both strands (`rescue`). Pgs past 2^31 symbols carry int64
positions (the wide probe). Results are bit-identical to the reference's;
the host pieces (offsets, batch cap) are the port's copy of its own, in
`host.py`. Kernel I writes each pass's rows: every read on both strands
for pass 1, the reads pass 1 did not accept for pass 2.

With a `mesh` of more than one rank (the reference's shard_map probe,
matcher.py:313-348) every rank builds the index and uploads the reads
itself, probes both strands of one contiguous block of each pass's reads
against the whole index, and the ranks' (mis, pos) are gathered in rank
order; the rescue (on each rank's device) and the merge then run on every
rank on the same data.
A read's result does not depend on the rows probed beside it, so the
matches are the one-device matches.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import state
from ..core import packed
from ..kernels.join_carry import JOIN_MAX, join_carry
from ..kernels.kmer_hash import index_keys, index_kmer_hash, probe_kmer_hash
from ..kernels.rescue import POS_BITS, rescue_best, rescue_table
from ..kernels.strand_rows import strand_rows
from ..kernels.verify import verify_best
from ..parallel.mesh import active
from ..utils.trace import count, span
from .host import (  # noqa: F401  (re-exported host layer)
    DEFAULT_CAP, DEFAULT_K2, KmerIndex, MatchResult, _batch_cap, _probe_bucket,
    _spread_offsets, _window_hashes, build_index, probe_offsets)

# index entries per block, the reference's value (matcher.py:466); read at
# call time, so setting it here reaches every call
_MAX_INDEX_BLOCK = 1 << 26


@dataclass
class IndexBlock:
    """One block of the index: `m` entries built by kernel B from lane
    `lane_off` of the packed pg into each join's key buffer (a lazy index),
    or a host-built `table` (ihash int32 bits, ipos) moved to the device
    once."""
    m: int
    lane_off: int = 0
    table: tuple | None = None


def device_index(index: KmerIndex, pg_codes: np.ndarray, device, wide: bool = False,
                 max_block: int | None = None):
    """(blocks, pg_lanes int32, i_pad): the packed pg on `device` and the
    index as a list of `IndexBlock`s, positions int64 when `wide`, else
    int32; i_pad is the reference's padded block size, which sets the batch
    cap.

    Block boundaries are the reference's (matcher.py:537-581), because each
    block's join picks its own lowest-position entry per hash and so decides
    which equally good match a read gets. A lazy index
    (`build_index(..., device_sort=True)`, the encoder's) splits the pg's
    lanes, padded to the reference's pow2 bucket, into uniform blocks, each
    built by kernel B when its join runs (`write_head`), so no block holds
    device memory between joins; a block past the pg's last k-mer holds only
    inert entries and is skipped, as are the inert entries past the pg's
    last lane. A host-built table is cut into `per`-entry blocks and moved
    across."""
    pg_lanes = state.pg_lanes_to_device(pg_codes, device)
    n_lanes = pg_lanes.numel() - 1
    max_block = max_block or _MAX_INDEX_BLOCK
    if index.hash_sorted is None:
        if 16 % index.k1:
            raise ValueError("the device index build needs k1 to divide 16")
        wpf = _probe_bucket(n_lanes + 1)
        n_blocks = max(1, -(-(wpf * 16 // index.k1) // max_block))
        wp = min(_probe_bucket(-(-wpf // n_blocks)), wpf)
        blocks = [IndexBlock((min(lane_off + wp, n_lanes) - lane_off) * 16 // index.k1,
                             lane_off)
                  for lane_off in range(0, wpf, wp)
                  if lane_off * 16 <= index.pg_len - index.k]
        return blocks, pg_lanes, wp * 16 // index.k1
    n_ent = index.pos_sorted.size
    n_blocks = max(1, -(-n_ent // max_block))
    per = -(-max(n_ent, 1) // n_blocks)
    blocks = [IndexBlock(min(per, n_ent - lo), table=state.index_to_device(
        index.hash_sorted[lo:lo + per], index.pos_sorted[lo:lo + per], device, wide))
        for lo in range(0, n_ent, per)]
    return blocks, pg_lanes, _probe_bucket(per)


def write_head(block: IndexBlock, keys: torch.Tensor, ipos_buf: torch.Tensor | None,
               pg_lanes: torch.Tensor, index: KmerIndex, wide: bool) -> torch.Tensor:
    """Write the block's index keys into keys[:block.m], the head of a join's
    key buffer: kernel B for a lazy block (its positions into ipos_buf), a
    plain key composition for a host-built one. -> the block's ipos [m]."""
    m = block.m
    if block.table is None:
        return index_kmer_hash(pg_lanes, index.k, index.k1, index.pg_len, m,
                               block.lane_off, wide, keys[:m], ipos_buf[:m])[1]
    ihash, ipos = block.table
    keys[:m] = index_keys(ihash, ipos)
    return ipos


def join_sort(keys: torch.Tensor, M: int, P: int):
    """The join's sort (matcher.py:228-238): the first M + P composed keys
    of a join's buffer, M index entries (kernel B) then P probes (kernel C),
    whose signed order is the reference's (hash, key2) order. -> (skey,
    perm)."""
    if M + P >= JOIN_MAX:
        raise ValueError(f"join of {M + P} entries overflows the carry pack")
    return torch.sort(keys[:M + P])


def join_anchors(keys: torch.Tensor, ipos: torch.Tensor, P: int):
    """Sort-merge join (matcher.py:225-260) of a key buffer holding the
    M = ipos.numel() index keys, then P probe keys: for each probe, the
    lowest position of an index entry with exactly its hash, + 1 (0 = none),
    [P] int64. After the sort, kernel E (`join_carry`) hands each probe its
    run's minimum position and writes it in probe order."""
    skey, perm = join_sort(keys, ipos.numel(), P)
    return join_carry(skey, perm, ipos, P)


def probe(read_lanes, offs: tuple, keys, ipos, pg_lanes, pg_len: int, L: int,
          k: int, max_mis: int, n_verify: int):
    """Probe + verify of one row batch against one index block
    (matcher.py:208-308). `keys` is the join's key buffer, whose first
    M = ipos.numel() entries hold the block's index keys; kernel C writes
    the R * S probe keys after them. -> (mis uint8, pos) per row, pos int64
    for an int64 (wide) block, else int32."""
    R, S, M = read_lanes.shape[0], len(offs), ipos.numel()
    probe_kmer_hash(read_lanes, offs, k, keys[M:M + R * S])
    res = join_anchors(keys, ipos, R * S).reshape(R, S)
    # kernel A turns the anchors into starts itself: no pass between
    return verify_best(read_lanes, res, offs, pg_lanes, pg_len, L, max_mis, n_verify,
                       ipos.dtype == torch.int64)


def probe_rows(lanes, offs, index: KmerIndex, blocks, pg_lanes, wide: bool, L: int,
               max_mis: int, n_verify: int, batch: int):
    """Probe every row of `lanes` in batches of `batch` rows against every
    index block; per batch the blocks merge by the reference's rule
    (matcher.py:447-458): fewer mismatches win, and on equal mismatches a
    valid position below the current one. One key buffer (the largest
    block, then a batch's probes) and one ipos buffer serve every join of
    the pass. -> (mis uint8, pos int64) on the device."""
    dev = pg_lanes.device
    m_max = max(b.m for b in blocks)
    keys = torch.empty((m_max + min(batch, lanes.shape[0]) * len(offs),),
                       dtype=torch.int64, device=dev)
    ipos_buf = (torch.empty((m_max,), dtype=torch.int64 if wide else torch.int32, device=dev)
                if any(b.table is None for b in blocks) else None)
    mis_parts, pos_parts = [], []
    for lo in range(0, lanes.shape[0], batch):
        rows = lanes[lo:lo + batch]
        best_m = best_p = None
        for block in blocks:
            ipos = write_head(block, keys, ipos_buf, pg_lanes, index, wide)
            mis, pos = probe(rows, offs, keys, ipos, pg_lanes, index.pg_len, L,
                             index.k, max_mis, n_verify)
            pos = pos.to(torch.int64)
            if best_m is None:   # merging into (255, -1) takes the block as it is
                best_m, best_p = mis, pos
                continue
            better = (mis < best_m) | ((mis == best_m) & (pos >= 0)
                                       & ((best_p < 0) | (pos < best_p)))
            best_m = torch.where(better, mis, best_m)
            best_p = torch.where(better, pos, best_p)
        mis_parts.append(best_m)
        pos_parts.append(best_p)
    return torch.cat(mis_parts), torch.cat(pos_parts)


def probe_pass(lanes, nmask, L: int, take, offs, args: tuple, n_verify: int, batch: int,
               mesh=None):
    """One pass over both strands of its reads: the n uploaded reads (take
    None) or those of `take` ([k] int64 on the device), with kernel I's
    rows -> host (mis uint8 [2k], pos int64 [2k]), rows r < k forward, k + r
    reverse complement. Under a mesh each rank probes both strands of its
    block of the pass's reads and the ranks' results are gathered."""
    k = lanes.shape[0] if take is None else take.numel()
    lo, hi = (0, k) if mesh is None else mesh.block(k)
    if hi - lo < k:     # this rank's block of the pass's reads
        if take is None:
            lanes, nmask = lanes[lo:hi], None if nmask is None else nmask[lo:hi]
        else:
            take = take[lo:hi]
    if hi > lo:
        rows = strand_rows(lanes, nmask, L, take)
        mis, pos = probe_rows(rows, offs, *args, n_verify, batch)
        del rows
    else:               # a rank with no reads
        mis, pos = (torch.empty((0,), dtype=d, device=lanes.device)
                    for d in (torch.uint8, torch.int64))
    if mesh is None:
        return state.match_from_device(mis, pos)
    # rank order [fwd_0; rc_0; fwd_1; rc_1; ..] -> [fwd; rc]
    sizes = mesh.splits(k)
    counts = [2 * c for c in sizes]
    got = [mesh.all_gather_parts(a, counts) for a in (mis, pos)]
    return state.match_from_device(*(torch.cat([p[:c] for p, c in zip(parts, sizes)]
                                               + [p[c:] for p, c in zip(parts, sizes)])
                                     for parts in got))


def rescue(read_codes: np.ndarray, pg_codes: np.ndarray, pg_lanes: torch.Tensor, k: int,
           k1: int, max_mis: int):
    """The interleaved-anchor rescue (matcher.py:763-849) of the reads
    `read_codes` [m, L] (1-byte codes) against the pg, on pg_lanes' device:
    kernel K builds the candidate table from the packed pg, kernel L takes
    each read's best window on both strands, the reverse complement's codes
    above 3 as 0. The lanes pack N as A, so a pg that holds a code above 3
    (the encoder's HQ pg never does) is also uploaded as its 1-byte codes,
    which K and L then read in place of the lanes. -> (mis uint8 [2, m],
    pos int64 [2, m]): row 0 forward, row 1 reverse complement, 255 and -1
    where none is within max_mis."""
    dev, pg_len = pg_lanes.device, pg_codes.shape[0]
    with span("match.rescue_index", k1=k1):
        pg_bytes = state.to_device(pg_codes, dev) if pg_codes.max() > 3 else None
        table = rescue_table(pg_lanes, pg_len, k, k1, pg_bytes)
    with span("match.rescue", rows=read_codes.shape[0]):
        codes = state.to_device(np.ascontiguousarray(read_codes), dev)
        best = rescue_best(codes, table, pg_lanes, pg_len, k, k1, min(max_mis, 254), pg_bytes)
        best = state.to_host(best).numpy().reshape(2, -1)
    found = best >= 0
    return (np.where(found, best >> POS_BITS, 255).astype(np.uint8),
            np.where(found, best & ((1 << POS_BITS) - 1), -1))


def match_reads(read_codes: np.ndarray, index: KmerIndex, pg_codes: np.ndarray,
                max_mismatches: int, cap: int = DEFAULT_CAP, k2: int = DEFAULT_K2,
                accept_mis: int = 0, *, force_wide: bool = False,
                index_block: int | None = None, device, mesh=None,
                rows=None) -> MatchResult:
    """Match every read against the indexed pg, both strands.

    With accept_mis <= 0 (the NORMAL level's default) one full-fan-out pass
    probes every read, unless `PGRC_TPU_TWO_PASS` is set, as in the
    reference; otherwise pass 1 probes the k1 spread offsets and verifies
    the first anchor, and only reads with more than accept_mis mismatches on
    both strands fan out in pass 2, which replaces a result only with
    strictly fewer mismatches. N symbols probe as A; the encoder re-verifies
    N rows exactly. pgs past 2^31 symbols take the wide (int64 position)
    probe, which `force_wide` selects on any input; `index_block` overrides
    the entries per index block. With a `mesh` of more than one rank every
    rank calls this on the same input, probes on `mesh.device`, and returns
    the one-device result (the module docstring). The reads are the rows
    of `read_codes`, or with `rows` ([n] ids) read_codes[rows]: they are
    packed through the ids, and only the rescue's few rows are gathered."""
    mesh = active(mesh)
    if mesh is not None:
        device = mesh.device
    n, L = read_codes.shape[0] if rows is None else len(rows), read_codes.shape[1]
    out_pos = np.full(n, -1, dtype=np.int64)
    out_rc = np.zeros(n, dtype=bool)
    out_mis = np.full(n, 255, dtype=np.uint8)
    if n == 0 or index.n_entries == 0 or index.pg_len < L:
        return MatchResult(out_pos, out_rc, out_mis)
    wide = force_wide or index.pg_len > 0x7FFF0000 - L
    if index.pg_len > (1 << 35):
        raise NotImplementedError("pg longer than 2^35 symbols exceeds the "
                                  "35-bit position field of the join")
    with span("match.device_index", pg=index.pg_len):
        blocks, pg_lanes, i_pad = device_index(index, pg_codes, device, wide,
                                               index_block)
    offs_full = probe_offsets(L, index.k, k2)
    single_pass = accept_mis <= 0 and not os.environ.get("PGRC_TPU_TWO_PASS")
    offs_p1 = offs_full if single_pass else _spread_offsets(offs_full, index.k1)
    n_verify2 = max(2, min(cap, 6))
    with span("match.pack", rows=n):
        lanes, nmask = state.lanes_to_device(*packed.pack_lanes(read_codes, rows=rows),
                                             pg_lanes.device)
    args = (index, blocks, pg_lanes, wide, L, max_mismatches)
    # rows [0, n) forward, [n, 2n) reverse complement (kernel I)
    with span("match.pass1", rows=2 * n, offs=len(offs_p1), blocks=len(blocks)):
        bm, bp = probe_pass(lanes, nmask, L, None, offs_p1, args,
                            n_verify2 if single_pass else 1,
                            _batch_cap(i_pad, len(offs_p1)), mesh)
    fm, rm = bm[:n].copy(), bm[n:].copy()
    fp, rp = bp[:n].copy(), bp[n:].copy()

    # pass 2: the full fan-out on both strands of the reads pass 1 did not
    # accept (matcher.py:696-724); kernel I's take form is the reference's
    # p2gather: [rows forward; rows reverse complement]
    p2 = (np.zeros(0, dtype=np.int64) if single_pass
          else np.nonzero(np.minimum(fm, rm) > accept_mis)[0])
    if p2.size:
        k = p2.size
        with span("match.pass2", rows=2 * k, offs=len(offs_full), blocks=len(blocks)):
            take = state.to_device(p2, pg_lanes.device)
            mis_t, pos_t = probe_pass(lanes, nmask, L, take, offs_full, args, n_verify2,
                                      _batch_cap(i_pad, len(offs_full)), mesh)
        better_f = mis_t[:k] < fm[p2]
        fm[p2] = np.where(better_f, mis_t[:k], fm[p2])
        fp[p2] = np.where(better_f, pos_t[:k], fp[p2])
        better_r = mis_t[k:] < rm[p2]
        rm[p2] = np.where(better_r, mis_t[k:], rm[p2])
        rp[p2] = np.where(better_r, pos_t[k:], rp[p2])

    # interleaved-anchor rescue for reads both strands missed (the
    # reference's own pass 3, matcher.py:726-752), on the device
    missed = np.nonzero(np.minimum(fm, rm) == 255)[0]
    k_resc = min(index.k, 16)
    k1_r = 2 if index.pg_len < (4 << 20) else 4 if index.pg_len < (32 << 20) else 8
    if missed.size >= 16 and L >= 2 * k_resc and pg_codes.size >= 2 * k_resc:
        resc = read_codes[missed if rows is None else rows[missed]]
        (im, rim), (ip, rip) = rescue(resc, pg_codes, pg_lanes, k_resc, k1_r, max_mismatches)
        del resc
        count("rescue.rows", missed.size)
        count("rescue.found", int(((im != 255) | (rim != 255)).sum()))
        better = im < fm[missed]
        fm[missed] = np.where(better, im, fm[missed])
        fp[missed] = np.where(better, ip, fp[missed])
        better = rim < rm[missed]
        rm[missed] = np.where(better, rim, rm[missed])
        rp[missed] = np.where(better, rip, rp[missed])

    take_r = rm < fm  # strict: forward wins ties (deterministic)
    out_mis[:] = np.where(take_r, rm, fm)
    out_pos[:] = np.where(take_r, rp, fp)
    out_rc[:] = take_r & (rm != 255)
    out_pos[out_mis == 255] = -1
    return MatchResult(out_pos, out_rc, out_mis)
