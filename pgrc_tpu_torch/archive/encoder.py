"""PGTC encoder chain on torch — the 7-stage pipeline of
pgrc_tpu/archive/encoder.py (`encode` + `_encode_tail`, :102-506).

The chain is repeated here, calling the port's sweep and matcher
(`overlap.greedy_scs`, `align.matcher`) on an explicit `device`, and with
`mesh=` over a group of ranks, as the reference's `encode(mesh=)` does. The helpers around it — `EncodeStats`, the validation dumps, the
checkpoints, the stage-7 self-match, the report row and the hq and plain
reads-list writers (:40-101, :380-394, :509-613) — are a copy of the
reference's with only the imports changed, and the stream writers,
`pgseq` and `order` are the port's copies of the reference's modules, so
the archive bytes are the reference's own.
"""
from __future__ import annotations

import contextlib
import io
import os
from dataclasses import dataclass, field

import numpy as np

from .. import ARCHIVE_MAGIC, kernels
from ..align import matcher as align_matcher
from ..config import (MODE_MIN_PE, MODE_ORD_PE, MODE_ORD_SE, MODE_PE,
                      PgRCParams, matching_chars_correction)
from ..core import fastq, packed
from ..overlap import greedy_scs
from ..pg.reconstruct import extract_mismatches
from ..streams import props
from ..streams.container import write_streams
from ..utils import dna, rss, trace
from ..utils.trace import span
from ..utils.varint import write_varint
from . import chain
from . import order as order_enc
from . import pgseq


def _dump_validation(params: PgRCParams, name: str, **arrays) -> None:
    """-V mode: write per-stage artifacts next to the archive for external
    diffing (reference extraFilesForValidation, pgrc-params.h:46; .div
    files readsset/iterator/ReadsSetIterator.cpp saveMapping, pg dumps
    pgrc-encoder.cpp:228-234). Index lists go out as one-number-per-line
    text, sequences as ACGTN lines, tables as TSV."""
    if not params.dump_validation_files:
        return
    import os

    d = params.output + ".validation"
    os.makedirs(d, exist_ok=True)
    for key, arr in arrays.items():
        path = os.path.join(d, f"{name}_{key}")
        if key.endswith("pg"):
            with open(path + ".txt", "wb") as f:
                f.write(dna.VAL2SYM[arr].tobytes())
                f.write(b"\n")
        elif arr.ndim == 2:
            np.savetxt(path + ".tsv", arr, fmt="%d", delimiter="\t")
        else:
            np.savetxt(path + ".div", arr.reshape(-1, 1), fmt="%d")


@dataclass
class EncodeStats:
    reads_total: int = 0
    read_len: int = 0
    hq_count: int = 0
    lq_count: int = 0
    n_count: int = 0
    matched_count: int = 0
    hq_pg_len: int = 0
    lq_pg_len: int = 0
    n_pg_len: int = 0
    archive_bytes: int = 0
    # each stage's seconds: the duration of its span, keyed and ordered
    # input, div, pgdiv, good, match, bad, order, pgseq
    stage_times: dict = None
    # each stage's own peak RSS in MB, under PGRC_TPU_RSS_TRACE (else None)
    stage_rss_mb: dict = None
    peaks: rss.StagePeaks = field(default=None, repr=False, compare=False)
    # the encode's recorder, exported (`utils.trace.Recorder.export`): its
    # spans, and its counters (h2d_bytes, h2d_copies, d2h_bytes,
    # device_syncs, launch.<kernel>, pgmatch.index_builds, ...)
    spans: list = field(default=None, repr=False, compare=False)
    counters: dict = field(default=None, repr=False, compare=False)


# checkpoint persistence delegates to the chain module, which owns the
# shared chain-state object and the per-stage schema (pgrc-data.h role)
_ckpt_path = chain.ckpt_path
_save_ckpt = chain.save_ckpt
_load_ckpt = chain.load_ckpt


@contextlib.contextmanager
def _stage(stats: EncodeStats, key: str):
    """A stage's span; its duration is stage_times[key]. With
    PGRC_TPU_RSS_TRACE=1, also the stage's own peak RSS
    (`utils.rss.StagePeaks`, from the encode's start or the last stage's
    end), taken as the span closes and printed beside the resident size
    at its end."""
    with span(key) as sp:
        yield
    stats.stage_times[key] = sp.seconds
    if stats.peaks is not None:
        peak = stats.stage_rss_mb[key] = stats.peaks.take()
        print(f"[rss] {key}: peak {peak} MB, at its end {rss.rss_now_mb():.1f} MB",
              flush=True)


def _submit_self_match(params, hq_pg):
    """Start the stage-7 hq self-match in a worker thread (None when the
    pg is below the match threshold or the chain stops before stage 7)."""
    if params.end_stage < 7 or len(hq_pg) < params.target_pg_match_length:
        return None
    from . import pg_match

    return trace.start_thread("selfmatch", pg_match.self_match_precompute, hq_pg,
                              params.target_pg_match_length)


def encode(params: PgRCParams, out_path: str | None = None, *, device,
           mesh=None) -> EncodeStats:
    """Run the 7-stage encoder chain with the device stages on `device`.

    With `mesh` (`parallel.mesh.Mesh`) every rank runs the chain on the same
    input: the sweeps (stages 2, 3 and 5) and the matcher (stage 4) run
    sharded over the ranks, the host stages run on every rank, and every
    rank writes the archive it is given, byte-identical to the one-device
    archive (pgrc_tpu/archive/encoder.py:102-107). With PGRC_TPU_RSS_TRACE
    set, each stage's own peak RSS goes to `stage_rss_mb` and is printed.
    The encode is one recorder (`utils.trace`), its root span `encode`; its
    spans and counters come back in `spans` and `counters`."""
    launched = dict(kernels.launches)
    with trace.record("encode") as rec:
        peaks = rss.StagePeaks() if os.environ.get("PGRC_TPU_RSS_TRACE") else None
        try:
            stats = _encode(params, out_path, device=device, mesh=mesh, peaks=peaks)
        finally:
            if peaks is not None:
                peaks.close()
        for name, n in kernels.launches.items():
            if n != launched.get(name, 0):
                rec.count("launch." + name, n - launched.get(name, 0))
    got = rec.export()
    stats.spans, stats.counters = got["spans"], got["counters"]
    return stats


def _encode(params: PgRCParams, out_path, *, device, mesh, peaks) -> EncodeStats:
    if params.end_stage == 6:
        # the chain has no stage-6 checkpoint, and an archive cut after
        # stage 6 lacks the stage-7 pg streams and cannot be decoded (the
        # reference writes one and raises nothing, its encoder.py:434-442)
        raise ValueError("-E 6 is not supported: end the chain at stage 5 "
                         "(a checkpoint) or 7 (the archive)")
    t = {}
    stats = EncodeStats(stage_times=t, stage_rss_mb=None if peaks is None else {},
                        peaks=peaks)
    B, E = params.begin_stage, params.end_stage

    # ---- input (chunked: quality bytes never outlive one IO window) ----
    with _stage(stats, "input"):
        params.resolve()
        if params.dump_streams:
            from ..streams import container as _container

            _container.set_stream_dump_dir(params.output + ".streams")
        if params.verbosity:
            from ..utils import logchan

            logchan.set_verbosity(params.verbosity)
        ck = _load_ckpt(params, B - 1) if B > 1 else {}
        reads = fastq.read_divided(
            params.src_fastq, params.pair_fastq or None, params.revcomp_pair_file,
            params.error_limit_promils / 1000.0, params.simplified_suffix_mode,
        )
        params.read_len = reads.read_len
        L = reads.read_len
        if L > 255:
            raise ValueError("constant-length reads up to 255 bp supported (reference parity)")
        n_total = reads.count
        stats.reads_total, stats.read_len = n_total, L

    # ---- stage 1: quality division ----
    with _stage(stats, "div"):
        codes = reads.codes
        if B <= 1:
            hq_mask = reads.hq_mask
            n_mask = reads.n_mask
            if params.separate_n_reads:
                n_idx = np.nonzero(n_mask)[0]
                lq_idx = np.nonzero(~n_mask & ~hq_mask)[0]
                hq_idx = np.nonzero(~n_mask & hq_mask)[0]
            else:
                # N reads always go to LQ (reference nReadsLQ / !separateNReads path)
                n_idx = np.zeros(0, dtype=np.int64)
                lq_idx = np.nonzero(n_mask | ~hq_mask)[0]
                hq_idx = np.nonzero(~n_mask & hq_mask)[0]
        else:
            empty = np.zeros(0, dtype=np.int64)
            hq_idx = ck.get("hq_idx", empty)
            lq_idx = ck.get("lq_idx", empty)
            n_idx = ck.get("n_idx", empty)
    if E == 1:
        _save_ckpt(params, 1, hq_idx=hq_idx, lq_idx=lq_idx, n_idx=n_idx)
        return stats

    # ---- stages 2+3: generator-based division + HQ pg generation, fused
    # into one full-depth sweep when both run in this invocation ----
    with _stage(stats, "pgdiv"):
        fused = None
        if B <= 2:
            if params.gen_quality_coef > 0 and hq_idx.size > 1:
                if E >= 3:
                    keep, *fused = greedy_scs.divide_and_generate(
                        codes, params.gen_quality_coef, device=device, mesh=mesh,
                        rows=hq_idx)
                else:
                    res = greedy_scs.find_overlaps(
                        codes, coef=params.gen_quality_coef, device=device,
                        mesh=mesh, rows=hq_idx)
                    keep = greedy_scs.both_sides_overlapped(res)
                lq_idx = np.concatenate([lq_idx, hq_idx[~keep]])
                lq_idx.sort()
                hq_idx = hq_idx[keep]
    _dump_validation(params, "stage2", hq_idx=hq_idx, lq_idx=lq_idx,
                     n_idx=n_idx)
    if E == 2:
        _save_ckpt(params, 2, hq_idx=hq_idx, lq_idx=lq_idx, n_idx=n_idx)
        return stats

    # ---- stage 3: HQ pg generation ----
    with _stage(stats, "good"):
        if fused is not None:
            (hq_pg, hq_order, hq_pos), fused = fused, None
            hq_org = hq_idx[hq_order] if hq_idx.size else np.zeros(0, dtype=np.int64)
            del hq_order
        elif B <= 3:
            hq_pg, hq_order, hq_pos = greedy_scs.generate_pseudogenome(
                codes, device=device, mesh=mesh, rows=hq_idx)
            hq_org = hq_idx[hq_order] if hq_idx.size else np.zeros(0, dtype=np.int64)
            del hq_order
        else:
            hq_pg = ck["hq_pg"]
            hq_org = ck.get("hq_org", np.zeros(0, dtype=np.int64))
            hq_pos = ck.get("hq_pos", np.zeros(0, dtype=np.int64))
    _dump_validation(params, "stage3", hq_pg=hq_pg)
    if E == 3:
        _save_ckpt(params, 3, hq_idx=hq_idx, lq_idx=lq_idx, n_idx=n_idx,
                   hq_pg=hq_pg, hq_org=hq_org, hq_pos=hq_pos)
        return stats
    # the stage-7 hq self-match runs in a worker thread, overlapping stage 4
    s7_fut = _submit_self_match(params, hq_pg)

    # ---- stage 4: map LQ (and N) reads onto HQ pg ----
    if B > 4:
        hq_entries = {k[2:]: ck[k] for k in ck if k.startswith("e_")}
        stats.matched_count = int(ck["matched_count"])
        stats.hq_count = hq_entries["org"].size
        t["match"] = 0.0
        empty = np.zeros(0, dtype=np.int64)
        stage5 = None
        if "lq_pg" in ck:  # B = 6: stage-5 outputs come from the ckpt too
            stage5 = (ck["lq_pg"], ck["lq_org"], ck["lq_pos"],
                      ck["n_pg"], ck["n_org"], ck["n_pos"])
        lq_un_ck = ck.get("lq_un", empty)
        n_un_ck = ck.get("n_un", empty)
        lq_codes, n_codes = codes[lq_un_ck], codes[n_un_ck]
        reads.codes = None
        del codes
        return _encode_tail(params, stats, lq_codes, n_codes, hq_pg,
                            hq_entries, lq_un_ck, n_un_ck,
                            out_path, stage5, device=device, mesh=mesh, s7_fut=s7_fut)

    with _stage(stats, "match"):
        cand_idx = np.concatenate([lq_idx, n_idx]) if params.separate_n_reads else lq_idx
        n_begin = lq_idx.size
        if cand_idx.size and hq_pg.size >= L:
            k = params.seed_k + matching_chars_correction(len(hq_pg))
            k = min(k, L)
            # the candidates stay ids into `codes`: the matcher packs them
            # through the ids, and each step below gathers only its own rows
            with span("match.n_scan", rows=cand_idx.size):
                has_n = packed.rows_with_n(codes, cand_idx)
            max_mis = L // params.min_chars_per_mismatch
            with span("match.host_index", pg=len(hq_pg)):
                index = align_matcher.build_index(hq_pg, k=k, device_sort=True)
            # reads with N probe with N->A (2-bit packing collapses N); their true
            # mismatch count is restored by an exact re-verify below
            mres = align_matcher.match_reads(
                codes, index, hq_pg,
                max_mismatches=max_mis,
                cap=params.match_cap,
                accept_mis=params.prematch_accept_mis,
                device=device,
                mesh=mesh,
                rows=cand_idx,
            )
            with span("match.n_reverify") as sp:
                if has_n.any():
                    rows = np.nonzero(has_n & (mres.pos >= 0))[0]
                    sp.attrs["rows"] = rows.size
                    if rows.size:
                        win = hq_pg[mres.pos[rows, None]
                                    + np.arange(L, dtype=np.int64)[None, :]].copy()
                        rc = mres.rc[rows]
                        win[rc] = packed.revcomp_codes_matrix(win[rc])
                        true_mis = (codes[cand_idx[rows]] != win).sum(axis=1)
                        bad = true_mis > max_mis
                        mres.pos[rows[bad]] = -1
                        mres.mis[rows[bad]] = 255
                        mres.mis[rows[~bad]] = true_mis[~bad].astype(np.uint8)
            matched = mres.pos >= 0
        else:
            matched = np.zeros(cand_idx.size, dtype=bool)
            mres = align_matcher.MatchResult(
                np.full(cand_idx.size, -1, np.int64),
                np.zeros(cand_idx.size, bool),
                np.full(cand_idx.size, 255, np.uint8),
            )
        stats.matched_count = int(matched.sum())

        m_org = cand_idx[matched]
        m_pos = mres.pos[matched]
        m_rc_stored = mres.rc[matched]
        # final-output coordinates: pair-file reads are un-revcomped on output
        if params.revcomp_pair_file:
            odd = (m_org & 1) == 1
            m_rc_out = m_rc_stored ^ odd
        else:
            m_rc_out = m_rc_stored.copy()
        # the target read in final-output orientation (a pair-file read of -r
        # reverse complemented) against its window in decoder orientation; the
        # native pass reads the rows of `codes` through m_org and flips the
        # odd ones itself, so the matched rows are never copied out
        with span("match.extract_mismatches", rows=m_pos.size):
            if m_pos.size:
                from .. import native

                fast = native.extract_mismatches(
                    hq_pg, m_pos, m_rc_out, codes, L // params.min_chars_per_mismatch,
                    rows=m_org, flip_odd=params.revcomp_pair_file)
                if fast is not None:
                    m_cnt, m_sym, m_off = fast
                else:
                    m_codes_out = codes[m_org]
                    if params.revcomp_pair_file:
                        odd_rows = (m_org & 1) == 1
                        m_codes_out[odd_rows] = packed.revcomp_codes_matrix(m_codes_out[odd_rows])
                    win = hq_pg[m_pos[:, None] + np.arange(L, dtype=np.int64)[None, :]].copy()
                    if m_rc_out.any():
                        win[m_rc_out] = packed.revcomp_codes_matrix(win[m_rc_out])
                    m_cnt, m_sym, m_off = extract_mismatches(
                        m_codes_out, win, L // params.min_chars_per_mismatch
                    )
            else:
                m_cnt = np.zeros(0, np.uint8)
                m_sym = np.zeros(0, np.uint8)
                m_off = np.zeros(0, np.uint8)

        # build combined hq reads-list entries: base reads + matched reads
        with span("match.entries_merge", rows=hq_org.size + m_org.size):
            base_cnt = hq_org.size
            # base entries are embedded in the pg in STORED orientation; in
            # final-output coordinates a pair-file (odd-org) base read must be
            # emitted rev-complemented
            if params.revcomp_pair_file:
                base_rc = (hq_org & 1) == 1
            else:
                base_rc = np.zeros(base_cnt, bool)
            # entry order: by position, matched before base at equal pos (a stable
            # sort); each entry column is gathered in that order and its
            # concatenation dropped at once, so at most one column is held twice
            n_matched = m_org.size
            all_pos = np.concatenate([hq_pos, m_pos])
            is_base = np.concatenate([np.ones(base_cnt, np.uint8), np.zeros(n_matched, np.uint8)])
            perm = np.lexsort((is_base, all_pos))
            del is_base, hq_pos, m_pos
            hq_entries = dict(pos=all_pos[perm])
            del all_pos
            hq_entries["org"] = np.concatenate([hq_org, m_org])[perm]
            del hq_org, m_org
            hq_entries["rc"] = np.concatenate([base_rc, m_rc_out])[perm]
            hq_entries["mis_cnt"] = np.concatenate([np.zeros(base_cnt, np.uint8), m_cnt])[perm]
            # reorder flat mismatch streams to entry order (base rows contribute 0)
            mis_src_cum = np.zeros(base_cnt + n_matched + 1, dtype=np.int64)
            np.cumsum(np.concatenate([np.zeros(base_cnt, np.uint8), m_cnt]), out=mis_src_cum[1:])
            hq_entries["mis_sym"], hq_entries["mis_off"] = _gather_flat_mismatches(
                perm, hq_entries["mis_cnt"], mis_src_cum, m_sym, m_off
            )
            del perm, mis_src_cum
            stats.hq_count = base_cnt + n_matched
        unmatched = ~matched
        lq_un = cand_idx[unmatched & (np.arange(cand_idx.size) < n_begin)]
        n_un = cand_idx[unmatched & (np.arange(cand_idx.size) >= n_begin)]
    if params.dump_validation_files and cand_idx.size:
        _dump_validation(
            params, "stage4",
            matches=np.stack([cand_idx, mres.pos,
                              mres.rc.astype(np.int64),
                              mres.mis.astype(np.int64)], axis=1),
        )
    del mres, cand_idx
    if E == 4:
        _save_ckpt(params, 4, lq_un=lq_un, n_un=n_un,
                   matched_count=np.int64(stats.matched_count),
                   e_pos=hq_entries["pos"], e_org=hq_entries["org"],
                   e_rc=hq_entries["rc"], e_mis_cnt=hq_entries["mis_cnt"],
                   e_mis_sym=hq_entries["mis_sym"], e_mis_off=hq_entries["mis_off"],
                   hq_pg=hq_pg)
        return stats
    # gather the (small) unmatched subsets and release the full code matrix
    lq_codes, n_codes = codes[lq_un], codes[n_un]
    reads.codes = None
    del codes
    return _encode_tail(params, stats, lq_codes, n_codes, hq_pg,
                        hq_entries, lq_un, n_un, out_path, device=device, mesh=mesh,
                        s7_fut=s7_fut)


def _encode_tail(params, stats, lq_codes, n_codes, hq_pg, hq_entries,
                 lq_un, n_un, out_path, stage5=None, *, device, mesh=None, s7_fut=None):
    """Stage 5 (LQ/N pgs) + archive write (stages 6-7). Receives only the
    unmatched-read code subsets — the full matrix is freed by the caller."""
    L = stats.read_len
    n_total = stats.reads_total

    # ---- stage 5: LQ pg and N pg from unmatched reads ----
    with _stage(stats, "bad"):
        if stage5 is not None:
            lq_pg, lq_org, lq_pos, n_pg, n_org, n_pos = stage5
        else:
            with span("bad.pg", pg="lq", rows=lq_codes.shape[0]):
                lq_pg, lq_order, lq_pos = greedy_scs.generate_pseudogenome(
                    lq_codes, device=device, mesh=mesh)
            lq_org = lq_un[lq_order] if lq_un.size else np.zeros(0, dtype=np.int64)
            with span("bad.pg", pg="n", rows=n_codes.shape[0]):
                n_pg, n_order, n_pos = greedy_scs.generate_pseudogenome(
                    n_codes, device=device, mesh=mesh)
            n_org = n_un[n_order] if n_un.size else np.zeros(0, dtype=np.int64)
        stats.lq_count, stats.n_count = lq_org.size, n_org.size
        stats.hq_pg_len, stats.lq_pg_len, stats.n_pg_len = len(hq_pg), len(lq_pg), len(n_pg)
    if params.end_stage == 5:
        _save_ckpt(params, 5, lq_pg=lq_pg, lq_org=lq_org, lq_pos=lq_pos,
                   n_pg=n_pg, n_org=n_org, n_pos=n_pos, hq_pg=hq_pg,
                   matched_count=np.int64(stats.matched_count),
                   e_pos=hq_entries["pos"], e_org=hq_entries["org"],
                   e_rc=hq_entries["rc"], e_mis_cnt=hq_entries["mis_cnt"],
                   e_mis_sym=hq_entries["mis_sym"], e_mis_off=hq_entries["mis_off"])
        return stats

    # ---- write archive ----
    # stage 7 (pg sequences) is compressed in a worker thread concurrently
    # with the hq-section/order compression; its buffer is spliced at the
    # end. The writer takes the stage-7 self-match's result: the main
    # thread waits for it here
    s7_buf = io.BytesIO()
    s7_write = None
    if params.end_stage >= 7:
        with span("selfmatch.wait"):
            pre = s7_fut.result() if s7_fut is not None else None
        s7_write = trace.start_thread(
            "pgseq", pgseq.write_pg_sequences, s7_buf, hq_pg, lq_pg, n_pg,
            params.target_pg_match_length, params.compression_level, pre)
        del pre
    with _stage(stats, "order"):
        mode = params.mode()
        ord_mode = mode in (MODE_ORD_SE, MODE_ORD_PE)
        out = io.BytesIO()
        with span("order.hq_section", entries=stats.hq_count):
            header = bytearray()
            header += ARCHIVE_MAGIC
            header += bytes([1, 1, mode])
            flags = (1 if params.separate_n_reads else 0) | (2 if params.revcomp_pair_file else 0)
            header.append(flags)
            write_varint(header, L)
            write_varint(header, n_total)
            write_varint(header, stats.hq_count)
            write_varint(header, lq_org.size)
            write_varint(header, n_org.size)
            write_varint(header, len(hq_pg))
            write_varint(header, len(lq_pg))
            write_varint(header, len(n_pg))
            out.write(bytes(header))
            if ord_mode:
                with span("order.hq_entry_perm", entries=stats.hq_count):
                    entry_perm = np.argsort(hq_entries["org"], kind="stable")
            else:
                entry_perm = np.arange(stats.hq_count)
            _write_hq_section(out, hq_entries, entry_perm, store_off=not ord_mode,
                              read_len=L, rev_offsets=params.rev_offset_mismatches)
        with span("order.pg_sections"):
            _write_plain_pg_section(out, lq_pos)
            if params.separate_n_reads:
                _write_plain_pg_section(out, n_pos)

        # ---- stage 6: order info ----
        with span("order.order_info"):
            if mode in (MODE_PE, MODE_MIN_PE):
                joined_org = np.concatenate([hq_entries["org"], lq_org, n_org])
                order_enc.encode_pair_order(out, joined_org,
                                            store_file_flags=(mode == MODE_PE))
            elif ord_mode:
                with span("order.ord_positions", reads=n_total) as sp:
                    pos_by_org = np.zeros(n_total, dtype=np.int64)
                    pos_by_org[hq_entries["org"]] = hq_entries["pos"]
                    pos_by_org[lq_org] = lq_pos + len(hq_pg)
                    pos_by_org[n_org] = n_pos + len(hq_pg) + len(lq_pg)
                    sp.attrs["wide"] = int(order_enc.wide_positions(pos_by_org))
                if mode == MODE_ORD_PE:
                    order_enc.encode_positions_pe(out, pos_by_org)
                else:
                    order_enc.encode_positions_se(out, pos_by_org)

    # ---- stage 7: pg sequences (compressed concurrently above) ----
    with _stage(stats, "pgseq"):
        if s7_write is not None:
            with span("pgseq.wait"):
                s7_write.result()
            out.write(s7_buf.getvalue())

    with span("write_archive") as sp:
        blob = out.getvalue()
        stats.archive_bytes = sp.attrs["bytes"] = len(blob)
        if out_path is None:
            out_path = params.output
        tmp = out_path + ".temp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, out_path)
    if params.report_path:
        with span("report"):
            _append_report(params, stats)
    return stats


def _append_report(params: PgRCParams, stats: EncodeStats) -> None:
    """Append a TSV benchmark row (reference generateReport,
    pgrc-encoder.cpp:467-495: sizes + per-stage seconds to pgrc_res.txt)."""
    import os

    t = stats.stage_times
    header = ("src\treads\tlen\tsize[B]\tbits/base\ttotal[s]\tdiv\tpgdiv\tgood\t"
              "match\tbad\torder\tpgseq\n")
    row = (
        f"{os.path.basename(params.src_fastq)}\t{stats.reads_total}\t{stats.read_len}\t"
        f"{stats.archive_bytes}\t"
        f"{stats.archive_bytes * 8 / max(stats.reads_total * stats.read_len, 1):.4f}\t"
        f"{sum(t.values()):.2f}\t" +
        "\t".join(f"{t.get(k, 0.0):.2f}" for k in
                  ("div", "pgdiv", "good", "match", "bad", "order", "pgseq")) + "\n"
    )
    new = not os.path.exists(params.report_path)
    with open(params.report_path, "a") as f:
        if new:
            f.write(header)
        f.write(row)


def _gather_flat_mismatches(perm, mis_cnt_perm, src_cum, m_sym, m_off):
    """Reorder flat mismatch streams to the permuted entry order; only the
    entries with mismatches are indexed."""
    if m_sym.size == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
    # for each permuted entry with mismatches, gather its src slice
    rows = np.nonzero(mis_cnt_perm)[0]
    counts = mis_cnt_perm[rows].astype(np.int64)
    total = int(counts.sum())
    starts_src = src_cum[perm[rows]]
    out_row = np.repeat(np.arange(rows.size), counts)
    within = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    src_flat = starts_src[out_row] + within
    return m_sym[src_flat], m_off[src_flat]


def _write_hq_section(out, entries, entry_perm, store_off: bool,
                      read_len: int, rev_offsets: bool = True) -> None:
    """HQ reads-list streams with the reference's v1.3-style decomposition
    (SeparatedPseudoGenomePersistence.cpp compressedBuild +
    compressRlMisRevOffDest): zero/non-zero mismatch-count split, exclusive
    symbol codes with global frequency reordering, reversed delta-from-end
    offsets in per-count substreams (fixed-count streams transposed).

    `rev_offsets=False` (dev flag -A, the reference's
    enableRevOffsetMismatchesRepresentation toggle, PgRC.cpp) stores plain
    ascending offsets instead; the choice is recorded in the section's
    flags byte."""
    from ..streams import mismatch as mm

    pos = entries["pos"][entry_perm]
    rc = entries["rc"][entry_perm]
    mis_cnt = entries["mis_cnt"][entry_perm]
    src_cum = np.zeros(entries["mis_cnt"].size + 1, dtype=np.int64)
    np.cumsum(entries["mis_cnt"], out=src_cum[1:])
    sym, off = _gather_flat_mismatches(
        entry_perm, mis_cnt, src_cum, entries["mis_sym"], entries["mis_off"]
    )
    # exclusive codes under a global symbol-frequency order
    pg_vals = (sym >> 4).astype(np.uint8)
    read_vals = (sym & 0x0F).astype(np.uint8)
    order = mm.symbol_order(read_vals)
    exc = mm.exclusive_encode(pg_vals, read_vals, order)
    # reversed gap-from-end offsets, split per mismatch count
    if rev_offsets:
        stored_off = mm.rev_offset_encode(mis_cnt, off, read_len)
    else:
        stored_off = off.astype(np.uint8 if read_len <= 256 else np.uint16)
    off_streams = mm.split_by_count(mis_cnt, stored_off)

    # raw props blob: symbol order + substream limit + flags byte
    out.write(bytes(order.tobytes()) + bytes([mm.COUNT_STREAM_LIMIT])
              + bytes([1 if rev_offsets else 0]))

    jobs = []
    if store_off:
        deltas = np.empty(pos.size, dtype=np.int64)
        if pos.size:
            deltas[0] = pos[0]
            deltas[1:] = pos[1:] - pos[:-1]
        if deltas.max(initial=0) > 255:
            raise ValueError("hq reads-list delta exceeds 255 (pg gap)")
        jobs.append(props.job("hq_off", "hq off",
                              deltas.astype(np.uint8).tobytes()))
    jobs.append(props.job("hq_rc", "hq rc", rc.astype(np.uint8).tobytes()))
    jobs.append(props.job("hq_mis_zero_flags", "hq mis zero flags",
                          (mis_cnt > 0).astype(np.uint8).tobytes()))
    jobs.append(props.job("hq_mis_cnt_values", "hq mis cnt values",
                          mis_cnt[mis_cnt > 0].tobytes()))
    jobs.append(props.job("hq_mis_sym", "hq mis sym", exc.tobytes()))
    for m, s in enumerate(off_streams, start=1):
        jobs.append(props.job("hq_mis_off", f"hq mis off [{m}]", s))
    write_streams(out, jobs)


def _write_plain_pg_section(out, pos: np.ndarray) -> None:
    """off deltas of an lq/N pg reads list (no rc, no mismatches)."""
    deltas = np.empty(pos.size, dtype=np.int64)
    if pos.size:
        deltas[0] = pos[0]
        deltas[1:] = pos[1:] - pos[:-1]
    assert deltas.max(initial=0) <= 255
    write_streams(out, [props.job("pg_off", "pg off",
                                  deltas.astype(np.uint8).tobytes())])
