"""Compression parameters and mode constants.

Mirrors PgRCParams (pgrc/pgrc-params.h:37-318) — the same knobs with the same
NORMAL-level defaults (q=120 permil, g=65%, seed 38+pg-size correction, M=3,
p=45) — for our PGTC archive.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# archive modes (byte values in the PGTC header)
MODE_SE = 0
MODE_PE = 1
MODE_ORD_SE = 2
MODE_ORD_PE = 3
MODE_MIN_PE = 4

LEVEL_FAST = 1
LEVEL_NORMAL = 2
LEVEL_MAX = 3


@dataclass
class PgRCParams:
    src_fastq: str = ""
    pair_fastq: str = ""
    output: str = "out.pgtc"
    preserve_order: bool = False
    single_reads_mode: bool = False
    ignore_pair_order: bool = False
    compression_level: int = LEVEL_NORMAL

    # Level-tunable knobs use None = "not explicitly set"; resolve() fills
    # them from the level preset. An explicitly passed value always wins —
    # the reference's first-write-wins setters (pgrc-params.h:190-281:
    # setters no-op when already set, level defaults applied later in
    # initCompressionParameters :115-151).

    # quality-based division (stage 1)
    error_limit_promils: int | None = None        # NORMAL: 120
    simplified_suffix_mode: bool = True
    separate_n_reads: bool = True
    n_reads_lq: bool = False

    # generator division (stage 2)
    gen_quality_coef: float | None = None         # NORMAL: 0.65

    # matching (stage 4)
    seed_k: int = 32                # k-mer seed length (readsExactMatchingChars role)
    min_chars_per_mismatch: int | None = None     # NORMAL: 3 (maxMismatches = L // this)
    match_cap: int | None = None                  # NORMAL: 8

    # pg-vs-pg final matching (stage 7)
    target_pg_match_length: int | None = None     # NORMAL: 45

    # PE pair handling
    disable_revcomp_pair: bool = False

    # dev representation toggles (reference -A: disable rev-offset mismatch
    # representation, PgRC.cpp enableRevOffsetMismatchesRepresentation) and
    # the pass-1 accept threshold behind the reference's -l prematch level
    # (our matcher's two-phase structure IS the prematch re-design: pass 1
    # is the cheap prematch, pass 2 the full matcher). Only EXACT pass-1
    # hits are final: r4 measurements on the 200k bench show accept=1
    # costs +7.4 KB archive (0.1387 -> 0.1417 b/b) while the v2 matcher's
    # confirmed-anchor-capped pass-2 makes accept=0 no slower (the full
    # fan-out now verifies at most `cap` confirmed windows per read).
    rev_offset_mismatches: bool = True
    prematch_accept_mis: int = 0

    # observability
    verbosity: int = 0              # 0 app, 1 +dev stream logs, 2 +trace
    report_path: str = ""           # append a TSV row per run (pgrc_res.txt role)
    # validation dump modes (reference -V extraFilesForValidation,
    # pgrc-params.h:46, and the stream-dump debugging role of
    # coders/CodersLib.cpp:12-15): -V writes per-stage artifacts (division
    # index lists, pg sequences, match table) next to the archive; -T also
    # dumps every compressed stream's raw bytes for external diffing
    dump_validation_files: bool = False
    dump_streams: bool = False

    # stage bisection (reference -B/-E, pgrc-params.h:299-317): run stages
    # begin_stage..end_stage of the 7-stage chain, loading/persisting
    # intermediate state in tmp_work_dir
    begin_stage: int = 1
    end_stage: int = 7
    tmp_work_dir: str = ""

    # chain state
    read_len: int = 0
    revcomp_pair_file: bool = False

    def mode(self) -> int:
        if self.single_reads_mode:
            return MODE_SE
        if self.preserve_order:
            return MODE_ORD_PE if self.pair_fastq else MODE_ORD_SE
        if self.pair_fastq:
            return MODE_MIN_PE if self.ignore_pair_order else MODE_PE
        return MODE_SE

    def resolve(self) -> None:
        """Derive chain flags (reference prepareChainData, pgrc-encoder.cpp:27-54:
        rev-compl pair file only in PE / ORD_PE modes) and apply level
        defaults to knobs not explicitly set (initCompressionParameters,
        pgrc-params.h:115-151 — like the reference, levels 1 and 3 currently
        share level 2's parameterization)."""
        if self.error_limit_promils is None:
            self.error_limit_promils = 120
        if self.gen_quality_coef is None:
            self.gen_quality_coef = 0.65
        if self.min_chars_per_mismatch is None:
            self.min_chars_per_mismatch = 3
        if self.match_cap is None:
            self.match_cap = 8
        if self.target_pg_match_length is None:
            self.target_pg_match_length = 45
        if not self.pair_fastq and not self.preserve_order:
            self.single_reads_mode = True
        self.revcomp_pair_file = (
            self.mode() in (MODE_PE, MODE_ORD_PE) and not self.disable_revcomp_pair
        )

    def max_mismatches(self) -> int:
        return self.read_len // self.min_chars_per_mismatch


def matching_chars_correction(pg_length: int) -> int:
    """Seed-length correction by pg size (ReadsMatchers.cpp:798-801)."""
    x = pg_length // 10_000_000
    return x.bit_length() if x else 0
