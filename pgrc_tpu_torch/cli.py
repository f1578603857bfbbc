"""pgrc-compatible command line of the torch port.

The flags of `pgrc_tpu.cli` plus `--device` (default `cuda`):
  compress:   python -m pgrc_tpu_torch.cli [--device cuda|cpu] -i <src.fastq> [pair.fastq] <archive>
  decompress: python -m pgrc_tpu_torch.cli -d <archive> (writes <archive>_out[_1|_2])
  validate:   python -m pgrc_tpu_torch.cli -d -i <orig.fastq> [orig2.fastq] <archive>

Every mode (SE, PE, MIN_PE, SE_ORD, PE_ORD) and flag of the reference runs
on one device. Decompression and validation are host code and delegate to
`pgrc_tpu.archive.decoder`.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pgrc_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-i", nargs="+", metavar="FASTQ", help="input file(s): src [pair]")
    ap.add_argument("-d", action="store_true", help="decompress (or validate with -i)")
    ap.add_argument("-o", action="store_true", help="preserve original read order")
    ap.add_argument("-s", action="store_true", help="ignore pair order information (PE)")
    ap.add_argument("-t", type=int, default=0, help="threads (0=auto)")
    ap.add_argument("-q", type=int, default=None, help="quality division error limit [promils] (level default 120)")
    ap.add_argument("-Q", action="store_true", help="disable simplified suffix quality mode")
    ap.add_argument("-g", type=int, default=None, help="generator division threshold [%%] (level default 65)")
    ap.add_argument("-M", type=int, default=None, help="min chars per mismatch (level default 3)")
    ap.add_argument("-p", type=int, default=None, help="target pg-in-pg match length (level default 45)")
    ap.add_argument("-c", type=int, default=2, help="compression level 1..3")
    ap.add_argument("-V", action="store_true",
                    help="dump per-stage validation artifacts next to the archive")
    ap.add_argument("-T", action="store_true",
                    help="also dump every compressed stream's raw bytes")
    ap.add_argument("-a", "--analyze", action="store_true",
                    help="analyze the input reads set and exit (no compression)")
    ap.add_argument("-S", action="store_true",
                    help="treat paired input as single reads (no pair info)")
    ap.add_argument("-I", action="store_true",
                    help="ignore pair order information (alias of -s)")
    ap.add_argument("-A", action="store_true",
                    help="dev: store plain mismatch offsets (no rev-offset coding)")
    ap.add_argument("-l", type=int, default=None, metavar="MIS",
                    help="pass-1 accept threshold in mismatches (prematch level)")
    ap.add_argument("-n", action="store_true", help="put reads with N in LQ set")
    ap.add_argument("-r", action="store_true", help="disable rev-compl pair file mode")
    ap.add_argument("-v", action="count", default=0,
                    help="verbosity (-v dev stream logs, -vv trace)")
    ap.add_argument("-B", type=int, default=1, metavar="N",
                    help="begin chain at stage N (resume from checkpoint)")
    ap.add_argument("-E", type=int, default=7, metavar="N",
                    help="end chain after stage N (persist checkpoint)")
    ap.add_argument("-R", metavar="TSV", default="",
                    help="append a benchmark TSV row to this file (pgrc_res.txt role)")
    ap.add_argument("--device", default="cuda",
                    help="device of the sweep and matcher: cuda[:N] or cpu")
    ap.add_argument("archive", nargs="?", help="archive path")
    args = ap.parse_args(argv)
    # argparse's greedy `-i src [pair]` also consumes the trailing archive
    # positional; recover it (reference syntax: PgRC [opts] -i src [pair] archive)
    if args.archive is None:
        if not args.i or len(args.i) < 2:
            ap.error("the following arguments are required: archive")
        args.archive = args.i.pop()
    if args.i and len(args.i) > 2:
        ap.error("-i takes at most two files: src [pair]")

    from pgrc_tpu.streams import container
    from pgrc_tpu.utils import logchan

    logchan.set_verbosity(args.v)
    container.set_threads(args.t)

    t0 = time.time()
    if args.d:
        from pgrc_tpu.archive import decoder

        if args.i:
            rep = decoder.validate(args.archive, args.i[0],
                                   args.i[1] if len(args.i) > 1 else "")
            ok = rep["errors"] == 0
            verdict = "OK" if ok else f"{rep['errors']} ERRORS"
            print(f"Validated {rep['reads']} reads in {time.time()-t0:.2f} s: {verdict}")
            return 0 if ok else 1
        n = decoder.decode_to_files(args.archive, args.archive)
        print(f"Decompressed {n} reads in {time.time()-t0:.2f} s.")
        return 0

    if not args.i:
        ap.error("compression requires -i <src.fastq> [pair.fastq]")
    if args.analyze:
        from pgrc_tpu.core.analyzer import analyze_reads_set

        props = analyze_reads_set(args.i[0],
                                  args.i[1] if len(args.i) > 1 else None)
        print(props.summary())
        return 0
    from pgrc_tpu.config import PgRCParams

    from .archive import encoder
    from .device import resolve

    device = resolve(args.device)
    params = PgRCParams(
        src_fastq=args.i[0],
        pair_fastq=args.i[1] if len(args.i) > 1 else "",
        output=args.archive,
        preserve_order=args.o,
        single_reads_mode=args.S,
        ignore_pair_order=args.s or args.I,
        compression_level=args.c,
        error_limit_promils=args.q,
        simplified_suffix_mode=not args.Q,
        gen_quality_coef=args.g / 100.0 if args.g is not None else None,
        min_chars_per_mismatch=args.M,
        target_pg_match_length=args.p,
        separate_n_reads=not args.n,
        n_reads_lq=args.n,
        disable_revcomp_pair=args.r,
        verbosity=args.v,
        report_path=args.R,
        begin_stage=args.B,
        end_stage=args.E,
        dump_validation_files=args.V,
        dump_streams=args.T,
        rev_offset_mismatches=not args.A,
    )
    if args.l is not None:
        params.prematch_accept_mis = args.l
    stats = encoder.encode(params, device=device)
    total = time.time() - t0
    print(f"Created PGTC of size {stats.archive_bytes} bytes in {total:.2f} s "
          f"on {device}.")
    bases = stats.reads_total * stats.read_len
    if bases:
        print(f"  {stats.archive_bytes * 8 / bases:.4f} bits/base, "
              f"{bases / 1e6 / total:.1f} Mbases/s")
    print("  stage times:", {k: round(v, 2) for k, v in stats.stage_times.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
