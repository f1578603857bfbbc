"""Stage 7: pseudogenome sequence compression (SimplePgMatcher slot).

v1 compresses the joined hq|lq|N pg with the VarLenDNA codebook coder +
LZMA (the reference's compound VARLEN_DNA -> LZMA job,
SimplePgMatcher.cpp:226-231). The pg-vs-pg long-match removal
(markAndRemoveExactMatches) plugs in here: when enabled it rewrites the
sequences with MATCH_MARK tokens + offset/length streams before the joined
compression. A `matched` flag byte in the section header keeps the format
forward-compatible.
"""
from __future__ import annotations

import numpy as np

from ..streams import props
from ..streams.container import StreamReader, write_streams
from ..utils.varint import write_varint, read_varint
from ..streams.varlen_dna import MARK


def write_pg_sequences(out, hq_pg, lq_pg, n_pg, target_match_len: int,
                       level: int, self_match_pre=None) -> None:
    from . import pg_match

    header = bytearray()
    matched = len(hq_pg) >= target_match_len
    header.append(1 if matched else 0)
    write_varint(header, target_match_len)
    if matched:
        hq_m, lq_m, n_m, streams = pg_match.match_pgs_in_pg(
            hq_pg, lq_pg, n_pg, target_match_len, pre=self_match_pre
        )
        hq_pg, lq_pg, n_pg = hq_m, lq_m, n_m
    write_varint(header, len(hq_pg))
    write_varint(header, len(lq_pg))
    write_varint(header, len(n_pg))
    out.write(bytes(header))
    joined = np.concatenate([hq_pg, lq_pg, n_pg]) if len(hq_pg) or len(lq_pg) or len(n_pg) \
        else np.zeros(0, dtype=np.uint8)
    # per-stream codebook selection over the three tuned VarLenDNA books
    # (the selector probes a prefix with each and keeps the smallest — the
    # reference hard-assigns one of its three books per call site,
    # VarLenDNACoder.cpp:200-254; probing is strictly better)
    jobs = [props.job("joined_pg", "joined pg", joined.tobytes())]
    if matched:
        jobs.extend(streams)
    write_streams(out, jobs)


def read_pg_sequences(reader: StreamReader, orig_hq_len: int):
    from . import pg_match

    buf = reader.buf
    matched = buf[reader.pos]
    reader.pos += 1
    target_len, reader.pos = read_varint(buf, reader.pos)
    hq_len, reader.pos = read_varint(buf, reader.pos)
    lq_len, reader.pos = read_varint(buf, reader.pos)
    n_len, reader.pos = read_varint(buf, reader.pos)
    joined = np.frombuffer(reader.read_one(), dtype=np.uint8)
    hq = joined[:hq_len]
    lq = joined[hq_len : hq_len + lq_len]
    npg = joined[hq_len + lq_len :]
    if matched:
        hq, lq, npg = pg_match.restore_matched_pgs(
            reader, hq, lq, npg, orig_hq_len, target_len
        )
    return np.ascontiguousarray(hq), np.ascontiguousarray(lq), np.ascontiguousarray(npg)
