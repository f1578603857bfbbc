"""Stage 7's pseudogenome sequences, decode side: a frozen copy of
`pgrc_tpu_torch/archive/pgseq.py`'s `read_pg_sequences`, unchanged.
"""
from __future__ import annotations

import numpy as np

from ..streams.container import StreamReader
from ..utils.varint import read_varint


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
