"""Graft entry point of the torch port: the flagship probe on one device.

    python __graft_entry_torch__.py          # on the card
    entry(device="cpu")                      # the plain versions (the tests)

`entry()` returns `(fn, args)`: `fn(*args)` runs the port's probe
(`pgrc_tpu_torch.align.matcher.probe`: kernel C hashes the reads' anchors,
the join sorts them with the index keys and kernel E carries each anchor's
lowest position, kernel A verifies the first n_verify candidates) over a
host-built index, on the example data of `__graft_entry__.py`: 1024 reads
of 100 symbols from a 65,536-symbol pg with 1% substitutions, `bits=16`,
max_mis 33, n_verify 2. It returns (mis uint8 [1024], 255 = none; pos int32
[1024], -1 = none), the reference entry's outputs on the same data.

The twin of `dryrun_multichip` (the production encoder over a device mesh)
waits for the port's multi-GPU path; this file has none yet. It imports
nothing of JAX and nothing of `pgrc_tpu`.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

MAX_MIS, N_VERIFY = 33, 2


def _example_data(n_reads=1024, read_len=100, pg_len=65536, seed=0):
    """The reference entry's data (the same generator and seed): the pg,
    reads sampled from it with 1% substitutions, its host-built index and
    the probe offsets."""
    from pgrc_tpu_torch.align import matcher

    rng = np.random.default_rng(seed)
    pg = rng.integers(0, 4, size=pg_len, dtype=np.uint8)
    starts = rng.integers(0, pg_len - read_len, size=n_reads)
    reads = pg[starts[:, None] + np.arange(read_len)[None, :]].copy()
    err = rng.random(reads.shape) < 0.01
    reads[err] = (reads[err] + rng.integers(1, 4, size=int(err.sum()))) % 4
    index = matcher.build_index(pg, bits=16)
    offs = tuple(matcher.probe_offsets(read_len, index.k, matcher.DEFAULT_K2))
    return reads, pg, index, offs


def entry(device="cuda"):
    """(fn, args) of the port's probe on the example data, on `device`
    (no fallback: "cuda" without a card raises)."""
    import torch

    from pgrc_tpu_torch import state
    from pgrc_tpu_torch.align import matcher
    from pgrc_tpu_torch.core import packed
    from pgrc_tpu_torch.device import resolve

    dev = resolve(device)
    reads, pg, index, offs = _example_data()
    n, L = reads.shape
    (block,), pg_lanes, _ = matcher.device_index(index, pg, dev)
    lanes, _ = state.lanes_to_device(*packed.pack_lanes(reads), dev)
    keys = torch.empty((block.m + n * len(offs),), dtype=torch.int64, device=dev)

    def fn(lanes, keys, pg_lanes):
        ipos = matcher.write_head(block, keys, None, pg_lanes, index, False)
        return matcher.probe(lanes, offs, keys, ipos, pg_lanes, index.pg_len, L, index.k,
                             MAX_MIS, N_VERIFY)

    return fn, (lanes, keys, pg_lanes)


if __name__ == "__main__":
    fn, args = entry()
    mis, pos = fn(*args)
    print("entry OK:", [tuple(o.shape) for o in (mis, pos)],
          f"matched {float((mis != 255).float().mean()):.4f}")
