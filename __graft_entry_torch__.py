"""Graft entry points of the torch port: the flagship probe on one device,
and the production encoder over a group of ranks.

    python __graft_entry_torch__.py            # entry() on the card
    python __graft_entry_torch__.py dryrun 4   # dryrun_multichip(4) on the card
    python __graft_entry_torch__.py dryrun_multihost       # 2 processes x 4 ranks, card
    python __graft_entry_torch__.py dryrun_multihost cpu   # the same on gloo CPU ranks
    entry(device="cpu")                        # the plain versions (the tests)
    dryrun_multichip(4, device="cpu")          # gloo ranks on the CPU

`entry()` returns `(fn, args)`: `fn(*args)` runs the port's probe
(`pgrc_tpu_torch.align.matcher.probe`: kernel C hashes the reads' anchors,
the join sorts them with the index keys and kernel E carries each anchor's
lowest position, kernel A verifies the first n_verify candidates) over a
host-built index, on the example data of `__graft_entry__.py`: 1024 reads
of 100 symbols from a 65,536-symbol pg with 1% substitutions, `bits=16`,
max_mis 33, n_verify 2. It returns (mis uint8 [1024], 255 = none; pos int32
[1024], -1 = none), the reference entry's outputs on the same data.

`dryrun_multichip(n)` is the twin of the reference's dry run
(`__graft_entry__.py:45-81`): the production encoder
(`archive.encoder.encode(mesh=)`) over n ranks (`parallel.mesh.launch`;
ranks that share a card talk over gloo) on the reference dry run's tiny
FASTQ (768 reads of 48 bases, seed 3). Every rank writes its own archive,
and each must equal the one-device archive, which must decode to the
input. `dryrun_multihost` (the twin of :84-170) starts several processes,
each launching its share of the ranks of one group joined over TCP on
localhost, and holds every rank's archive to the one-device archive the
same way. This file imports nothing of JAX and nothing of `pgrc_tpu`.
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
    index = matcher.build_index(pg)
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


def _write_tiny_fastq(path, n_reads, read_len, seed):
    """The reference dry run's input (`__graft_entry__._write_tiny_fastq`,
    the same generator and seed)."""
    from pgrc_tpu_torch.utils import dna

    rng = np.random.default_rng(seed)
    gl = max(n_reads * read_len // 30, 4 * read_len)
    genome = rng.integers(0, 4, size=gl, dtype=np.uint8)
    starts = rng.integers(0, gl - read_len, size=n_reads)
    codes = genome[starts[:, None] + np.arange(read_len)[None, :]].copy()
    err = rng.random(codes.shape) < 0.01
    codes[err] = (codes[err] + rng.integers(1, 4, size=int(err.sum()))) % 4
    with open(path, "wb") as f:
        for i in range(n_reads):
            f.write(b"@r%d\n%s\n+\nI%s\n" % (
                i, dna.VAL2SYM[codes[i]].tobytes(), b"I" * (read_len - 1)))


def _encode(src: str, out: str, device, mesh=None):
    from pgrc_tpu_torch.archive import encoder
    from pgrc_tpu_torch.config import PgRCParams

    return encoder.encode(PgRCParams(src_fastq=src, output=out), device=device, mesh=mesh)


def _encode_rank(mesh, src: str, out_dir: str) -> str:
    """One rank of a dry run: the production encoder over the mesh, into
    its own archive. -> the archive's path."""
    out = os.path.join(out_dir, f"rank{mesh.rank}.pgtc")
    _encode(src, out, mesh.device, mesh)
    return out


def _one_device_archive(d: str, device) -> tuple[str, bytes]:
    """The dry runs' input in `d` and its one-device archive's bytes, which
    must decode to the input."""
    from pgrc_tpu_torch.archive import decoder
    from pgrc_tpu_torch.device import resolve

    src = os.path.join(d, "in.fastq")
    _write_tiny_fastq(src, n_reads=768, read_len=48, seed=3)
    one = os.path.join(d, "one.pgtc")
    _encode(src, one, resolve(device))
    rep = decoder.validate(one, src)
    if rep["errors"]:
        raise RuntimeError(f"the one-device archive does not decode to its input: {rep}")
    with open(one, "rb") as f:
        return src, f.read()


def _require_same(paths, want: bytes) -> None:
    for path in paths:
        with open(path, "rb") as f:
            got = f.read()
        if got != want:
            raise RuntimeError(f"{os.path.basename(path)} differs from the one-device archive "
                               f"({len(got)} vs {len(want)} B)")


def dryrun_multichip(n_ranks: int = 8, device="cuda") -> None:
    """The production encoder over `n_ranks` ranks on `device` ("cuda":
    card rank mod the cards there are; "cpu": gloo ranks): every rank's
    archive byte-identical to the one-device archive, which round-trips."""
    import tempfile

    from pgrc_tpu_torch.parallel import mesh as pmesh

    with tempfile.TemporaryDirectory() as d:
        src, want = _one_device_archive(d, device)
        paths = pmesh.launch(_encode_rank, n_ranks, src, d, device=device)
        _require_same(paths, want)
    print(f"dryrun_multichip OK on {n_ranks} ranks ({device}): production encoder, every "
          f"rank's archive byte-identical to the one-device archive ({len(want)} B), "
          f"round-trip green")


def dryrun_multihost(n_processes: int = 2, ranks_per_process: int = 4, device="cuda") -> None:
    """`n_processes` processes, each launching `ranks_per_process` ranks on
    `device` of one group joined over TCP on localhost, run the production
    encoder: every rank's archive byte-identical to the one-device
    archive. The processes share this host's cards, so the group takes
    NCCL only when it has a card for every rank of all the processes."""
    import socket
    import subprocess
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        src, want = _one_device_archive(d, device)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "mh_worker",
                                   str(pid), str(n_processes), str(ranks_per_process),
                                   str(port), src, d, str(device)])
                 for pid in range(n_processes)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            raise RuntimeError(f"worker exit codes {rcs}")
        _require_same([os.path.join(d, f"rank{r}.pgtc")
                       for r in range(n_processes * ranks_per_process)], want)
    print(f"dryrun_multihost OK: {n_processes} processes x {ranks_per_process} ranks, "
          f"archives byte-identical to the one-device run ({len(want)} B)")


def _mh_worker(pid: int, n_processes: int, ranks_per_process: int, port: int, src: str,
               out_dir: str, device="cuda") -> None:
    """One process of the multi-host dry run: its ranks of the group, on
    `device`; every rank of the group is on this host."""
    from pgrc_tpu_torch.parallel import mesh as pmesh

    world = n_processes * ranks_per_process
    pmesh.launch(_encode_rank, ranks_per_process, src, out_dir, device=device,
                 init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                 first_rank=pid * ranks_per_process, host_ranks=world)


if __name__ == "__main__":
    cmd = sys.argv[1] if len(sys.argv) > 1 else "entry"
    if cmd == "dryrun":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 8,
                         sys.argv[3] if len(sys.argv) > 3 else "cuda")
    elif cmd == "dryrun_multihost":
        dryrun_multihost(device=sys.argv[2] if len(sys.argv) > 2 else "cuda")
    elif cmd == "mh_worker":
        _mh_worker(*(int(a) for a in sys.argv[2:6]), *sys.argv[6:9])
    else:
        fn, args = entry()
        mis, pos = fn(*args)
        print("entry OK:", [tuple(o.shape) for o in (mis, pos)],
              f"matched {float((mis != 255).float().mean()):.4f}")
