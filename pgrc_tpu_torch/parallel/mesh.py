"""A 1-D group of ranks over torch.distributed: the port's counterpart of
pgrc_tpu/parallel/mesh.py (a 1-D jax `Mesh` over axis "data", :17-25).

The reference's mesh is one program over many devices (shard_map). Here
every rank is a process with a device of its own, and the sharded stages
(`overlap.greedy_scs.find_overlaps(mesh=)`, `align.matcher.match_reads(mesh=)`,
`archive.encoder.encode(mesh=)`) call the few collectives of `Mesh` at the
same points on every rank. A mesh of one rank is no mesh (`active`), as in
the reference (greedy_scs.py:714-716).

Transport (`choose_backend`): NCCL when every rank has a card of its own,
that is when the ranks on one host are no more than its cards; gloo on the
CPU, and when ranks share a card, since NCCL refuses two ranks on one device. Every
collective takes its tensors on the rank's device: the gloo of torch 2.11
takes CUDA tensors in all_gather and all_reduce (chip_smoke's phase 9
checks it on the card), so nothing is staged through the host here; gloo
moves them through host memory itself. That is the collectives' transport,
not a fallback of the compute, which stays on the card. `make_mesh` prints
the choice once per rank.

    results = launch(fn, 4, *args)                 # fn(mesh, *args) on 4 ranks, on the card
    results = launch(fn, 4, *args, device="cpu")   # the same on gloo CPU ranks
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# seconds a rank waits in one collective before the backend gives up
COLLECTIVE_TIMEOUT_S = 600


class Mesh:
    """One rank's view of the group: its rank, the group's size, its device
    and the backend, with the collectives the sharded stages need. Every
    rank must call each collective, in the same order."""

    def __init__(self, rank: int, size: int, device: torch.device, backend: str):
        self.rank, self.size, self.device, self.backend = rank, size, device, backend

    def describe(self) -> str:
        return (f"rank {self.rank} of {self.size} on {self.device}: backend {self.backend}, "
                f"tensors passed on {self.device.type}, no staging")

    def splits(self, n: int) -> list[int]:
        """Rows of each rank when n rows are cut into contiguous blocks in
        rank order, sizes differing by at most one (a rank may get none)."""
        base, extra = divmod(n, self.size)
        return [base + (r < extra) for r in range(self.size)]

    def block(self, n: int) -> tuple[int, int]:
        """This rank's contiguous block [lo, hi) of n rows."""
        sizes = self.splits(n)
        lo = sum(sizes[:self.rank])
        return lo, lo + sizes[self.rank]

    def gather_counts(self, t: torch.Tensor) -> tuple[np.ndarray, torch.Tensor]:
        """Every rank's t (a small int64 vector on the rank's device, the
        same length on every rank), in rank order -> (host int64 [size,
        len(t)]: the one host read that sizes a variable-length gather; the
        same [size, len(t)] tensor on the device, for the kernels that read
        the gathered rows)."""
        out = torch.empty((self.size, *t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather(list(out.unbind(0)), t.contiguous())
        return out.cpu().numpy(), out

    def all_gather_rows(self, t: torch.Tensor, rows: int) -> torch.Tensor:
        """Every rank's first `rows` rows of t, in rank order: one gather ->
        [size, rows, *t.shape[1:]]. NCCL and gloo gather equal sizes. A
        rank whose t holds at least `rows` rows sends its head as it is
        (what lies past the rank's own count is dropped by every receiver);
        a shorter t is first copied into a buffer of `rows` rows."""
        send = t[:rows]
        if send.shape[0] < rows:
            send = torch.empty((rows, *t.shape[1:]), dtype=t.dtype, device=t.device)
            send[:t.shape[0]].copy_(t)
        bufs = torch.empty((self.size, *send.shape), dtype=t.dtype, device=t.device)
        if rows:
            dist.all_gather(list(bufs.unbind(0)), send)
        return bufs

    def all_gather_parts(self, t: torch.Tensor, counts) -> list[torch.Tensor]:
        """Every rank's t[:counts[r]], in rank order: one gather of the
        largest count of rows (`all_gather_rows`; t padded only where it is
        shorter). -> [size] views of the gathered buffer (rank r's part has
        counts[r] rows)."""
        counts = [int(c) for c in counts]
        bufs = self.all_gather_rows(t, max(counts))
        return [buf[:c] for buf, c in zip(bufs.unbind(0), counts)]

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """Sum or max (`op`) of t (contiguous, on the rank's device) over the
        ranks, in place; -> t."""
        dist.all_reduce(t, op=_OPS[op])
        return t

    def close(self) -> None:
        dist.destroy_process_group()


def active(mesh: Mesh | None) -> Mesh | None:
    """The mesh when it has more than one rank, else None (no mesh)."""
    return mesh if mesh is not None and mesh.size > 1 else None


def choose_backend(device_type: str, host_ranks: int, cards: int) -> str:
    """The group's backend: NCCL when the ranks are on cards and the
    `host_ranks` ranks on this host have a card each (NCCL refuses two
    ranks on one card), else gloo."""
    return "nccl" if device_type == "cuda" and host_ranks <= cards else "gloo"


def make_mesh(size: int, rank: int, init_method: str, *, device,
              host_ranks: int | None = None) -> Mesh:
    """Join the group of `size` ranks as `rank` (a `file://` or `tcp://`
    rendezvous) with `device` as this rank's device, over the backend that
    `choose_backend` picks for the `host_ranks` ranks (default `size`: one
    host) that share this host's cards."""
    device = torch.device(device)
    cards = 0
    if device.type == "cuda":
        torch.cuda.set_device(device)
        cards = torch.cuda.device_count()
    backend = choose_backend(device.type, host_ranks or size, cards)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    mesh = Mesh(rank, size, device, backend)
    print(f"[mesh] {mesh.describe()}", flush=True)
    return mesh


class RankError(RuntimeError):
    """A rank of `launch` failed: its traceback, or its exit code."""


def rank_device(device, host_index: int) -> torch.device:
    """The device of the rank that is `host_index`-th on its host: the CPU,
    or card host_index mod the cards there are (ranks beyond the count
    share cards)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", host_index % torch.cuda.device_count())


def _rank_main(rank, size, host_ranks, init_method, device, fn, args, results):
    torch.set_num_threads(1)
    mesh = None
    try:
        mesh = make_mesh(size, rank, init_method, host_ranks=host_ranks,
                         device=rank_device(device, rank % host_ranks))
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if mesh is not None:
            mesh.close()


def launch(fn, n_ranks: int, *args, device="cuda", init_method: str | None = None,
           world_size: int | None = None, first_rank: int = 0,
           host_ranks: int | None = None, timeout_s: float = 3600) -> list:
    """Run fn(mesh, *args) on `n_ranks` spawned processes, one rank each
    (ranks first_rank .. of a group of world_size, default n_ranks, joined
    at init_method, default a file rendezvous in a fresh temporary
    directory), each with torch on one thread, on `device` ("cuda": rank
    r on card r mod host_ranks mod the cards; "cpu": gloo). `host_ranks`
    is the number of the group's ranks on this host, over all its
    processes (default n_ranks); it picks the backend (`choose_backend`). -> [fn's return] in rank
    order. A rank that raises or dies fails the call with RankError, after
    every rank is stopped; so does a run past timeout_s. fn and its
    arguments and return are pickled: fn must be importable."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="pgrc_mesh_")
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
    size = world_size or n_ranks
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(first_rank + j, size, host_ranks or n_ranks, init_method,
                               device, fn, args, results))
             for j in range(n_ranks)]
    out, failure = {}, None
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < n_ranks and failure is None:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(first_rank + j, p.exitcode) for j, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and first_rank + j not in out]
                if dead:
                    failure = f"rank {dead[0][0]} exited {dead[0][1]} without a result"
                elif time.monotonic() > deadline:
                    failure = f"ranks still running after {timeout_s} s"
                continue
            if ok:
                out[rank] = val
            else:
                failure = f"rank {rank} failed:\n{val}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RankError(failure)
    return [out[first_rank + j] for j in range(n_ranks)]
