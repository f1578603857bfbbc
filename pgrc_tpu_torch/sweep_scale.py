"""Scale run of the overlap sweep on one CUDA card, past the one-table cap.

    python -m pgrc_tpu_torch.sweep_scale [--reads 50000000] [--seed 17]

Samples `--reads` reads of 100 bp from a random genome at 40x with the
generator of exp_100m.py (half of them reverse complemented, 0.4%
substitutions) and runs the port's `find_overlaps` on the card. Past
`greedy_scs._SWEEP_MAX_ROWS` (48M) rows it sweeps in equal parts and then
repairs the free ends across them. Prints the wall time of each part and of
the cross-part repair, the peak device memory of each table, the device
bytes per sweep row, and how many rows the card's memory would hold in one
table; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .overlap import greedy_scs

L = 100


def sample_reads(n: int, seed: int) -> np.ndarray:
    """exp_100m.py's reads, without the FASTQ: codes [n, L] uint8."""
    from pgrc_tpu.utils import dna

    rng = np.random.default_rng(seed)
    glen = n * L // 40
    genome = rng.integers(0, 4, size=glen, dtype=np.uint8)
    codes = np.empty((n, L), dtype=np.uint8)
    for lo in range(0, n, 1 << 20):
        m = min(1 << 20, n - lo)
        c = genome[rng.integers(0, glen - L, size=m)[:, None] + np.arange(L)[None, :]]
        flip = rng.random(m) < 0.5
        c[flip] = dna.COMPL_VAL[c[flip][:, ::-1]]
        err = rng.random(c.shape) < 0.004
        c[err] = (c[err] + rng.integers(1, 4, size=int(err.sum()), dtype=np.uint8)) % 4
        codes[lo:lo + m] = c
    return codes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=50_000_000)
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_scale: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}", flush=True)
    t0 = time.time()
    codes = sample_reads(args.reads, args.seed)
    print(f"[input] {args.reads} reads of {L} bp in {time.time() - t0:.1f} s", flush=True)

    # each table's wall time and peak device memory: the partitioned sweep and
    # the repair reach find_overlaps through the module, so a wrapper sees them
    tables = []
    real = greedy_scs.find_overlaps

    def timed(sub_codes, coef=1.0, init_active=None, *, device):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        res = real(sub_codes, coef, init_active, device=device)
        torch.cuda.synchronize()
        tables.append({"kind": "repair" if init_active is not None else "part",
                       "rows": int(sub_codes.shape[0]), "s": time.time() - t,
                       "peak_bytes": int(torch.cuda.max_memory_allocated())})
        print(f"[table] {tables[-1]}", flush=True)
        return res

    greedy_scs.find_overlaps = timed
    try:
        t0 = time.time()
        # past the cap the parts and the repair are the tables; below it, one
        res = (real if args.reads > greedy_scs._SWEEP_MAX_ROWS else timed)(
            codes, 1.0, device=dev)
        wall = time.time() - t0
    finally:
        greedy_scs.find_overlaps = real
    parts = [t for t in tables if t["kind"] == "part"]
    per_row = max(t["peak_bytes"] / t["rows"] for t in parts)
    total = torch.cuda.get_device_properties(0).total_memory
    out = {"device": smi, "reads": args.reads, "cap": greedy_scs._SWEEP_MAX_ROWS,
           "wall_s": wall, "tables": tables, "device_bytes_per_row": per_row,
           "rows_in_device_memory": int(total / per_row), "device_memory": total,
           "linked": int((res.succ >= 0).sum())}
    print(f"[sweep] {args.reads} reads in {len(parts)} parts: {wall:.1f} s; "
          f"{per_row:.1f} device bytes per row at the peak of a part; "
          f"{total} bytes of device memory hold {out['rows_in_device_memory']} rows "
          f"in one table; {out['linked']} reads linked", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
