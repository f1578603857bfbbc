"""The control of the comparison that decides `correct`, at a cell's own size.

    python3 pgrc_bench/control.py --workload <cell> --seeds 1 2 3

runs one encode of the cell for each seed with the control planted in the
program (`faults.lossy`: the matched reads' mismatches dropped) and prints
one JSON line a seed with the numbers compared. Each must come out not
correct. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pgrc_bench import faults, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        with faults.lossy():
            r = run.run_cell(run.ROOT, args.workload, seed, 0, False)
        print(json.dumps({"control": "lossy", "workload": args.workload, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "failed": r["failed"], "checks": r["checks"],
                          "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
