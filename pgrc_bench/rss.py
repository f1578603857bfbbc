"""The benchmark's host-memory sampler: a frozen copy of the statm sampler of
`pgrc_tpu_torch/utils/rss.py` (`_Sampler`, `rss_now_mb`).

The card's machine has no VmHWM, so the peak resident size is the largest
resident size of /proc/self/statm, read every 10 ms by a daemon thread; a
spike shorter than that can pass by. That machine counts the mapped torch and
CUDA libraries as resident (~4.75 GB before any work), so the benchmark reads
the peak above a base taken once the libraries, the CUDA context and the
kernel library are loaded.
"""
from __future__ import annotations

import os
import threading


def rss_now_mb() -> float:
    """Resident MB of this process, from /proc/self/statm."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**20


class PeakSampler:
    """The resident size when started (`base_mb`) and the largest one read
    since (`peak_mb`), sampled every `every` seconds until `stop`."""

    def __init__(self, every: float = 0.01):
        self.every = every
        self.base_mb = rss_now_mb()
        self._max = self.base_mb
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(self.every):
            now = rss_now_mb()
            if now > self._max:
                self._max = now

    def peak_mb(self) -> float:
        return max(self._max, rss_now_mb())

    def stop(self) -> float:
        """Stop sampling; returns the peak."""
        peak = self.peak_mb()
        self._stop.set()
        self._thread.join(timeout=1.0)
        return peak
