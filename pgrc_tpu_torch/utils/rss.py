"""Host memory of this process: resident size now (`rss_now_mb`) and each
stage's own peak over an encode (`StagePeaks`, the encoder's
PGRC_TPU_RSS_TRACE).

Not `ru_maxrss`: a child's starts at its parent's peak (the kernel keeps
it across the exec), so it cannot give a stage's own peak. Where
/proc/self/status has VmHWM it is exact; where the kernel does not report
it, the resident size of /proc/self/statm is sampled by a daemon thread.
Imports neither numpy nor torch.
"""
from __future__ import annotations

import os
import threading


def _vm_hwm_mb():
    """This process's peak RSS in MB from /proc/self/status (VmHWM), None
    where the kernel does not report it."""
    with open("/proc/self/status") as f:
        for line in f:
            key, _, rest = line.partition(":")
            if key == "VmHWM":
                return round(int(rest.split()[0]) / 1024, 1)
    return None


def rss_now_mb() -> float:
    """Resident MB of this process, from /proc/self/statm."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**20


class _Sampler:
    """The largest resident size since `restart`, sampled from
    /proc/self/statm every `every` seconds by a daemon thread."""

    def __init__(self, every: float):
        self.every = every
        self._max = rss_now_mb()
        self._stop = threading.Event()
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while not self._stop.wait(self.every):
            now = rss_now_mb()
            if now > self._max:
                self._max = now

    def peak(self) -> float:
        return max(self._max, rss_now_mb())

    def restart(self) -> None:
        self._max = rss_now_mb()

    def stop(self) -> None:
        self._stop.set()


class StagePeaks:
    """Each stage's own peak RSS in MB: `take()` returns the peak since the
    last take (or since construction) and starts the next stage there.

    A statm sampler runs every `every` seconds. Where VmHWM exists and rose
    during the stage, the stage set the process's peak and VmHWM is that
    peak exactly; otherwise the stage's peak is the sampled one, which a
    spike shorter than `every` can pass by."""

    def __init__(self, every: float = 0.01):
        self._sampler = _Sampler(every)
        self._hwm = _vm_hwm_mb()

    def take(self) -> float:
        peak = self._sampler.peak()
        hwm = _vm_hwm_mb()
        if hwm is not None and self._hwm is not None and hwm > self._hwm:
            peak = max(peak, hwm)
        self._hwm = hwm
        self._sampler.restart()
        return round(peak, 1)

    def close(self) -> None:
        self._sampler.stop()
