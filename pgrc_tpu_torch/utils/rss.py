"""Host memory of this process: resident size now, its peak over a run
(`PeakRss`) and over each stage of one (`StagePeaks`), and where the
resident bytes lie (`status_fields`, `mapped_libraries`).

Not `ru_maxrss`: a child's starts at its parent's peak (the kernel keeps
it across the exec), so it cannot give a child's or a stage's own peak.
Where /proc/self/status has VmHWM it is exact; where the kernel does not
report it, the resident size of /proc/self/statm is sampled by a daemon
thread. Imports neither numpy nor torch, so the decoder and the validator
may use it.
"""
from __future__ import annotations

import os
import threading

STATUS_FIELDS = ("VmHWM", "VmRSS", "RssAnon", "RssFile", "RssShmem")


def _page_mb() -> float:
    return os.sysconf("SC_PAGE_SIZE") / 2**20


def status_fields() -> dict:
    """The fields of STATUS_FIELDS that /proc/self/status has, in MB; a
    field the kernel does not report is absent."""
    got = {}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, rest = line.partition(":")
            if key in STATUS_FIELDS:
                got[key] = round(int(rest.split()[0]) / 1024, 1)
    return got


def vm_hwm_mb():
    """This process's peak RSS in MB from /proc/self/status (VmHWM), None
    where the kernel does not report it."""
    return status_fields().get("VmHWM")


def statm_mb() -> tuple[float, float]:
    """(resident, shared) MB from /proc/self/statm; shared counts the
    resident pages backed by a file or shared memory."""
    with open("/proc/self/statm") as f:
        fields = f.read().split()
    return int(fields[1]) * _page_mb(), int(fields[2]) * _page_mb()


def rss_now_mb() -> float:
    return statm_mb()[0]


def _lib_group(path: str) -> str:
    if "/nvidia/" in path:
        return "nvidia"
    if "/torch/" in path:
        return "torch"
    return "other"


def mapped_libraries() -> dict:
    """The shared libraries in /proc/self/maps by group (torch's own,
    `nvidia/*`, the rest): the summed file sizes of the distinct files, in
    MB, their count, and, where /proc/self/smaps reports it, the resident
    MB of their mappings."""
    files = {}
    with open("/proc/self/maps") as f:
        for line in f:
            parts = line.split(None, 5)
            if len(parts) == 6 and ".so" in os.path.basename(parts[5].strip()):
                path = parts[5].strip()
                files.setdefault(path, _lib_group(path))
    out = {g: {"files": 0, "file_mb": 0.0, "rss_mb": None}
           for g in ("torch", "nvidia", "other")}
    for path, group in files.items():
        try:
            size = os.path.getsize(path)
        except OSError:
            continue
        out[group]["files"] += 1
        out[group]["file_mb"] += size / 2**20
    try:
        rss = _smaps_rss_by_path()
    except OSError:
        rss = None
    for group in out.values():
        group["file_mb"] = round(group["file_mb"], 1)
    if rss:
        for g in out:
            out[g]["rss_mb"] = round(sum(v for p, v in rss.items()
                                         if files.get(p) == g), 1)
    return out


def _smaps_rss_by_path() -> dict:
    """Resident MB of each mapped file, from /proc/self/smaps ({} where it
    has no Rss lines)."""
    rss, path = {}, None
    with open("/proc/self/smaps") as f:
        for line in f:
            head = line.split(None, 1)[0]
            if "-" in head and not head.endswith(":"):
                parts = line.split(None, 5)
                path = parts[5].strip() if len(parts) == 6 else None
            elif head == "Rss:" and path:
                rss[path] = rss.get(path, 0.0) + int(line.split()[1]) / 1024
    return rss


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


class PeakRss:
    """This process's own peak RSS in MB since it started: VmHWM where
    /proc/self/status has it (Linux); where the kernel does not report it,
    the largest resident size of /proc/self/statm, sampled every 10 ms by
    a daemon thread from the start."""

    def __init__(self, every: float = 0.01):
        self.hwm = vm_hwm_mb() is not None
        self.source = "VmHWM" if self.hwm else f"statm every {every * 1e3:.0f} ms"
        self._sampler = None if self.hwm else _Sampler(every)

    def mb(self) -> float:
        if self.hwm:
            return vm_hwm_mb()
        return round(self._sampler.peak(), 1)


class StagePeaks:
    """Each stage's own peak RSS in MB: `take()` returns the peak since the
    last take (or since construction) and starts the next stage there.

    A statm sampler runs every `every` seconds. Where VmHWM exists and rose
    during the stage, the stage set the process's peak and VmHWM is that
    peak exactly; otherwise the stage's peak is the sampled one, which a
    spike shorter than `every` can pass by."""

    def __init__(self, every: float = 0.01):
        self._sampler = _Sampler(every)
        self._hwm = vm_hwm_mb()

    def take(self) -> float:
        peak = self._sampler.peak()
        hwm = vm_hwm_mb()
        if hwm is not None and self._hwm is not None and hwm > self._hwm:
            peak = max(peak, hwm)
        self._hwm = hwm
        self._sampler.restart()
        return round(peak, 1)

    def close(self) -> None:
        self._sampler.stop()
