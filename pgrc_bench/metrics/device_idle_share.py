"""device_idle_share: 1 - (the union of the device's activity intervals, its
kernels, copies and sets, over the traced window's length). The traced
window is slower than an untraced one (the profiler's host overhead), so
this share reads higher than the device's idleness in an untraced run."""


def read(record):
    trace = record["trace"]
    if not trace or not trace["busy_s"] or not trace["window_s"]:
        return None
    return 1.0 - trace["busy_s"] / trace["window_s"]
