"""kernel_ms: the device milliseconds of kernel launches (the port's own
kernels and the library kernels it launches; copies and sets left out) per
encode in the traced window, from torch.profiler's device trace."""


def read(record):
    trace = record["trace"]
    if not trace or not trace["kernel_s"] or not record["encodes"]:
        return None
    return trace["kernel_s"] * 1e3 / len(record["encodes"])
