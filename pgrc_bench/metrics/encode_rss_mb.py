"""encode_rss_mb: the process's peak resident size from the base through the
end of the warm-up encode, minus the base, in MB: what one encode of the
cell's input adds, as a process that compresses one input has it. The base
is taken after the torch import, the CUDA context and the kernel library's
load, before any input-derived work. The window's encodes are left out:
the resident size creeps with each encode of one process, so a peak over
the window would grow with the number of encodes that fit it."""


def read(record):
    return record["rss_warmup_peak_mb"] - record["rss_base_mb"]
