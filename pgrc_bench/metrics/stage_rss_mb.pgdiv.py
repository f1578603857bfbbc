"""stage_rss_mb.pgdiv: the sweep layer's (stages 2+3) own peak resident size
above the run's base, in MB, the mean over the traced window's encodes. The
encoder records each stage's own peak (`stage_rss_mb`) under
PGRC_TPU_RSS_TRACE=1, which the traced run sets; the base is taken once the
libraries, the CUDA context and the kernel library are loaded."""

STAGE = 'pgdiv'


def read(record):
    encodes = record["encodes"]
    if not encodes or any(not e["stage_rss_mb"] or STAGE not in e["stage_rss_mb"] for e in encodes):
        return None
    return sum(e["stage_rss_mb"][STAGE] for e in encodes) / len(encodes) - record["rss_base_mb"]
