"""stage_s.pgseq_write: the stage-7 writer thread's own seconds per encode
(span `pgseq.write`: the LQ and N pseudogenomes' matches and the joined
pseudogenome's coding; `stage_s.coding`'s `pgseq` is only the main thread's
wait for it), the mean over the traced window's encodes, from the program's
recorder (`pgrc_bench/spans.py`)."""
from pgrc_bench import spans


def read(record):
    return spans.mean(record, lambda e: spans.span_seconds(e, "pgseq.write"))
