"""stage_s.bad: stage 5's seconds per encode (span `bad`: the LQ and N
pseudogenomes' sweeps and assembly), the mean over the traced window's
encodes, from the program's recorder (`pgrc_bench/spans.py`)."""
from pgrc_bench import spans


def read(record):
    return spans.mean(record, lambda e: spans.span_seconds(e, "bad"))
