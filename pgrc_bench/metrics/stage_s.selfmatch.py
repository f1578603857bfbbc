"""stage_s.selfmatch: the stage-7 self-match's own seconds per encode, in
its worker thread from stage 4 on (span `selfmatch`: the native scan and
the Python selection), the mean over the traced window's encodes, from the
program's recorder (`pgrc_bench/spans.py`)."""
from pgrc_bench import spans


def read(record):
    return spans.mean(record, lambda e: spans.span_seconds(e, "selfmatch"))
