"""stage_s.selfmatch_wait: the main thread's wait for the stage-7 self-match
of the HQ pseudogenome, seconds per encode (span `selfmatch.wait`, after
stage 5), the mean over the traced window's encodes, from the program's
recorder (`pgrc_bench/spans.py`). The part of `stage_s.chain` that is a wait."""
from pgrc_bench import spans


def read(record):
    return spans.mean(record, lambda e: spans.span_seconds(e, "selfmatch.wait"))
