"""stage_s.selfmatch_select: the self-match's Python selection of its marks,
seconds per encode (span `selfmatch.select` in the worker thread; it holds
the GIL against the main thread's stages 4 and 5), the mean over the traced
window's encodes, from the program's recorder (`pgrc_bench/spans.py`)."""
from pgrc_bench import spans


def read(record):
    return spans.mean(record, lambda e: spans.span_seconds(e, "selfmatch.select"))
