"""stage_s.chain: the encode chain's own seconds per encode, the encode's wall
less the sum of its stages' `stage_times`, the mean over the traced window's
encodes. Most of it is the main thread's wait, after stage 5 (`bad`), for
the stage-7 self-match of the HQ pseudogenome, which runs in a worker thread
from stage 4 on."""


def read(record):
    encodes = record["encodes"]
    if not encodes or any(not e["stage_times"] for e in encodes):
        return None
    return sum(e["end_s"] - e["start_s"] - sum(e["stage_times"].values())
               for e in encodes) / len(encodes)
