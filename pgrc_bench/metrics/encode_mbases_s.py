"""encode_mbases_s: the input bases of all the window's encodes over the
seconds from the first encode's start to the last one's end, in millions a
second (host clock, the card synchronised before both reads)."""


def read(record):
    encodes = record["encodes"]
    if not encodes:
        return None
    wall = encodes[-1]["end_s"] - encodes[0]["start_s"]
    return sum(e["bases"] for e in encodes) / wall / 1e6
