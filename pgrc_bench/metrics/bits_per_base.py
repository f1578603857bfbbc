"""bits_per_base: the bytes of the archive files the window's encodes wrote,
times 8, over their input bases: what the user stores."""


def read(record):
    encodes = record["encodes"]
    if not encodes or any("archive_bytes" not in e for e in encodes):
        return None
    return sum(e["archive_bytes"] for e in encodes) * 8 / sum(e["bases"] for e in encodes)
