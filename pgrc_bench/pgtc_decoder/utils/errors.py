"""Typed errors for archive parsing/validation.

The reference exits on malformed input at header parse
(PgRC's pgrc/pgrc-decoder.cpp:14-49); as a library we raise a
dedicated exception instead so corrupt or truncated archives fail loudly
and catchably — never with a bare AssertionError (stripped under -O) or an
incidental ValueError from a numpy frombuffer.
"""


class PgtcFormatError(Exception):
    """Raised when an archive is corrupt, truncated, or inconsistent."""
