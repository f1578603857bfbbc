"""Archive mode constants: the mode byte of the PGTC header."""
from __future__ import annotations

MODE_SE = 0
MODE_PE = 1
MODE_ORD_SE = 2
MODE_ORD_PE = 3
MODE_MIN_PE = 4
