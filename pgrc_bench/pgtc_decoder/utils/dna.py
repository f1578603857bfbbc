"""DNA value codes (numpy, host side): the reference's complement table
(utils/helper.cpp:388-397). Symbol order is "ACGTN" (values 0..4)."""
from __future__ import annotations

import numpy as np

A, C, G, T, N = range(5)

# value -> complement value (A<->T, C<->G, N->N)
COMPL_VAL = np.array([T, G, C, A, N], dtype=np.uint8)


def revcomp_rows(codes: np.ndarray) -> np.ndarray:
    """Reverse complement the rows of an ACGTN code matrix."""
    flipped = codes[:, ::-1]
    return np.where(flipped <= 3, 3 - flipped, flipped).astype(codes.dtype)
