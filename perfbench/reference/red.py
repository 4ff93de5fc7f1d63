"""PrIM RED (Gómez-Luna et al., arXiv:2105.03814, §4.12): the sum of all
elements, exact (a 64-bit integer)."""
import numpy as np


def ref(x: np.ndarray) -> np.int64:
    return np.sum(x, dtype=np.int64)


def control(x: np.ndarray) -> np.int64:
    """The sum in a 32-bit accumulator, the type below the configuration's
    int64, which wraps."""
    return np.int64(np.sum(x.astype(np.int32), dtype=np.int32))
