"""PrIM UNI (Gómez-Luna et al., arXiv:2105.03814, §4.5): unique, the first
element of every run of equal consecutive elements, in order."""
import numpy as np


def ref(x: np.ndarray) -> np.ndarray:
    if len(x) == 0:
        return x
    keep = np.ones(len(x), dtype=bool)
    keep[1:] = x[1:] != x[:-1]
    return x[keep]


def control(x: np.ndarray) -> np.ndarray:
    """The same over 32-bit integers, the type below the configuration's
    int64."""
    return ref(x.astype(np.int32)).astype(np.int64)
