"""PrIM SEL (Gómez-Luna et al., arXiv:2105.03814, §4.4): database select.
The predicate drops the even elements and keeps the rest, in order."""
import numpy as np


def ref(x: np.ndarray) -> np.ndarray:
    return x[x % 2 != 0]


def control(x: np.ndarray) -> np.ndarray:
    """The same select over 32-bit integers, the type below the
    configuration's int64 (values past 2**31 wrap)."""
    y = x.astype(np.int32)
    return y[y % 2 != 0].astype(np.int64)
