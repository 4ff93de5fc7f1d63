"""PrIM SCAN-SSA (Gómez-Luna et al., arXiv:2105.03814, §4.13): exclusive
prefix sum; element i is the sum of the elements before it."""
import numpy as np


def ref(x: np.ndarray) -> np.ndarray:
    out = np.zeros(len(x), dtype=np.int64)
    np.cumsum(x[:-1], dtype=np.int64, out=out[1:])
    return out


def control(x: np.ndarray) -> np.ndarray:
    """The running sums in 32-bit integers, the type below the
    configuration's int64, which wrap."""
    out = np.zeros(len(x), dtype=np.int32)
    np.cumsum(x[:-1].astype(np.int32), dtype=np.int32, out=out[1:])
    return out.astype(np.int64)
