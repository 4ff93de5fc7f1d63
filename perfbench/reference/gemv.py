"""PrIM GEMV (Gómez-Luna et al., arXiv:2105.03814, §4.2): y = A x.

The reference product is float64, on the device in blocks of rows, beside
|A| |x|, the scale that an error of float32 rounding is measured against.
The control is the product at the precision below the configuration's
float32 with TF32 off: TF32, emulated by rounding A and x to TF32's 10
mantissa bits and multiplying in float32 with TF32 off, so that it reads
the same on any device."""
import numpy as np
import torch


def product(a: np.ndarray, xs: np.ndarray, device, rows=None,
            block: int = 16384) -> tuple[np.ndarray, np.ndarray]:
    """(A[rows] xs^T, |A[rows]| |xs|^T) in float64, shape (rows, len(xs));
    ``rows`` None means every row."""
    rows = np.arange(a.shape[0]) if rows is None else np.asarray(rows)
    x = torch.from_numpy(np.ascontiguousarray(xs.T)).to(device, torch.float64)
    ax = x.abs()
    y = np.empty((len(rows), xs.shape[0]))
    s = np.empty_like(y)
    for lo in range(0, len(rows), block):
        blk = torch.from_numpy(np.ascontiguousarray(
            a[rows[lo:lo + block]])).to(device, torch.float64)
        y[lo:lo + block] = (blk @ x).cpu().numpy()
        s[lo:lo + block] = (blk.abs() @ ax).cpu().numpy()
    return y, s


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest with 10 mantissa bits (TF32's inputs)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def control(a_tf32: torch.Tensor, x: np.ndarray) -> np.ndarray:
    """y at TF32 from an ``a_tf32`` already rounded on the device."""
    xt = tf32(torch.from_numpy(x).to(a_tf32.device))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return (a_tf32 @ xt).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
