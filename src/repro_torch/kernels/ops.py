"""Public wrappers for the ported kernels — the counterpart of
``repro/kernels/ops.py`` for gemv, reduce_sum, scan, histogram and
spmv_ell.

They take the reference's arbitrary shapes (pad → kernel → slice) with the
same block clamp, ``min(block, max(128, next_pow2(n)))``, and the same
padding, so they give the reference's results for every length.  Each
takes an optional leading bank axis: a 1-D input (2-D for gemv's A and
spmv_ell's vals / cols) is one bank.  Where the data lies decides the path, and nothing else does: a CPU
tensor goes to the kernel's plain PyTorch version, a CUDA tensor to the
CUDA kernel, which raises when it cannot build or launch.  Each kernel
counts its launches on ``<kernel module>.<function>.launches``
(:func:`launch_counts`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import gemv as _gemv
from . import histogram as _hist
from . import reduce as _red
from . import scan as _scan
from . import spmv as _spmv

#: kernel name -> the function that counts its launches
KERNELS = {"reduce_sum": _red.reduce_sum, "scan_inclusive": _scan.scan_inclusive,
           "histogram": _hist.histogram, "gemv": _gemv.gemv,
           "spmv_ell": _spmv.spmv_ell}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _block(n: int, block: int) -> int:
    return min(block, max(128, 1 << (n - 1).bit_length()))


def _pad_last(x: torch.Tensor, mult: int, value=0) -> torch.Tensor:
    pad = (-x.shape[-1]) % mult
    return F.pad(x, (0, pad), value=value) if pad else x


def _banked(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """``x`` with a bank axis in front: an input of ``ndim`` dims is one
    bank, one of ``ndim + 1`` dims is already banked."""
    if x.dim() == ndim:
        return x[None]
    if x.dim() != ndim + 1:
        raise ValueError(f"expected {ndim} or {ndim + 1} dims, got "
                         f"{tuple(x.shape)}")
    return x


# -- gemv ---------------------------------------------------------------------

def gemv(a: torch.Tensor, x: torch.Tensor, *, block_n: int = 512):
    """y = A @ x for A (m, n) or bank-batched (banks, m, n), x (n,).

    The reference pads n to its clamped block (``ops.py:95``); that keeps
    n a multiple of 128 here too, which the kernel's 16-byte loads need.
    Rows need no padding: a warp owns a row."""
    ab = _banked(a, 2)
    banks, m, n = ab.shape
    bn = min(block_n, max(128, 1 << (n - 1).bit_length()))
    ap = _pad_last(ab, bn).contiguous()
    xp = _pad_last(x, bn)
    y = _gemv.gemv(ap.reshape(banks * m, ap.shape[-1]), xp).reshape(banks, m)
    return y if a.dim() == 3 else y[0]


# -- reduce / scan -------------------------------------------------------------

def reduce_sum(x: torch.Tensor, *, block: int = 4096):
    """Sum over the last axis, in x's dtype (int32 wraps)."""
    xb = _banked(x, 1)
    b = _block(xb.shape[-1], block)
    out = _red.reduce_sum(_pad_last(xb, b).contiguous(), block=b)
    return out if x.dim() == 2 else out[0]


def scan_inclusive(x: torch.Tensor, *, block: int = 4096):
    xb = _banked(x, 1)
    n = xb.shape[-1]
    b = _block(n, block)
    out = _scan.scan_inclusive(_pad_last(xb, b).contiguous(), block=b)[:, :n]
    return out if x.dim() == 2 else out[0]


def scan_exclusive(x: torch.Tensor, *, block: int = 4096):
    return scan_inclusive(x, block=block) - x


# -- histogram ------------------------------------------------------------------

def histogram(values: torch.Tensor, nbins: int, *, block: int = 4096):
    """int32 bin counts over the last axis, values clipped into
    [0, nbins).  The tail is padded with -1, which clips into bin 0, and
    bin 0 is corrected by the pad count (``ops.py:136-139``)."""
    vb = _banked(values, 1)
    n = vb.shape[-1]
    b = _block(n, block)
    pad = (-n) % b
    h = _hist.histogram(_pad_last(vb, b, value=-1).contiguous(), nbins, block=b)
    if pad:
        h[:, 0] -= pad
    return h if values.dim() == 2 else h[0]


# -- spmv ---------------------------------------------------------------------------

def spmv_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, *,
             block_rows: int = 128):
    """ELL SpMV for vals / cols (rows, k) or bank-batched (banks, rows, k),
    x (n,) shared by every bank.  Rows are padded as the reference pads
    them (``ops.py:151``): to ``min(block_rows, max(8, next_pow2(rows)))``
    with vals 0 and cols -1, then sliced back."""
    vb, cb = _banked(vals, 2), _banked(cols, 2)
    banks, rows, k = vb.shape
    br = min(block_rows, max(8, 1 << (rows - 1).bit_length()))
    pad = (-rows) % br
    if pad:
        vb = F.pad(vb, (0, 0, 0, pad))
        cb = F.pad(cb, (0, 0, 0, pad), value=-1)
    rp = rows + pad
    y = _spmv.spmv_ell(vb.reshape(banks * rp, k).contiguous(),
                       cb.reshape(banks * rp, k).contiguous(), x)
    y = y.reshape(banks, rp)[:, :rows]
    return y if vals.dim() == 3 else y[0]
