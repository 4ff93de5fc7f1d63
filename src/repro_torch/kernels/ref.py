"""Plain PyTorch oracles for the ported kernels — the counterpart of
``repro/kernels/ref.py`` for gemv, reduce_sum, scan, histogram and
spmv_ell.

Each reduces over the last axis, so a leading bank axis is a batch.
``dtype=`` is passed explicitly wherever PyTorch would widen: ``torch.sum``
and ``torch.cumsum`` take int32 to int64, while the reference keeps int32
(and wraps).  ``torch.bincount`` / ``torch.histc`` drop out-of-range
values; the reference clips them into the edge bins, so the histogram is
a clip and a scatter-add.
"""
from __future__ import annotations

import torch


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype.is_floating_point else dtype


# -- GEMV (PrIM §4.2) ---------------------------------------------------------

def gemv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x ;  A:(..., m, n), x:(n,), float32 accumulation."""
    return (a.to(torch.float32) @ x.to(torch.float32)).to(a.dtype)


# -- reduction (PrIM §4.12) ----------------------------------------------------

def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Floats sum in float32 (and stay float32, as in the reference), ints
    in their own dtype."""
    return x.sum(-1, dtype=_acc(x.dtype))


# -- prefix sum (PrIM §4.13) ----------------------------------------------------

def scan_exclusive(x: torch.Tensor) -> torch.Tensor:
    c = x.cumsum(-1, dtype=x.dtype)
    return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)


def scan_inclusive(x: torch.Tensor) -> torch.Tensor:
    return x.cumsum(-1, dtype=x.dtype)


# -- histogram (PrIM §4.11) ------------------------------------------------------

def histogram(values: torch.Tensor, nbins: int) -> torch.Tensor:
    idx = values.clamp(0, nbins - 1).to(torch.int64)
    out = torch.zeros(values.shape[:-1] + (nbins,), dtype=torch.int32,
                      device=values.device)
    return out.scatter_add_(-1, idx, torch.ones_like(idx, dtype=torch.int32))


# -- SpMV, ELL format (PrIM §4.3) -------------------------------------------------

def spmv_ell(vals: torch.Tensor, cols: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """vals/cols: (..., rows, k) padded ELL (cols == -1 ⇒ padding); x: (n,).

    As the reference oracle: a column at or past ``n`` reads ``x[n-1]``
    (a JAX gather clamps), and a padded slot multiplies its value by a
    gathered 0, so a non-finite value there gives NaN.  The result has
    the promoted dtype of ``vals * x``."""
    gathered = torch.where(cols >= 0, x[cols.clamp(0, x.shape[0] - 1)],
                           torch.zeros((), dtype=x.dtype, device=x.device))
    return (vals * gathered).sum(-1)
