"""ELL sparse matrix-vector product (PrIM §4.3 SpMV) — replaces the Pallas
``repro/kernels/spmv.py:_spmv_kernel``.

The TPU kernel takes (128, k) row blocks of vals and cols and gathers from
a VMEM-resident x.  On Hopper the product does 2 flops per stored entry,
so it is bound by the bytes of vals and cols: ``csrc/spmv.cu`` gives each
thread one row, reads its vals and cols with 16-byte loads when
``k % 4 == 0``, gathers x through the read-only path (a bank-sized x sits
in L1), accumulates in float32 and writes y in vals' dtype.  A bank axis
is folded into the rows, since x is shared by every bank.

Two edges follow the Pallas kernel exactly: a column at or past ``n``
reads ``x[n-1]`` (the gather clamps), and a padded slot (``cols < 0``) is
skipped after the product, so a NaN or inf stored there gives 0.
:func:`plain` is the same arithmetic in PyTorch: the CPU path and the
yardstick the kernel is checked against.
"""
from __future__ import annotations

import torch

from . import cuda_lib

DTYPES = (torch.float32, torch.bfloat16)


def plain(vals: torch.Tensor, cols: torch.Tensor,
          x: torch.Tensor) -> torch.Tensor:
    """(rows, k) ELL @ (n,) -> (rows,) in vals' dtype."""
    gathered = x[cols.clamp(0, x.shape[0] - 1)].to(torch.float32)
    contrib = vals.to(torch.float32) * gathered
    contrib = torch.where(cols >= 0, contrib, torch.zeros((), device=x.device))
    return contrib.sum(-1).to(vals.dtype)


def spmv_ell(vals: torch.Tensor, cols: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``vals`` (rows, k) float32 / bfloat16 and ``cols`` (rows, k) int32,
    ELL with ``cols == -1`` padding, times ``x`` (n,): the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    if vals.device.type == "cpu":
        return plain(vals, cols, x)
    xf = x.to(torch.float32).contiguous()
    cuda_lib.require_cuda("spmv_ell", vals, cols, xf)
    if vals.dtype not in DTYPES or cols.dtype != torch.int32:
        raise TypeError(f"spmv_ell kernel takes vals in {DTYPES} and int32 "
                        f"cols, got {vals.dtype} and {cols.dtype}")
    rows, k = vals.shape
    if cols.shape != (rows, k) or xf.dim() != 1 or xf.shape[0] < 1:
        raise ValueError(f"spmv_ell kernel needs vals and cols of one (rows, "
                         f"k) shape and a non-empty x (n,); got "
                         f"{tuple(vals.shape)}, {tuple(cols.shape)}, "
                         f"{tuple(x.shape)}")
    y = torch.empty(rows, dtype=vals.dtype, device=vals.device)
    cuda_lib.launch("repro_spmv_ell", vals.device, vals.data_ptr(),
                    cols.data_ptr(), xf.data_ptr(), y.data_ptr(), rows, k,
                    xf.shape[0], cuda_lib.DTYPES[vals.dtype])
    spmv_ell.launches += 1
    return y


spmv_ell.launches = 0
