"""ELL sparse matrix-vector product (PrIM §4.3 SpMV) — replaces the Pallas
``repro/kernels/spmv.py:_spmv_kernel``.

The TPU kernel takes (128, k) row blocks of vals and cols and gathers from
a VMEM-resident x.  On Hopper the product does 2 flops per stored entry,
so it is bound by the bytes of vals and cols.  ``csrc/spmv.cu`` stages x
in shared memory when it holds at most 8,192 values (the TPU kernel's
VMEM gather; a longer x is gathered through the read-only path), reads a
row with ``min(k / 4, 8)`` lanes of 16-byte loads when ``k % 4 == 0`` (one
thread a row otherwise), skips the vals of padded slots, combines the
lanes' float32 sums in a fixed order, and writes y in vals' dtype.  A
bank axis is folded into the rows, since x is shared by every bank.

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
    """``vals`` (..., k) float32 / bfloat16 and ``cols`` of the same shape,
    int32, ELL with ``cols == -1`` padding, times ``x`` (n,) -> (...) in
    vals' dtype: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors.  The kernel's path does only what the launch needs: x is
    converted only when it is not contiguous float32, and the shapes are
    checked once."""
    if vals.device.type == "cpu":
        k = vals.shape[-1]
        return plain(vals.reshape(-1, k), cols.reshape(-1, k),
                     x).reshape(vals.shape[:-1])
    if x.dtype != torch.float32 or not x.is_contiguous():
        x = x.to(torch.float32).contiguous()
    cuda_lib.require_cuda("spmv_ell", vals, cols, x)
    if vals.dtype not in DTYPES or cols.dtype != torch.int32:
        raise TypeError(f"spmv_ell kernel takes vals in {DTYPES} and int32 "
                        f"cols, got {vals.dtype} and {cols.dtype}")
    if cols.shape != vals.shape or vals.dim() < 1 or x.dim() != 1 \
            or x.shape[0] < 1:
        raise ValueError(f"spmv_ell kernel needs vals and cols of one (..., "
                         f"k) shape and a non-empty x (n,); got "
                         f"{tuple(vals.shape)}, {tuple(cols.shape)}, "
                         f"{tuple(x.shape)}")
    y = torch.empty(vals.shape[:-1], dtype=vals.dtype, device=vals.device)
    k = vals.shape[-1]
    cuda_lib.launch("repro_spmv_ell", vals.device, vals.data_ptr(),
                    cols.data_ptr(), x.data_ptr(), y.data_ptr(), y.numel(), k,
                    x.shape[0], cuda_lib.DTYPES[vals.dtype])
    spmv_ell.launches += 1
    return y


spmv_ell.launches = 0
