"""Per-bank reduction (PrIM §4.12 RED) — replaces the Pallas
``repro/kernels/reduce.py:_reduce_kernel``.

The TPU kernel walks its blocks in order and carries one VMEM accumulator.
Hopper runs blocks in no order, so ``csrc/reduce.cu`` sums in two passes:
one partial per ``block``-element tile, then one fixed-order sum of a
bank's partials.  Bound by bytes (the input, read once).  Floats
accumulate in float32, int32 in its own width with wrap-around; the result
has the input's dtype.  :func:`plain` is the same two-level arithmetic in
PyTorch: the CPU path and the yardstick the kernel is checked against.
"""
from __future__ import annotations

import torch

from . import cuda_lib

DTYPES = (torch.int32, torch.float32)


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype.is_floating_point else dtype


def plain(x: torch.Tensor, block: int) -> torch.Tensor:
    """(banks, n) -> (banks,); n % block == 0."""
    acc = _acc(x.dtype)
    banks, n = x.shape
    parts = x.reshape(banks, n // block, block).sum(-1, dtype=acc)
    return parts.sum(-1, dtype=acc).to(x.dtype)


def reduce_sum(x: torch.Tensor, *, block: int) -> torch.Tensor:
    """Sum of each bank row of ``x`` (banks, n), n % block == 0: the plain
    version for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return plain(x, block)
    cuda_lib.require_cuda("reduce_sum", x)
    if x.dtype not in DTYPES:
        raise TypeError(f"reduce_sum kernel takes {DTYPES}, got {x.dtype}")
    banks, n = x.shape
    partials = torch.empty((banks, n // block), dtype=x.dtype, device=x.device)
    out = torch.empty(banks, dtype=x.dtype, device=x.device)
    cuda_lib.launch("repro_reduce_sum", x.device, x.data_ptr(),
                    partials.data_ptr(), out.data_ptr(), banks, n, block,
                    cuda_lib.DTYPES[x.dtype])
    reduce_sum.launches += 1
    return out


reduce_sum.launches = 0
