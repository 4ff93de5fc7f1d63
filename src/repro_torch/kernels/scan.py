"""Per-bank inclusive prefix sum (PrIM §4.13 SCAN) — replaces the Pallas
``repro/kernels/scan.py:_scan_kernel``.

The TPU kernel walks its blocks in order and carries the running total in
VMEM.  Hopper runs blocks in no order, so ``csrc/scan.cu`` is
reduce-then-scan in three launches: tile totals, a per-bank exclusive scan
of those totals, then a scan of each tile plus its offset.  Bound by bytes
(the input read twice, the output written once).  Floats accumulate in
float32, int32 in its own width with wrap-around.  :func:`plain` is the
reference's carried-offset arithmetic in PyTorch: the CPU path and the
yardstick the kernel is checked against.
"""
from __future__ import annotations

import torch

from . import cuda_lib

DTYPES = (torch.int32, torch.float32)


def plain(x: torch.Tensor, block: int) -> torch.Tensor:
    """(banks, n) -> (banks, n); n % block == 0."""
    acc = torch.float32 if x.dtype.is_floating_point else x.dtype
    banks, n = x.shape
    local = x.reshape(banks, n // block, block).cumsum(-1, dtype=acc)
    totals = local[..., -1]
    carry = torch.cat([torch.zeros_like(totals[:, :1]),
                       totals.cumsum(-1, dtype=acc)[:, :-1]], dim=1)
    return (carry[..., None] + local).reshape(banks, n).to(x.dtype)


def scan_inclusive(x: torch.Tensor, *, block: int) -> torch.Tensor:
    """Inclusive prefix sum of each bank row of ``x`` (banks, n),
    n % block == 0: the plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor."""
    if x.device.type == "cpu":
        return plain(x, block)
    cuda_lib.require_cuda("scan_inclusive", x)
    if x.dtype not in DTYPES:
        raise TypeError(f"scan_inclusive kernel takes {DTYPES}, got {x.dtype}")
    banks, n = x.shape
    totals = torch.empty((banks, n // block), dtype=x.dtype, device=x.device)
    offsets = torch.empty_like(totals)
    y = torch.empty_like(x)
    cuda_lib.launch("repro_scan_inclusive", x.device, x.data_ptr(),
                    totals.data_ptr(), offsets.data_ptr(), y.data_ptr(),
                    banks, n, block, cuda_lib.DTYPES[x.dtype])
    scan_inclusive.launches += 1
    return y


scan_inclusive.launches = 0
