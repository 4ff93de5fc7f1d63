"""Matrix-vector product (PrIM §4.2 GEMV) — replaces the Pallas
``repro/kernels/gemv.py:_gemv_kernel``.

The TPU kernel tiles A into (128, 512) MXU blocks with an f32 VMEM
accumulator.  A GEMV does 2 flops per element of A, so on Hopper it is
bound by the bytes of A: ``csrc/gemv.cu`` streams A once, one warp per
row with 16-byte loads, x staged in shared memory, a warp-shuffle sum in
float32, and writes y in A's dtype (float32 or bfloat16).  :func:`plain` is
the same product in PyTorch: the CPU path and the yardstick the kernel is
checked against.
"""
from __future__ import annotations

import torch

from . import cuda_lib, ref

DTYPES = (torch.float32, torch.bfloat16)


def plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(rows, n) @ (n,) -> (rows,) in A's dtype."""
    return ref.gemv(a, x)


def gemv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a`` (rows, n) @ ``x`` (n,), n % 8 == 0: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if a.device.type == "cpu":
        return plain(a, x)
    xf = x.to(torch.float32).contiguous()
    cuda_lib.require_cuda("gemv", a, xf)
    rows, n = a.shape
    if a.dtype not in DTYPES:
        raise TypeError(f"gemv kernel takes {DTYPES}, got {a.dtype}")
    if n % 8 or a.data_ptr() % 16 or xf.shape != (n,):
        raise ValueError(f"gemv kernel needs n % 8 == 0, a 16-byte aligned "
                         f"A and x of shape ({n},); got A {tuple(a.shape)}, "
                         f"x {tuple(x.shape)}")
    y = torch.empty(rows, dtype=a.dtype, device=a.device)
    cuda_lib.launch("repro_gemv", a.device, a.data_ptr(), xf.data_ptr(),
                    y.data_ptr(), rows, n, cuda_lib.DTYPES[a.dtype])
    gemv.launches += 1
    return y


gemv.launches = 0
