"""Per-bank reduction (PrIM §4.12 RED) — replaces the Pallas
``repro/kernels/reduce.py:_reduce_kernel``.

The TPU kernel walks its blocks in order and carries one VMEM accumulator.
Bound by bytes (the input, read once).  Hopper runs blocks in no order, so
``csrc/reduce.cu`` is one launch: the resident blocks walk spans of at
least :data:`SPAN` values of a bank with 16-byte loads, four in flight a
thread, and the last block of a bank to arrive (an ``atomicAdd`` on the
bank's counter after a ``__threadfence``) sums the bank's partials in
index order.  No float atomics, so a float32 sum is the same on every
call.  The kernel takes any n and any 4-byte aligned base: a row's
unaligned head and its tail are added by scalar loads.  The wrapper clears
the counters with ``torch.zeros`` on the caller's stream.  Floats
accumulate in float32, int32 in its own width with wrap-around; the result
has the input's dtype.  :func:`plain` is the reference's two-level
arithmetic in PyTorch: the CPU path and the yardstick the kernel is
checked against.
"""
from __future__ import annotations

import torch

from . import cuda_lib

DTYPES = (torch.int32, torch.float32)
#: the fewest values one block of ``csrc/reduce.cu`` sums (kMinSpan)
SPAN = 8192


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype.is_floating_point else dtype


def plain(x: torch.Tensor, block: int) -> torch.Tensor:
    """(banks, n) -> (banks,); n % block == 0."""
    acc = _acc(x.dtype)
    banks, n = x.shape
    parts = x.reshape(banks, n // block, block).sum(-1, dtype=acc)
    return parts.sum(-1, dtype=acc).to(x.dtype)


def reduce_sum(x: torch.Tensor, *, block: int) -> torch.Tensor:
    """Sum of each bank row of ``x`` (banks, n): the plain version for a
    CPU tensor (n % block == 0), the CUDA kernel for a CUDA tensor (any
    n; ``block`` only sets the plain version's tiles)."""
    if x.device.type == "cpu":
        return plain(x, block)
    cuda_lib.require_cuda("reduce_sum", x)
    if x.dtype not in DTYPES:
        raise TypeError(f"reduce_sum kernel takes {DTYPES}, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"reduce_sum kernel takes (banks, n), got "
                         f"{tuple(x.shape)}")
    banks, n = x.shape
    cap = max(1, -(-n // SPAN))             # spans a bank may be cut into
    scratch = torch.zeros(banks * (1 + cap), dtype=torch.int32,
                          device=x.device)  # counters, then partials
    out = torch.empty(banks, dtype=x.dtype, device=x.device)
    cuda_lib.launch("repro_reduce_sum", x.device, x.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), banks, n, cap,
                    cuda_lib.DTYPES[x.dtype])
    reduce_sum.launches += 1
    return out


reduce_sum.launches = 0
