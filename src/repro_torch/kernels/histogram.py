"""Per-bank histogram (PrIM §4.11 HST-S) — replaces the Pallas
``repro/kernels/histogram.py:_hist_kernel``.

The TPU kernel counts each block with a one-hot matmul into one output
block that every grid step revisits.  ``csrc/histogram.cu`` is the paper's
HST-S on Hopper: each thread block counts its tile into a private
shared-memory histogram with shared atomics and merges it into its bank's
row with global integer atomics, exact in any order (global atomics
directly where nbins outgrows 48 KB of shared memory).  Bound by bytes
(the values, read once).  Values are clipped into ``[0, nbins)``.
:func:`plain` is a clip and a scatter-add in PyTorch: the CPU path and the
yardstick the kernel is checked against.
"""
from __future__ import annotations

import torch

from . import cuda_lib, ref


def plain(values: torch.Tensor, nbins: int, block: int) -> torch.Tensor:
    """(banks, n) int32 -> (banks, nbins) int32; n % block == 0."""
    return ref.histogram(values, nbins)


def histogram(values: torch.Tensor, nbins: int, *, block: int) -> torch.Tensor:
    """Bin counts of each bank row of ``values`` (banks, n) int32,
    n % block == 0: the plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor."""
    if values.device.type == "cpu":
        return plain(values, nbins, block)
    cuda_lib.require_cuda("histogram", values)
    if values.dtype != torch.int32:
        raise TypeError(f"histogram kernel takes int32, got {values.dtype}")
    banks, n = values.shape
    out = torch.zeros((banks, nbins), dtype=torch.int32, device=values.device)
    cuda_lib.launch("repro_histogram", values.device, values.data_ptr(),
                    out.data_ptr(), banks, n, block, nbins)
    histogram.launches += 1
    return out


histogram.launches = 0
