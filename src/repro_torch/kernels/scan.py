"""Per-bank inclusive prefix sum (PrIM §4.13 SCAN) — replaces the Pallas
``repro/kernels/scan.py:_scan_kernel``.

The TPU kernel walks its blocks in order and carries the running total in
VMEM.  Bound by bytes: the least the card can move is the input read once
and the output written once (``2 · n · 4`` bytes a bank).  Hopper runs
blocks in no order, so ``csrc/scan.cu`` is one launch of a single-pass
scan with decoupled look-back (Merrill & Garland, NVIDIA 2016): a block
takes an 8,192-value tile from a counter in bank-major order, scans it from
one coalesced read, publishes its total, and walks back over the status
words of the tiles before it in its bank for its prefix.  ``exclusive``
writes ``inclusive - x`` from registers in the same pass, the operation
``ops.scan_exclusive`` applies on a CPU tensor.  int32 runs in uint32 and
wraps, exact on every run; float32 accumulates in float32 in an order that
depends on which tiles had published a prefix, so its last bits may differ
from run to run (within ``1e-6 · Σ|x|`` over the prefix).  The wrapper
clears the status words and the tile counter on the stream (``torch.zeros``)
before each launch.  :func:`plain` is the reference's carried-offset
arithmetic in PyTorch: the CPU path and the yardstick the kernel is checked
against.
"""
from __future__ import annotations

import torch

from . import cuda_lib

DTYPES = (torch.int32, torch.float32)
#: values a tile of ``csrc/scan.cu`` (kTile) scans
TILE = 8192


def plain(x: torch.Tensor, block: int) -> torch.Tensor:
    """(banks, n) -> (banks, n); n % block == 0."""
    acc = torch.float32 if x.dtype.is_floating_point else x.dtype
    banks, n = x.shape
    local = x.reshape(banks, n // block, block).cumsum(-1, dtype=acc)
    totals = local[..., -1]
    carry = torch.cat([torch.zeros_like(totals[:, :1]),
                       totals.cumsum(-1, dtype=acc)[:, :-1]], dim=1)
    return (carry[..., None] + local).reshape(banks, n).to(x.dtype)


def scan_inclusive(x: torch.Tensor, *, block: int,
                   exclusive: bool = False) -> torch.Tensor:
    """Inclusive prefix sum of each bank row of ``x`` (banks, n),
    n % block == 0, or with ``exclusive`` that sum minus ``x``: the plain
    version for a CPU tensor, the CUDA kernel for a CUDA tensor.  The
    kernel's tile is its own; ``block`` only sets the plain version's."""
    if x.device.type == "cpu":
        y = plain(x, block)
        return y - x if exclusive else y
    cuda_lib.require_cuda("scan_inclusive", x)
    if x.dtype not in DTYPES:
        raise TypeError(f"scan_inclusive kernel takes {DTYPES}, got {x.dtype}")
    banks, n = x.shape
    if n % 4:
        raise ValueError(f"scan_inclusive kernel needs n % 4 == 0, got {n}")
    x = cuda_lib.aligned16(x)
    y = torch.empty_like(x)
    words = banks * -(-n // TILE) + 1        # status words, then the counter
    scratch = torch.zeros(words, dtype=torch.int64, device=x.device)
    cuda_lib.launch("repro_scan_inclusive", x.device, x.data_ptr(),
                    y.data_ptr(), scratch.data_ptr(), words, banks, n,
                    int(exclusive), cuda_lib.DTYPES[x.dtype])
    scan_inclusive.launches += 1
    return y


scan_inclusive.launches = 0
