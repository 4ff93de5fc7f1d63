"""Grouped (MoE expert) matmul — replaces the Pallas
``repro/kernels/moe_gmm.py:_gmm_kernel``.

Capacity-grouped tokens (E, C, d) meet per-expert weights (E, d, f); rows at
or past ``counts[e]`` come out zero.  The TPU kernel's grid is (E, C tiles,
f tiles, d tiles) with an f32 VMEM accumulator along the sequential d axis;
its wrapper pads C, d and f to its blocks and slices back.  On Hopper,
``csrc/moe_gmm.cu`` gives each block one (row tile, column tile, expert),
loops over d inside the block with the accumulator in registers (bfloat16
on the tensor cores with ``wgmma`` fed by a TMA ring, float32 on the CUDA
cores), reads ``counts`` on the device and skips the products of rows past
the expert's count.  The TMA takes rows of a multiple of 16 bytes from
16-byte aligned bases, so for bfloat16 this wrapper zero-pads d and f to
multiples of 8 (:func:`pad_gmm`; zero columns of x meet zero rows of w and
add nothing, zero columns of w give zero columns of y, sliced off) and
copies an unaligned view; C and E are never padded.  :func:`plain` is
``ref.moe_gmm``: the CPU path and the yardstick the kernel is checked
against on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib, ref

DTYPES = (torch.float32, torch.bfloat16)


def plain(xg: torch.Tensor, w: torch.Tensor,
          counts: torch.Tensor) -> torch.Tensor:
    """(E, C, d) @ (E, d, f) -> (E, C, f) in xg's dtype, dead rows 0."""
    return ref.moe_gmm(xg, w, counts)


def pad_gmm(xg: torch.Tensor,
            w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xg (E, C, d) and w (E, d, f) with d and f zero-padded to multiples of
    8 (rows of a multiple of 16 bytes in bfloat16, the TMA's term), d to at
    least 8 (a tensor map has no empty dimension)."""
    pd = max(8, xg.shape[2] + (-xg.shape[2]) % 8) - xg.shape[2]
    pf = (-w.shape[2]) % 8
    if pd:
        xg = F.pad(xg, (0, pd))
    if pd or pf:
        w = F.pad(w, (0, pf, 0, pd))
    return xg, w


def moe_gmm(xg: torch.Tensor, w: torch.Tensor,
            counts: torch.Tensor) -> torch.Tensor:
    """xg (E, C, d) and w (E, d, f) of one dtype, counts (E,) integers:
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if xg.device.type == "cpu":
        return plain(xg, w, counts)
    xg, w = xg.contiguous(), w.contiguous()
    cnt = counts.to(torch.int32).contiguous()
    cuda_lib.require_cuda("moe_gmm", xg, w, cnt)
    if xg.dtype not in DTYPES or w.dtype != xg.dtype:
        raise TypeError(f"moe_gmm kernel takes xg and w of one dtype in "
                        f"{DTYPES}, got {xg.dtype}, {w.dtype}")
    if (xg.dim() != 3 or w.dim() != 3 or w.shape[:2] != (xg.shape[0], xg.shape[2])
            or cnt.shape != (xg.shape[0],)):
        raise ValueError(f"moe_gmm kernel needs xg (E, C, d), w (E, d, f) and "
                         f"counts (E,); got {tuple(xg.shape)}, "
                         f"{tuple(w.shape)}, {tuple(counts.shape)}")
    E, C, _ = xg.shape
    f = w.shape[2]
    if xg.dtype == torch.bfloat16:  # the TMA's terms: d, f % 8 == 0, aligned bases
        xg, w = (cuda_lib.aligned16(t) for t in pad_gmm(xg, w))
    y = torch.empty((E, C, w.shape[2]), dtype=xg.dtype, device=xg.device)
    cuda_lib.launch("repro_moe_gmm", xg.device, xg.data_ptr(), w.data_ptr(),
                    cnt.data_ptr(), y.data_ptr(), E, C, xg.shape[2], y.shape[2],
                    cuda_lib.DTYPES[xg.dtype])
    y = y[..., :f].contiguous() if y.shape[2] != f else y
    moe_gmm.launches += 1
    return y


moe_gmm.launches = 0
