"""GQA flash attention, causal and / or sliding-window — replaces the Pallas
``repro/kernels/flash_attention.py:_flash_kernel``.

The TPU kernel's grid is (B, H, q blocks, kv blocks) with the kv axis
sequential, carrying the online-softmax state in VMEM scratch; the wrapper
pads D to 128 and S, T to the block sizes.  On Hopper, blocks run in no
order, so ``csrc/flash_attention.cu`` gives each block one query tile of
one head and loops over the key tiles inside the block, with m, l and the
float32 accumulator in registers; tiles wholly outside the causal / window
band are skipped, as ``pl.when`` skips them there.  At the main path's
shapes the work (4·D flops per live (q, k) pair) is far past the ridge
point, so the bound is operations.  bfloat16 runs on the tensor cores
(``wgmma`` fed by a TMA ring; P rounded once to bfloat16 before the P·V
product), float32 on the CUDA cores in float32.  The TMA takes rows of a
multiple of 16 bytes from 16-byte aligned bases, so for bfloat16 this
wrapper zero-pads D to a multiple of 8 (:func:`pad_head_dim`; zero columns
add nothing to q·k and give zero output columns, sliced off) and copies an
unaligned view; the scale stays D**-0.5 of the unpadded D.  S and T are
never padded: the kernel masks their ragged tiles.

Semantics, as the Pallas kernel: query head h reads KV head
h // (H / KVH); scale = D**-0.5 unless given; query i sits at position
i + (T - S); a key is live when kpos < T, kpos <= qpos (causal) and
kpos > qpos - window (window); a row with no live key gives 0, not NaN.
:func:`plain` is ``ref.attention``: the CPU path and the yardstick the
kernel is checked against on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib, ref

DTYPES = (torch.float32, torch.bfloat16)
#: largest head dim the kernel takes (its shared-memory tiles)
MAX_HEAD_DIM = 256
#: a window at least this wide masks nothing the kernel can index
_WIDE = 1 << 30


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True, window: int | None = None,
          scale: float | None = None) -> torch.Tensor:
    """(B, H, S, D), (B, KVH, T, D) x 2 -> (B, H, S, D) in q's dtype."""
    return ref.attention(q, k, v, causal=causal, window=window, scale=scale)


def pad_head_dim(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """q, k, v with the head dim zero-padded to a multiple of 8 (rows of a
    multiple of 16 bytes in bfloat16, the TMA's term)."""
    pad = (-q.shape[-1]) % 8
    if not pad:
        return q, k, v
    return tuple(F.pad(t, (0, pad)) for t in (q, k, v))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, H, S, D), k and v (B, KVH, T, D) of one dtype: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, scale=scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cuda_lib.require_cuda("flash_attention", q, k, v)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes q, k, v of one dtype "
                        f"in {DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention kernel needs q (B, H, S, D) and k, "
                         f"v (B, KVH, T, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    _, KVH, T, _ = k.shape
    if (k.shape[0] != B or k.shape[3] != D or KVH < 1 or H % KVH
            or not 1 <= D <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention kernel needs one B and D, KVH "
                         f"dividing H and D <= {MAX_HEAD_DIM}; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    scale = float(D) ** -0.5 if scale is None else float(scale)
    if q.dtype == torch.bfloat16:   # the TMA's terms: D % 8 == 0, aligned bases
        q, k, v = (cuda_lib.aligned16(t) for t in pad_head_dim(q, k, v))
    o = torch.empty_like(q)
    cuda_lib.launch("repro_flash_attention", q.device, q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, KVH, S, T,
                    q.shape[-1], int(causal), int(window is not None),
                    0 if window is None else max(-_WIDE, min(int(window), _WIDE)), scale,
                    cuda_lib.DTYPES[q.dtype])
    o = o[..., :D].contiguous() if o.shape[-1] != D else o
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
