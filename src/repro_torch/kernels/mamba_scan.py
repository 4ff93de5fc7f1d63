"""SSD (Mamba-2) chunked selective scan — replaces the Pallas
``repro/kernels/mamba_scan.py:_ssd_kernel``.

  h_t = a_t h_{t-1} + b_t ⊗ x_t ;  y_t = c_t · h_t

Within a chunk of L steps the recurrence is three products against a
lower-triangular decay matrix, y = ((C Bᵀ) ∘ D) X + exp(cum) · (C h0) with
D[t, s] = exp(cum_t − cum_s) for t ≥ s, and the (N, P) float32 state is
carried from chunk to chunk.  The TPU kernel's grid is (B, H, chunks) with
the chunk axis sequential and the state in VMEM scratch; its wrapper pads
S to a whole chunk with a = 1.  On Hopper, ``csrc/ssd_scan.cu`` gives each
(b, h) one block that loops over the chunks itself with the state in shared
memory, and masks the ragged tail of S instead of padding it.

Three functions compute the scan here:

- :func:`ssd_scan` — the wrapper: a CUDA tensor goes to the kernel, a CPU
  tensor to :func:`chunked`;
- :func:`chunked` — the kernel's arithmetic (chunk by chunk, the same
  padding) in plain PyTorch, the counterpart of the reference running its
  Pallas kernel in interpret mode, so that ``use_kernel=True`` on the CPU
  is the reference's algorithm and not another one;
- :func:`plain` — the sequential oracle ``ref.ssd_scan``, which
  ``models/mamba.apply(use_kernel=False)`` runs, and the yardstick the
  kernel is held against on the card.  The chunked and sequential forms
  add in different orders: they agree to the reference's kernel-test
  tolerance, 5e-3.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib, ref

DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's cumsum gives each step of a chunk one of its 256 threads
MAX_CHUNK = 256
#: shared memory a block may use on Hopper (227 KB), less the kernel's
#: static scan scratch
_SMEM_LIMIT = 232448 - 512


def smem_bytes(L: int, P: int, N: int) -> int:
    """Shared memory one block needs: x (L, P), bᵀ and c (L, N) each, the
    masked (L, L + 1) matrix, the (N, P) state and three L-vectors, as
    float32 (``csrc/ssd_scan.cu:smem_floats``)."""
    return 4 * (L * P + 2 * L * N + L * (L + 1) + N * P + 3 * L)


def plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          c: torch.Tensor):
    """The sequential recurrence: y (B, S, H, P) in x's dtype, h (B, H, N,
    P) float32."""
    return ref.ssd_scan(x, a, b, c)


def chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, chunk: int):
    """The chunked form with chunks of ``chunk`` steps, S padded to a whole
    chunk with x = b = c = 0 and a = 1 (log a = 0), as the reference's
    wrapper pads it.  Returns y (B, S, H, P) in x's dtype and the final h
    (B, H, N, P) in float32."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    L = chunk
    pad = (-S) % L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    n = (S + pad) // L
    f32 = torch.float32
    xf = x.to(f32).reshape(B, n, L, H, P)
    bf = b.to(f32).reshape(B, n, L, N)
    cf = c.to(f32).reshape(B, n, L, N)
    cum = torch.log(a.to(f32)).reshape(B, n, L, H).cumsum(2)
    lower = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((B, H, N, P), dtype=f32, device=x.device)
    ys = []
    for i in range(n):
        cu = cum[:, i]                                     # (B, L, H)
        diff = cu[:, :, None, :] - cu[:, None, :, :]       # (B, t, s, H)
        decay = diff.masked_fill(~lower[None, :, :, None], float("-inf")).exp()
        g = torch.einsum("btn,bsn->bts", cf[:, i], bf[:, i])
        y_intra = torch.einsum("btsh,bshp->bthp", g[..., None] * decay,
                               xf[:, i])
        y_carry = cu.exp()[..., None] * torch.einsum("btn,bhnp->bthp",
                                                     cf[:, i], h)
        ys.append(y_intra + y_carry)
        w = (cu[:, -1:] - cu).exp()                        # (B, L, H)
        h = cu[:, -1].exp()[:, :, None, None] * h + torch.einsum(
            "bshn,bshp->bhnp", bf[:, i][:, :, None, :] * w[..., None],
            xf[:, i])
    y = (torch.stack(ys, 1).reshape(B, n * L, H, P)[:, :S] if ys
         else xf.new_zeros((B, 0, H, P)))
    return y.to(x.dtype), h


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int):
    """x (B, S, H, P), b and c (B, S, N) of one dtype, a (B, S, H) float32,
    ``chunk`` steps a chunk: :func:`chunked` for CPU tensors, the CUDA
    kernel for CUDA tensors.  Returns y and the final h."""
    if x.device.type == "cpu":
        return chunked(x, a, b, c, chunk)
    x, a, b, c = (t.contiguous() for t in (x, a, b, c))
    cuda_lib.require_cuda("ssd_scan", x, a, b, c)
    if x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype \
            or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan kernel takes x, b, c of one dtype in "
                        f"{DTYPES} and a float32 a; got {x.dtype}, {b.dtype},"
                        f" {c.dtype}, {a.dtype}")
    if x.dim() != 4 or a.shape != x.shape[:3] or b.dim() != 3 \
            or b.shape[:2] != x.shape[:2] or c.shape != b.shape:
        raise ValueError(f"ssd_scan kernel needs x (B, S, H, P), a (B, S, H)"
                         f" and b, c (B, S, N); got {tuple(x.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    if not 1 <= chunk <= MAX_CHUNK or smem_bytes(chunk, P, N) > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan kernel takes chunk <= {MAX_CHUNK} whose "
                         f"tiles fit in shared memory; got chunk {chunk}, "
                         f"P {P}, N {N} ({smem_bytes(chunk, P, N)} bytes)")
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    cuda_lib.launch("repro_ssd_scan", x.device, x.data_ptr(), a.data_ptr(),
                    b.data_ptr(), c.data_ptr(), y.data_ptr(), h.data_ptr(),
                    B, S, H, P, N, chunk, cuda_lib.DTYPES[x.dtype])
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
