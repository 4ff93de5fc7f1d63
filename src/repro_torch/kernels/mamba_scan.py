"""SSD (Mamba-2) chunked selective scan — replaces the Pallas
``repro/kernels/mamba_scan.py:_ssd_kernel``.

  h_t = a_t h_{t-1} + b_t ⊗ x_t ;  y_t = c_t · h_t

Within a chunk of L steps the recurrence is three products against a
lower-triangular decay matrix, y = ((C Bᵀ) ∘ D) X + exp(cum) · (C h0) with
D[t, s] = exp(cum_t − cum_s) for t ≥ s, and the (N, P) float32 state is
carried from chunk to chunk.  The TPU kernel's grid is (B, H, chunks) with
the chunk axis sequential and the state in VMEM scratch; its wrapper pads
S to a whole chunk with a = 1.  On Hopper, ``csrc/ssd_scan.cu`` runs the
chunks in parallel, in three launches: every chunk's own state (B ∘ w)ᵀ X
into a float32 scratch (B, chunks, H, N, P) that this wrapper allocates;
the carry over the chunks, a thread per (b, h, n, p); and every output,
with C Bᵀ computed once per (b, chunk) block of four heads.  bfloat16
inputs run on the tensor cores (``mma.sync``, float32 operands as hi + lo
bf16 pairs), float32 inputs on the CUDA cores.  The kernel masks the
ragged tail of S instead of padding it.

Three functions compute the scan here:

- :func:`ssd_scan` — the wrapper: a CUDA tensor goes to the kernel, a CPU
  tensor to :func:`chunked`;
- :func:`chunked` — the kernel's three steps (every chunk's state in one
  batched product, the carry over chunks, every output in one batched
  product) in plain PyTorch, with the reference's padding: the
  counterpart of the reference running its Pallas kernel in interpret
  mode, so that ``use_kernel=True`` on the CPU is the reference's
  algorithm and not another one;
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
#: the kernel's cumsum takes two steps of a chunk on each of its 128 threads
MAX_CHUNK = 256
#: heads one block of the kernel holds (``csrc/ssd_scan.cu:kHeads``)
HEADS = 4
#: shared memory a block may use on Hopper (227 KB), less the kernel's
#: static scan scratch
_SMEM_LIMIT = 232448 - 512


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(L: int, P: int, N: int, dtype: torch.dtype) -> int:
    """Shared memory the larger of the kernel's two chunk kernels needs for
    a chunk of L steps (``csrc/ssd_scan.cu``: ``StatesBf16`` and ``OutBf16``
    for bfloat16, ``StatesF32`` and ``OutF32`` for float32)."""
    if dtype == torch.bfloat16:
        L16, P16, N16 = _up(L, 16), _up(P, 16), _up(N, 16)
        T16 = L16 // 16
        states = 4 * L16 * (HEADS + 2) + 2 * (L16 * (P16 + 8)
                                               + N16 * (L16 + 8))
        out = (4 * (256 * T16 * (T16 + 1) // 2 + L16 * (HEADS + 1))
               + 2 * (2 * L16 * (N16 + 8) + 2 * P16 * (N16 + 8)
                      + L16 * (P16 + 8)))
    else:
        L4, P4, N16 = _up(L, 4), _up(P, 4), _up(N, 16)
        rq = L4 // 4
        tri = 8 * rq * (rq + 1)
        states = 4 * (L4 * (HEADS + 2) + L4 * P4 + L4 * N16)
        out = 4 * (tri + max(tri, L4 * N) + L4 * P4 + N * L4
                   + L4 * (HEADS + 1))
    return max(states, out)


def plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          c: torch.Tensor):
    """The sequential recurrence: y (B, S, H, P) in x's dtype, h (B, H, N,
    P) float32."""
    return ref.ssd_scan(x, a, b, c)


def chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, chunk: int):
    """The chunked form with chunks of ``chunk`` steps, S padded to a whole
    chunk with x = b = c = 0 and a = 1 (log a = 0), as the reference's
    wrapper pads it, in the kernel's three steps.  Returns y (B, S, H, P)
    in x's dtype and the final h (B, H, N, P) in float32."""
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
    cum = torch.log(a.to(f32)).reshape(B, n, L, H).cumsum(2)   # (B, n, L, H)
    # 1. every chunk's own state (B o w)^T X and its decay exp(cum_L)
    w = (cum[:, :, -1:] - cum).exp()
    states = torch.einsum("bcshn,bcshp->bchnp",
                          bf[:, :, :, None, :] * w[..., None], xf)
    decay = cum[:, :, -1].exp()                                 # (B, n, H)
    # 2. the carry: h_in[c] = exp(cum_L[c-1]) h_in[c-1] + s[c-1]
    h = torch.zeros((B, H, N, P), dtype=f32, device=x.device)
    h_in = []
    for i in range(n):
        h_in.append(h)
        h = decay[:, i, :, None, None] * h + states[:, i]
    # 3. every output: ((C B^T) o D) X + exp(cum) (C h_in)
    if not n:
        return xf.new_zeros((B, 0, H, P)).to(x.dtype), h
    h_in = torch.stack(h_in, 1)                                 # (B, n, H, N, P)
    lower = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B, n, t, s, H)
    d = diff.masked_fill(~lower[:, :, None], float("-inf")).exp()
    g = torch.einsum("bctn,bcsn->bcts", cf, bf)
    y = (torch.einsum("bctsh,bcshp->bcthp", g[..., None] * d, xf)
         + cum.exp()[..., None] * torch.einsum("bctn,bchnp->bcthp", cf, h_in))
    return y.reshape(B, n * L, H, P)[:, :S].to(x.dtype), h


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
    if not 1 <= chunk <= MAX_CHUNK \
            or smem_bytes(chunk, P, N, x.dtype) > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan kernel takes chunk <= {MAX_CHUNK} whose "
                         f"tiles fit in shared memory; got chunk {chunk}, "
                         f"P {P}, N {N} "
                         f"({smem_bytes(chunk, P, N, x.dtype)} bytes)")
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    chunks = -(-S // chunk)
    # every chunk's state, then its h_in, and its decay exp(cum_L)
    scratch = torch.empty(B * chunks * H * (N * P + 1), dtype=torch.float32,
                          device=x.device)
    cuda_lib.launch("repro_ssd_scan", x.device, x.data_ptr(), a.data_ptr(),
                    b.data_ptr(), c.data_ptr(), y.data_ptr(), h.data_ptr(),
                    scratch.data_ptr(), B, S, H, P, N, chunk,
                    cuda_lib.DTYPES[x.dtype])
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
