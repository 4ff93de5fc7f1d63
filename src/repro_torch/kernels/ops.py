"""Public wrappers for the ported kernels — the counterpart of
``repro/kernels/ops.py`` for attention (and decode attention), gemv,
reduce_sum, scan, histogram, spmv_ell, moe_gmm and ssd_scan.

They take the reference's arbitrary shapes (pad → kernel → slice) with the
same block clamp, ``min(block, max(128, next_pow2(n)))``, and the same
padding, so they give the reference's results for every length.  Each
takes an optional leading bank axis: a 1-D input (2-D for gemv's A and
spmv_ell's vals / cols) is one bank.  Where the data lies decides the path, and nothing else does: a CPU
tensor goes to the kernel's plain PyTorch version, a CUDA tensor to the
CUDA kernel, which raises when it cannot build or launch.  Each kernel
counts its launches on ``<kernel module>.<function>.launches``
(:func:`launch_counts`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import flash_attention as _fa
from . import gemv as _gemv
from . import histogram as _hist
from . import mamba_scan as _mamba
from . import moe_gmm as _gmm
from . import reduce as _red
from . import scan as _scan
from . import ref
from . import spmv as _spmv

#: kernel name -> the function that counts its launches
KERNELS = {"reduce_sum": _red.reduce_sum, "scan_inclusive": _scan.scan_inclusive,
           "histogram": _hist.histogram, "gemv": _gemv.gemv,
           "spmv_ell": _spmv.spmv_ell, "flash_attention": _fa.flash_attention,
           "moe_gmm": _gmm.moe_gmm, "ssd_scan": _mamba.ssd_scan}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _block(n: int, block: int) -> int:
    return min(block, max(128, 1 << (n - 1).bit_length()))


def _pad_last(x: torch.Tensor, mult: int, value=0) -> torch.Tensor:
    pad = (-x.shape[-1]) % mult
    return F.pad(x, (0, pad), value=value) if pad else x


def _banked(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """``x`` with a bank axis in front: an input of ``ndim`` dims is one
    bank, one of ``ndim + 1`` dims is already banked."""
    if x.dim() == ndim:
        return x[None]
    if x.dim() != ndim + 1:
        raise ValueError(f"expected {ndim} or {ndim + 1} dims, got "
                         f"{tuple(x.shape)}")
    return x


# -- attention ----------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None) -> torch.Tensor:
    """GQA flash attention; q (B, H, S, D), k / v (B, KVH, T, D), any S, T
    and D <= 256.  The reference pads D to 128 and S, T to its blocks and
    slices back (``ops.py:64-73``); zero padding does not change the
    result.  The kernel masks ragged S and T itself; its bfloat16 path pads
    D to a multiple of 8 (``flash_attention.pad_head_dim``) for the TMA.
    scale = D**-0.5 of the unpadded D, as there."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               scale=float(q.shape[-1]) ** -0.5)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int | None = None,
                     impl: str = "ref") -> torch.Tensor:
    """Decode path: a memory-bound KV gather for one query token, plain
    torch ops by design, as in the reference (``ops.py:76-84``).
    ``impl="grouped"`` is the reference's ``fast_decode`` form (no KV
    repeat)."""
    f = ref.decode_attention_grouped if impl == "grouped" \
        else ref.decode_attention
    return f(q, k_cache, v_cache, lengths, window=window)


# -- gemv ---------------------------------------------------------------------

def gemv(a: torch.Tensor, x: torch.Tensor, *, block_n: int = 512):
    """y = A @ x for A (m, n) or bank-batched (banks, m, n), x (n,).

    The reference pads n to its clamped block (``ops.py:95``); that keeps
    n a multiple of 128 here too, which the kernel's 16-byte loads need.
    Rows need no padding: the kernel masks a warp's last, ragged group."""
    ab = _banked(a, 2)
    banks, m, n = ab.shape
    bn = min(block_n, max(128, 1 << (n - 1).bit_length()))
    ap = _pad_last(ab, bn).contiguous()
    xp = _pad_last(x, bn)
    y = _gemv.gemv(ap.reshape(banks * m, ap.shape[-1]), xp).reshape(banks, m)
    return y if a.dim() == 3 else y[0]


# -- reduce / scan -------------------------------------------------------------

def reduce_sum(x: torch.Tensor, *, block: int = 4096):
    """Sum over the last axis, in x's dtype (int32 wraps).  A CPU tensor is
    padded to the reference's clamped block (``ops.py:105-110``); the
    CUDA kernel takes any n, so a CUDA tensor goes in as it is."""
    xb = _banked(x, 1)
    b = _block(xb.shape[-1], block)
    if xb.device.type == "cpu":
        xb = _pad_last(xb, b)
    out = _red.reduce_sum(xb.contiguous(), block=b)
    return out if x.dim() == 2 else out[0]


def _scan_rows(x: torch.Tensor, block: int, exclusive: bool):
    xb = _banked(x, 1)
    n = xb.shape[-1]
    b = _block(n, block)
    out = _scan.scan_inclusive(_pad_last(xb, b).contiguous(), block=b,
                               exclusive=exclusive)[:, :n]
    return out if x.dim() == 2 else out[0]


def scan_inclusive(x: torch.Tensor, *, block: int = 4096):
    return _scan_rows(x, block, exclusive=False)


def scan_exclusive(x: torch.Tensor, *, block: int = 4096):
    """``scan_inclusive(x) - x``, as the reference computes it
    (``ops.py:124-125``).  On a CUDA tensor the kernel writes it in the same
    pass, with the same subtraction from its inclusive result."""
    if x.device.type == "cpu":
        return scan_inclusive(x, block=block) - x
    return _scan_rows(x, block, exclusive=True)


# -- histogram ------------------------------------------------------------------

def histogram(values: torch.Tensor, nbins: int, *, block: int = 4096):
    """int32 bin counts over the last axis, values clipped into
    [0, nbins).  The tail is padded with -1, which clips into bin 0, and
    bin 0 is corrected by the pad count (``ops.py:136-139``)."""
    vb = _banked(values, 1)
    n = vb.shape[-1]
    b = _block(n, block)
    pad = (-n) % b
    h = _hist.histogram(_pad_last(vb, b, value=-1).contiguous(), nbins, block=b)
    if pad:
        h[:, 0] -= pad
    return h if values.dim() == 2 else h[0]


# -- spmv ---------------------------------------------------------------------------

def spmv_ell(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor):
    """ELL SpMV for vals / cols (rows, k) or bank-batched (banks, rows, k),
    x (n,) shared by every bank.  The reference pads the rows to its row
    block with vals 0 and cols -1 and slices back (``ops.py:151``); a
    padded row gives 0 and is cut away, and neither the kernel nor its
    plain version needs whole blocks, so the rows go in as they are."""
    if vals.dim() not in (2, 3):
        raise ValueError(f"expected 2 or 3 dims, got {tuple(vals.shape)}")
    return _spmv.spmv_ell(vals.contiguous(), cols.contiguous(), x)


# -- moe grouped matmul ------------------------------------------------------------

def moe_gmm(xg: torch.Tensor, w: torch.Tensor, counts: torch.Tensor):
    """Grouped per-expert matmul: xg (E, C, d) @ w (E, d, f) with float32
    accumulation, rows at or past ``counts[e]`` zeroed, in xg's dtype.
    The reference pads C, d and f to its blocks and slices back
    (``ops.py:159-173``); zero padding changes nothing.  The kernel masks
    ragged C itself; its bfloat16 path pads d and f to multiples of 8
    (``moe_gmm.pad_gmm``) for the TMA."""
    return _gmm.moe_gmm(xg, w, counts)


# -- mamba / ssd scan ---------------------------------------------------------------

def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int = 128):
    """The chunked SSD scan: x (B, S, H, P), a (B, S, H), b / c (B, S, N)
    -> y (B, S, H, P), final h (B, H, N, P) float32.  The chunk is clamped
    as the reference clamps it, ``min(chunk, max(8, next_pow2(S)))``
    (``ops.py:178-191``); the reference pads S to a whole chunk with
    a = 1, the kernel masks the tail to the same result."""
    S = x.shape[1]
    ch = min(chunk, max(8, 1 << (S - 1).bit_length()))
    return _mamba.ssd_scan(x, a, b, c, chunk=ch)
