"""Plain PyTorch oracles for the ported kernels — the counterpart of
``repro/kernels/ref.py`` for attention (and the two decode attentions),
gemv, reduce_sum, scan, histogram, spmv_ell, the grouped MoE matmul and
the selective-SSM scan.

Each reduces over the last axis, so a leading bank axis is a batch.
``dtype=`` is passed explicitly wherever PyTorch would widen: ``torch.sum``
and ``torch.cumsum`` take int32 to int64, while the reference keeps int32
(and wraps).  ``torch.bincount`` / ``torch.histc`` drop out-of-range
values; the reference clips them into the edge bins, so the histogram is
a clip and a scatter-add.
"""
from __future__ import annotations

import math

import torch


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype.is_floating_point else dtype


# -- attention ------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None) -> torch.Tensor:
    """Multi-head attention oracle with GQA + causal + sliding-window.

    q: (B, H, S, D); k, v: (B, KVH, T, D); KVH divides H, and query head
    h reads KV head h // (H / KVH).  Query i sits at position
    i + (T - S), so the last query lines up with the last key.  window:
    attend to keys in (qpos - window, qpos].  Scores and softmax in
    float32; a fully masked row gives 0, not NaN.  The result has q's
    dtype."""
    B, H, S, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    group = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32),
                          kr.to(torch.float32)) * scale
    qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits.masked_fill_(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    del logits
    # fully masked rows; out of place: softmax's backward reads its output
    p = torch.nan_to_num(p, nan=0.0)
    return torch.einsum("bhst,bhtd->bhsd", p,
                        vr.to(torch.float32)).to(q.dtype)


def _decode_valid(lengths: torch.Tensor, T: int, window: int | None,
                  start: int = 0):
    """(B, 1, 1, T): which of T cache slots holding positions ``start`` …
    ``start + T - 1`` a query at position ``lengths - 1`` attends to."""
    pos = torch.arange(start, start + T,
                       device=lengths.device)[None, None, None, :]
    lens = lengths[:, None, None, None]
    valid = pos < lens
    if window is not None:
        valid &= pos >= lens - window
    return valid


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """Single-token decode oracle. q: (B, H, 1, D); caches: (B, KVH, T, D);
    lengths: (B,) valid cache lengths."""
    B, H, _, D = q.shape
    KVH, T = k_cache.shape[1], k_cache.shape[2]
    group = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kr = k_cache.repeat_interleave(group, dim=1)
    vr = v_cache.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhtd->bhqt", q.to(torch.float32),
                          kr.to(torch.float32)) * scale
    logits = logits.masked_fill(~_decode_valid(lengths, T, window),
                                float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqt,bhtd->bhqd", p,
                        vr.to(torch.float32)).to(q.dtype)


def decode_attention_grouped(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, lengths: torch.Tensor,
                             *, window: int | None = None,
                             scale: float | None = None) -> torch.Tensor:
    """The reference's ``fast_decode`` form: the query heads of one KV
    group attend together, so the cache is never repeated across the
    group.  The reference's float32 accumulation of cache-dtype operands
    (``preferred_element_type``) is a float32 product of the upcast
    operands here; the probabilities round to q's dtype before the value
    product, as there."""
    B, H, _, D = q.shape
    KVH, T = k_cache.shape[1], k_cache.shape[2]
    group = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, KVH, group, D)
    logits = torch.einsum("bkgd,bktd->bkgt", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    logits = logits.masked_fill(~_decode_valid(lengths, T, window),
                                float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", p.to(q.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(B, H, 1, D).to(q.dtype)


# -- GEMV (PrIM §4.2) ---------------------------------------------------------

def gemv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x ;  A:(..., m, n), x:(n,), float32 accumulation."""
    return (a.to(torch.float32) @ x.to(torch.float32)).to(a.dtype)


# -- reduction (PrIM §4.12) ----------------------------------------------------

def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Floats sum in float32 (and stay float32, as in the reference), ints
    in their own dtype."""
    return x.sum(-1, dtype=_acc(x.dtype))


# -- prefix sum (PrIM §4.13) ----------------------------------------------------

def scan_exclusive(x: torch.Tensor) -> torch.Tensor:
    c = x.cumsum(-1, dtype=x.dtype)
    return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)


def scan_inclusive(x: torch.Tensor) -> torch.Tensor:
    return x.cumsum(-1, dtype=x.dtype)


# -- histogram (PrIM §4.11) ------------------------------------------------------

def histogram(values: torch.Tensor, nbins: int) -> torch.Tensor:
    idx = values.clamp(0, nbins - 1).to(torch.int64)
    out = torch.zeros(values.shape[:-1] + (nbins,), dtype=torch.int32,
                      device=values.device)
    return out.scatter_add_(-1, idx, torch.ones_like(idx, dtype=torch.int32))


# -- SpMV, ELL format (PrIM §4.3) -------------------------------------------------

def spmv_ell(vals: torch.Tensor, cols: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """vals/cols: (..., rows, k) padded ELL (cols == -1 ⇒ padding); x: (n,).

    As the reference oracle: a column at or past ``n`` reads ``x[n-1]``
    (a JAX gather clamps), and a padded slot multiplies its value by a
    gathered 0, so a non-finite value there gives NaN.  The result has
    the promoted dtype of ``vals * x``."""
    gathered = torch.where(cols >= 0, x[cols.clamp(0, x.shape[0] - 1)],
                           torch.zeros((), dtype=x.dtype, device=x.device))
    return (vals * gathered).sum(-1)


# -- grouped (MoE expert) matmul ------------------------------------------------

def moe_gmm(xg: torch.Tensor, w: torch.Tensor,
            counts: torch.Tensor) -> torch.Tensor:
    """xg: (E, C, d) tokens grouped per expert (capacity C, zero-padded);
    w: (E, d, f); counts: (E,) valid rows.  A float32 product with the
    rows at or past ``counts[e]`` zeroed, cast to xg's dtype."""
    y = torch.einsum("ecd,edf->ecf", xg.to(torch.float32),
                     w.to(torch.float32))
    mask = (torch.arange(xg.shape[1], device=xg.device)[None, :, None]
            < counts.to(xg.device)[:, None, None])
    return torch.where(mask, y, 0.0).to(xg.dtype)


# -- selective-SSM scan (SSD / Mamba-2 form) -------------------------------------

def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, h0: torch.Tensor | None = None):
    """Sequential oracle for the SSD recurrence.

    x: (B, S, H, P) head inputs; a: (B, S, H) per-head decay in (0, 1];
    b, c: (B, S, N) input / output projections shared across heads.
    Returns y (B, S, H, P) in x's dtype and the final h (B, H, N, P) in
    float32:  h_t = a_t * h_{t-1} + b_t ⊗ x_t ;  y_t = c_t · h_t."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    xf, af, bf, cf = (t.to(torch.float32) for t in (x, a, b, c))
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    ys = []
    for t in range(S):
        h = af[:, t, :, None, None] * h + torch.einsum(
            "bn,bhp->bhnp", bf[:, t], xf[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], h))
    y = torch.stack(ys, 1) if ys else xf.new_zeros((B, 0, H, P))
    return y.to(x.dtype), h
