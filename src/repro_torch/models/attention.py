"""GQA attention layer — the PyTorch counterpart of
``repro.models.attention``: the full-sequence forward (prefill or
scoring), which runs the ``flash_attention`` kernel with
``use_kernel=True``, the cached one-token decode, and the VLM family's
cross attention over the frontend's tokens (non-causal, no RoPE, the
plain ``kernels/ref.attention`` as in the reference, and in decode the
plain ``decode_attention`` over a cache of the frontend's keys and
values, made once).

Weights are ``(d_in, d_out)`` parameters named as the reference's keys
(``wq``, ``wk``, ``wv``, ``wo`` and, with ``qkv_bias``, ``bq``, ``bk``,
``bv``).  The reference's KV cache is immutable and ``decode`` returns a
new one; here the new key and value are written into the cache tensors
in place (no copy of the cache per token), and the returned cache is the
same dict with its ``len`` advanced.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops, ref as kref
from repro_torch.core.sharding import P
from .layers import ModelConfig, _param, dense_init, emb_axis, rope

class Attention(nn.Module):
    """One attention layer's weights, drawn from ``gen`` when it is given
    (the reference's init scheme) and left uninitialised otherwise (for a
    weight carry)."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        H, KVH = cfg.n_heads, cfg.n_kv_heads
        shapes = {"wq": (d, H * hd), "wk": (d, KVH * hd),
                  "wv": (d, KVH * hd), "wo": (H * hd, d)}
        for name, shape in shapes.items():
            w = (dense_init(gen, shape, cfg.dtype, device) if gen is not None
                 else torch.empty(shape, dtype=cfg.dtype, device=device))
            setattr(self, name, _param(w))
        if cfg.qkv_bias:
            for name, n in (("bq", H * hd), ("bk", KVH * hd), ("bv", KVH * hd)):
                setattr(self, name, _param(torch.zeros(n, dtype=cfg.dtype,
                                                       device=device)))


def specs(cfg: ModelConfig) -> dict:
    """The reference's specs of the layer's weights (its ``init``)."""
    e = emb_axis(cfg.fsdp)
    out = {"wq": P(e, "model"), "wk": P(e, "model"),
           "wv": P(e, "model"), "wo": P("model", e)}
    if cfg.qkv_bias:
        out |= {"bq": P("model"), "bk": P("model"), "bv": P("model")}
    return out


def init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Attention:
    return Attention(cfg, gen=gen, device=device)


def _bias(p: Attention, name: str):
    return getattr(p, name) if hasattr(p, name) else 0


def _project(p: Attention, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor):
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p.wq + _bias(p, "bq")
    k = x @ p.wk + _bias(p, "bk")
    v = x @ p.wv + _bias(p, "bv")
    q = q.reshape(B, S, H, hd).transpose(1, 2)
    k = k.reshape(B, S, KVH, hd).transpose(1, 2)
    v = v.reshape(B, S, KVH, hd).transpose(1, 2)
    q = rope(q, positions[:, None, :], cfg.rope_theta)
    k = rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def apply(p: Attention, cfg: ModelConfig, x: torch.Tensor, *,
          positions: torch.Tensor | None = None,
          use_kernel: bool = False) -> torch.Tensor:
    """Training / prefill self-attention. x: (B, S, d)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project(p, cfg, x, positions)
    attn = ops.attention if use_kernel else kref.attention
    o = attn(q, k, v, causal=True, window=cfg.window)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
    return o @ p.wo


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    dtype = dtype or cfg.dtype
    shape = (batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def attend_cached(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, cache: dict):
    """The decode step after the projections and rope: write the new k, v
    (B, KVH, 1, hd) at position ``len`` (the same for the whole batch, as
    in the reference's server), attend q (B, H, 1, hd) over the cache, and
    advance ``len``.  Returns ((B, 1, H * hd), cache)."""
    B = q.shape[0]
    idx = cache["len"][:1].long()
    cache["k"].index_copy_(2, idx, k.to(cache["k"].dtype))
    cache["v"].index_copy_(2, idx, v.to(cache["v"].dtype))
    lengths = cache["len"] + 1
    o = ops.decode_attention(q, cache["k"], cache["v"], lengths,
                             window=cfg.window,
                             impl="grouped" if cfg.fast_decode else "ref")
    cache["len"] = lengths
    return o.transpose(1, 2).reshape(B, 1, cfg.n_heads * cfg.hd), cache


def decode(p: Attention, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """Single-token decode. x: (B, 1, d); returns (y, cache)."""
    positions = cache["len"][:, None]
    q, k, v = _project(p, cfg, x, positions)
    o, cache = attend_cached(cfg, q, k, v, cache)
    return o @ p.wo, cache


# -- cross attention (VLM image layers) --------------------------------------

def init_cross(gen: torch.Generator, cfg: ModelConfig,
               device=None) -> Attention:
    """A cross-attention layer's weights: the keys of a self-attention
    layer, as the reference's ``init_cross``."""
    return Attention(cfg, gen=gen, device=device)


def promoted_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the dtype jnp would give it: a frontend in another
    float dtype than the weights promotes both (bfloat16 with float32 is
    float32), never a quiet cast to the weights' dtype."""
    if not (a.is_floating_point() and w.is_floating_point()):
        raise TypeError(f"cross attention takes float frontend tokens, got "
                        f"{a.dtype}")
    t = torch.promote_types(a.dtype, w.dtype)
    return a.to(t) @ w.to(t)


def cross_kv(p: Attention, cfg: ModelConfig, kv_tokens: torch.Tensor):
    """The frontend's keys and values, (B, KVH, T, hd) each, in the
    promoted dtype of the frontend and the weights."""
    B, T, _ = kv_tokens.shape
    KVH, hd = cfg.n_kv_heads, cfg.hd
    k = promoted_matmul(kv_tokens, p.wk).reshape(B, T, KVH, hd)
    v = promoted_matmul(kv_tokens, p.wv).reshape(B, T, KVH, hd)
    return k.transpose(1, 2), v.transpose(1, 2)


def apply_cross(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                kv_tokens: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) text; kv_tokens: (B, T, d) frontend embeddings.  Every
    text position attends to every frontend token; no RoPE, no bias."""
    if kv_tokens is None:
        raise ValueError("a cross-attention layer needs the frontend's "
                         "tokens: pass frontend=")
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = (x @ p.wq).reshape(B, S, H, hd).transpose(1, 2)
    k, v = cross_kv(p, cfg, kv_tokens)
    o = kref.attention(q, k, v, causal=False)
    return o.transpose(1, 2).reshape(B, S, H * hd) @ p.wo


def init_cross_cache(p: Attention, cfg: ModelConfig,
                     frontend: torch.Tensor) -> dict:
    """The cross layer's decode cache: the frontend's keys and values,
    ``{"ck", "cv"}`` (B, KVH, T, hd), computed once."""
    if frontend is None:
        raise ValueError("a cross-attention layer's cache needs the "
                         "frontend's tokens: pass frontend=")
    ck, cv = cross_kv(p, cfg, frontend)
    return {"ck": ck, "cv": cv}


def decode_cross(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 cache: dict):
    """One token's cross attention over the cached frontend keys and
    values (all T of them valid). x: (B, 1, d); returns (y, cache)."""
    B = x.shape[0]
    q = (x @ p.wq).reshape(B, 1, cfg.n_heads, cfg.hd).transpose(1, 2)
    T = cache["ck"].shape[2]
    lens = torch.full((B,), T, dtype=torch.int32, device=x.device)
    o = ops.decode_attention(q, cache["ck"], cache["cv"], lens, impl="ref")
    return o.transpose(1, 2).reshape(B, 1, cfg.n_heads * cfg.hd) @ p.wo, cache
