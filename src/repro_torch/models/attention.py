"""GQA attention layer — the PyTorch counterpart of
``repro.models.attention``: the full-sequence forward (prefill or
scoring), which runs the ``flash_attention`` kernel with
``use_kernel=True``, and the cached one-token decode.

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
from .layers import ModelConfig, _param, dense_init, rope

#: what the VLM family's cross attention raises
_NO_CROSS = ("cross attention (the VLM family's image layers) is not ported "
             "yet: ROADMAP queue 1, item 9, cross attention")


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

def init_cross(gen: torch.Generator, cfg: ModelConfig, device=None):
    raise NotImplementedError(_NO_CROSS)


def apply_cross(p, cfg: ModelConfig, x, kv_tokens):
    raise NotImplementedError(_NO_CROSS)
