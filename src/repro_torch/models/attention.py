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

Tensor parallelism (a layer built with ``tp``, the mesh's "model" axis of
M ranks): rank r holds the reference's contiguous block r of the columns
of ``wq`` / ``wk`` / ``wv`` (``bq`` / ``bk`` / ``bv``) and the same rows of
``wo``, wherever a head falls (``layers.head_split``).  It computes every
query head its columns touch, whole, and the kv heads those use
(``kv_heads``): where its block of q (or of k and v) is not those heads
whole, it gathers the blocks over "model" (one call for q, k and v) and
keeps them.  RoPE rotates whole heads, the kernel runs on them, and the
rank keeps its own columns of their output for its rows of ``wo``.
Where its query heads use their kv heads unevenly, it keeps one kv head a
query head (a local MHA).  The layer's input enters through ``copy_to``
and its output is the ranks' partial sums added (``reduce_from``); the
caches hold the kv heads the rank keeps.  A decode
cache split along the sequence over the data axes (a replicated batch,
``launch.serve.seq_shard``) holds the rank's block of positions: each
step writes position ``len`` on the rank that owns it, computes the
rank's partial softmax (``decode_partial``) and merges the ranks' by
log-sum-exp (``merge_partials``), before ``wo``'s sum over "model".  Under
FSDP (``fs``, the "data" axis) the rank holds its block of the d rows of
``wq`` / ``wk`` / ``wv`` and of the d columns of ``wo``, and each call
gathers them (``layers.gathered``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels import ops, ref as kref
from repro_torch.core import sharding
from repro_torch.core.sharding import SOLO, Group, P
from .layers import (ModelConfig, _param, build, emb_axis, gather_blocks,
                     gathered, head_split, layout, rope)


def kv_heads(cfg: ModelConfig, m: int, r: int):
    """The kv heads that rank ``r`` of ``m`` keeps for the query heads
    its columns touch (``layers.head_split``): a slice of them where
    those query heads use them evenly (the kernel's query head h reads kv
    head h // (query heads / kv heads)), else one kv head a query head,
    repeated where two share it (a list of indices)."""
    rep = cfg.n_heads // cfg.n_kv_heads
    hs = head_split(cfg.n_heads, cfg.hd, m, r).heads
    kv = slice(hs.start // rep, (hs.stop - 1) // rep + 1)
    uses = {min(hs.stop, (j + 1) * rep) - max(hs.start, j * rep)
            for j in range(kv.start, kv.stop)}
    return kv if len(uses) == 1 else [h // rep
                                      for h in range(hs.start, hs.stop)]


class Attention(nn.Module):
    """One attention layer's weights, drawn from ``gen`` when it is given
    (the reference's init scheme) and left uninitialised otherwise (for a
    weight carry); on ``tp`` the rank's part (module docstring).
    ``split``: the rank's ``layers.HeadSplit`` of the query columns;
    ``kv``: the kv heads it keeps (``kv_heads``); ``heads``: (query, kv)
    heads it computes; ``gather_q`` / ``gather_kv``: whether it gathers
    the queries / the keys and values over "model"."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator | None = None,
                 device=None, tp: Group = SOLO, fs: Group = SOLO):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        H, KVH = cfg.n_heads, cfg.n_kv_heads
        shapes = {"wq": (d, H * hd), "wk": (d, KVH * hd),
                  "wv": (d, KVH * hd), "wo": (H * hd, d)}
        sp = specs(cfg)
        build(self, shapes, sp, cfg.dtype, gen, device, tp, fs)
        if cfg.qkv_bias:
            for name, n in (("bq", H * hd), ("bk", KVH * hd), ("bv", KVH * hd)):
                lay = layout(name, sp[name], (n,), tp.size)
                setattr(self, name, _param(torch.zeros(
                    lay.local((n,)) if lay else n, dtype=cfg.dtype,
                    device=device)))
                if lay is not None:
                    self.layouts[name] = lay
        self.split = head_split(H, hd, tp.size, tp.index)
        self.kv = kv_heads(cfg, tp.size, tp.index)
        own = head_split(KVH, hd, tp.size, tp.index)
        self.gather_q = not self.split.whole
        self.gather_kv = not (own.whole and self.kv == own.heads)
        n = self.kv.stop - self.kv.start if isinstance(self.kv, slice) \
            else len(self.kv)
        self.heads = (self.split.n, n)


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


def _heads(p: Attention, cfg: ModelConfig, q=None, k=None, v=None):
    """The heads the rank computes of its blocks ``q`` (B, S, ·) and ``k``
    / ``v`` (B, T, ·), as (B, ·, heads, hd): its query columns' touched
    heads whole and the kv heads it keeps (``kv_heads``).  What does not
    lie whole in the rank's block is gathered over "model", in one call
    for the tensors of one length (``layers.gather_blocks``)."""
    ts = {"q": q, "k": k, "v": v}
    groups: dict = {}
    for n, t in ts.items():
        if t is not None and (p.gather_q if n == "q" else p.gather_kv):
            groups.setdefault((t.shape[:-1], t.dtype), []).append(n)
    for group in groups.values():
        ts.update(zip(group, gather_blocks(p.tp, [ts[n] for n in group])))
    out = []
    for n, t in ts.items():
        if t is None:
            continue
        t = t.unflatten(-1, (-1, cfg.hd))
        if n == "q":
            out.append(t[:, :, p.split.heads] if p.gather_q else t)
        else:
            out.append(t[:, :, p.kv] if p.gather_kv else t)
    return out


def _project(p: Attention, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor):
    q = x @ p.wq + _bias(p, "bq")
    k = x @ p.wk + _bias(p, "bk")
    v = x @ p.wv + _bias(p, "bv")
    q, k, v = (t.transpose(1, 2) for t in _heads(p, cfg, q, k, v))
    q = rope(q, positions[:, None, :], cfg.rope_theta)
    k = rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def _out(p: Attention, o: torch.Tensor, reduce: bool) -> torch.Tensor:
    """The output (B, S, heads · hd) of the heads the rank computes: its
    own columns of them through its rows of ``wo``; the ranks' partial
    sums added unless ``reduce=False``."""
    if p.gather_q:
        o = o[..., p.split.own]
    y = o @ p.wo
    return p.tp.reduce_from(y) if reduce else y


def apply(p: Attention, cfg: ModelConfig, x: torch.Tensor, *,
          positions: torch.Tensor | None = None,
          use_kernel: bool = False, reduce: bool = True) -> torch.Tensor:
    """Training / prefill self-attention. x: (B, S, d); ``reduce=False``
    gives the rank's partial sum (the caller adds the ranks')."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    p = gathered(p)
    q, k, v = _project(p, cfg, p.tp.copy_to(x), positions)
    attn = ops.attention if use_kernel else kref.attention
    o = attn(q, k, v, causal=True, window=cfg.window)
    return _out(p, o.transpose(1, 2).reshape(B, S, -1), reduce)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None, kv_heads: int | None = None) -> dict:
    """``kv_heads``: the kv heads the rank keeps (default all)."""
    dtype = dtype or cfg.dtype
    shape = (batch, kv_heads or cfg.n_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def attend_cached(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, cache: dict, seq: Group = SOLO):
    """The decode step after the projections and rope: write the new k, v
    (B, KVH, 1, hd) at position ``len`` (the same for the whole batch, as
    in the reference's server), attend q (B, H, 1, hd) over the cache, and
    advance ``len``.  Returns ((B, 1, H * hd), cache).

    On ``seq`` (the data axes over which the cache's positions are split,
    ``launch.serve.seq_shard``) the cache holds the rank's block of T
    positions, ``seq.index`` · T …: the rank that owns position ``len``
    writes it, every rank attends over its block (``decode_partial``) and
    the ranks' partial softmaxes are merged (``merge_partials``).  ``len``
    stays global and equal on every rank (RoPE reads it)."""
    B = q.shape[0]
    impl = "grouped" if cfg.fast_decode else "ref"
    lengths = cache["len"] + 1
    if seq.size == 1:
        idx = cache["len"][:1].long()
        cache["k"].index_copy_(2, idx, k.to(cache["k"].dtype))
        cache["v"].index_copy_(2, idx, v.to(cache["v"].dtype))
        o = ops.decode_attention(q, cache["k"], cache["v"], lengths,
                                 window=cfg.window, impl=impl)
    else:
        start = seq.index * cache["k"].shape[2]
        write_owned(cache, k, v, start)
        o = merge_partials(*decode_partial(
            q, cache["k"], cache["v"], lengths, start=start,
            window=cfg.window, impl=impl), seq).to(q.dtype)
    cache["len"] = lengths
    return o.transpose(1, 2).reshape(B, 1, q.shape[1] * cfg.hd), cache


def write_owned(cache: dict, k: torch.Tensor, v: torch.Tensor,
                start: int) -> None:
    """Write k, v (B, KVH, 1, hd) at global position ``len`` into a cache
    block of the T positions ``start`` … ``start + T - 1``, where the
    block holds that position; elsewhere the slot at the clamped index is
    written back with what it held.  No host sync: the owner is decided
    on the device."""
    T = cache["k"].shape[2]
    pos = cache["len"][:1].long() - start
    own = (pos >= 0) & (pos < T)
    idx = pos.clamp(0, T - 1)
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        c.index_copy_(2, idx, torch.where(own, new.to(c.dtype),
                                          c.index_select(2, idx)))


def decode_partial(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, lengths: torch.Tensor, *,
                   start: int = 0, window: int | None = None,
                   impl: str = "ref"):
    """One rank's part of a decode attention over a cache block of the T
    positions ``start`` … ``start + T - 1`` (the window masked by global
    position: valid is ``start + t < len`` and ``start + t >= len -
    window``).  q: (B, H, 1, D); caches (B, KVH, T, D); lengths (B,).

    With s_t = q·k_t / sqrt(D) over the block's valid slots, returns
    float32 (m, l, o), m and l (B, H, 1, 1), o (B, H, 1, D):
        m = max_t s_t,   l = Σ_t e^(s_t − m),   o = Σ_t e^(s_t − m) v_t.
    A block with no valid slot gives m = −inf, l = 0, o = 0 (no NaN).
    ``impl`` as ``ops.decode_attention``'s: "ref" repeats the cache over
    the query group in float32; "grouped" (the reference's
    ``fast_decode``) never repeats it, and rounds the block's
    unnormalised weights e^(s_t − m) to q's dtype before the value
    product.  That form rounds the normalised probabilities instead (by
    the whole row's max and sum), which a block cannot know, so in
    bfloat16 a split cache agrees with it within bfloat16's rounding of
    the weights, not bit for bit; in float32 the rounding is none."""
    B, H, _, D = q.shape
    KVH, T = k_cache.shape[1], k_cache.shape[2]
    group = H // KVH
    f32 = torch.float32
    valid = kref._decode_valid(lengths, T, window, start)
    if impl == "grouped":
        s = torch.einsum("bkgd,bktd->bkgt", q.reshape(B, KVH, group, D)
                         .to(f32), k_cache.to(f32))
    else:
        s = torch.einsum("bhqd,bhtd->bhqt", q.to(f32),
                         k_cache.repeat_interleave(group, 1).to(f32))
    s = (s * (1.0 / math.sqrt(D))).masked_fill(~valid, float("-inf"))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - torch.where(m == float("-inf"), 0.0, m))
    del s
    l = e.sum(-1, keepdim=True)
    if impl == "grouped":
        o = torch.einsum("bkgt,bktd->bkgd", e.to(q.dtype).to(f32),
                         v_cache.to(f32))
    else:
        o = torch.einsum("bhqt,bhtd->bhqd", e,
                         v_cache.repeat_interleave(group, 1).to(f32))
    return (m.reshape(B, H, 1, 1), l.reshape(B, H, 1, 1),
            o.reshape(B, H, 1, D))


def merge_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                   seq: Group) -> torch.Tensor:
    """The attention output from the ranks' ``decode_partial``s over the
    axes of ``seq``, by log-sum-exp: with M = max_i m_i (an all-reduce
    MAX) and a_i = e^(m_i − M) (0 for a rank with m_i = −inf),
        out = Σ_i a_i o_i / Σ_i a_i l_i,
    the sums one all-reduce SUM of (a_i l_i, a_i o_i) packed together —
    softmax(s) · v over the union of the blocks.  Float32 (B, H, 1, D); a
    row with no valid position anywhere gives 0.  The collectives count
    in ``sharding.STATS``' ``merge_`` keys."""
    def reduce():
        M = sharding.all_reduce(m.clone(), seq.mesh, seq.axis,
                                op=sharding.dist.ReduceOp.MAX)
        return sharding.all_reduce(rescaled(m, l, o, M), seq.mesh, seq.axis)
    return normalized(sharding.counted_as("merge_", reduce))


def rescaled(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
             M: torch.Tensor) -> torch.Tensor:
    """(a l, a o) packed on the last dimension, a = e^(m − M): one rank's
    terms of ``merge_partials``' sums (a = 0 where m = −inf)."""
    a = torch.exp(m - torch.where(M == float("-inf"), 0.0, M))
    return torch.cat([a * l, a * o], dim=-1)


def normalized(packed: torch.Tensor) -> torch.Tensor:
    """Σ a o / Σ a l from the summed ``rescaled`` terms (0 where the sum
    of a l is 0: no valid position anywhere)."""
    L, O = packed[..., :1], packed[..., 1:]
    return O / torch.where(L > 0, L, 1.0)


def decode(p: Attention, cfg: ModelConfig, x: torch.Tensor, cache: dict,
           reduce: bool = True, seq: Group = SOLO):
    """Single-token decode. x: (B, 1, d); returns (y, cache); ``seq``:
    the axes over which the cache's positions are split
    (``attend_cached``)."""
    p = gathered(p)
    positions = cache["len"][:, None]
    q, k, v = _project(p, cfg, p.tp.copy_to(x), positions)
    o, cache = attend_cached(cfg, q, k, v, cache, seq)
    return _out(p, o, reduce), cache


# -- cross attention (VLM image layers) --------------------------------------

def init_cross(gen: torch.Generator, cfg: ModelConfig, device=None,
               tp: Group = SOLO, fs: Group = SOLO) -> Attention:
    """A cross-attention layer's weights: the keys of a self-attention
    layer, as the reference's ``init_cross``."""
    return Attention(cfg, gen=gen, device=device, tp=tp, fs=fs)


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
    """The frontend's keys and values, (B, kv heads, T, hd) each (the kv
    heads the rank keeps), in the promoted dtype of the frontend and the
    weights."""
    p = gathered(p)
    k, v = _heads(p, cfg, k=promoted_matmul(kv_tokens, p.wk),
                  v=promoted_matmul(kv_tokens, p.wv))
    return k.transpose(1, 2), v.transpose(1, 2)


def apply_cross(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                kv_tokens: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    """x: (B, S, d) text; kv_tokens: (B, T, d) frontend embeddings.  Every
    text position attends to every frontend token; no RoPE, no bias.
    ``reduce`` as ``apply``'s."""
    if kv_tokens is None:
        raise ValueError("a cross-attention layer needs the frontend's "
                         "tokens: pass frontend=")
    B, S, _ = x.shape
    p = gathered(p)
    q, = _heads(p, cfg, q=p.tp.copy_to(x) @ p.wq)
    k, v = cross_kv(p, cfg, kv_tokens)
    o = kref.attention(q.transpose(1, 2), k, v, causal=False)
    return _out(p, o.transpose(1, 2).reshape(B, S, -1), reduce)


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
                 cache: dict, reduce: bool = True):
    """One token's cross attention over the cached frontend keys and
    values (all T of them valid). x: (B, 1, d); returns (y, cache);
    ``reduce`` as ``apply``'s."""
    B = x.shape[0]
    p = gathered(p)
    q, = _heads(p, cfg, q=p.tp.copy_to(x) @ p.wq)
    T = cache["ck"].shape[2]
    lens = torch.full((B,), T, dtype=torch.int32, device=x.device)
    o = ops.decode_attention(q.transpose(1, 2), cache["ck"], cache["cv"],
                             lens, impl="ref")
    return _out(p, o.transpose(1, 2).reshape(B, 1, -1), reduce), cache
