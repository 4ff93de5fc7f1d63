"""Mixture-of-Experts FFN — the PyTorch counterpart of ``repro.models.moe``:
top-k routing, sort-based capacity dispatch, shared experts (the DeepSeek /
Kimi style) and the Switch load-balancing loss.

Each token's K (token, expert) pairs are ranked within their expert by a
stable sort, bucketed into an (E, C, d) capacity layout (pairs past the
capacity drop, GShard's rule), multiplied by the experts' weights (an
einsum, or the ``moe_gmm`` kernel with ``use_kernel=True``) and combined
with the router weights.  Parameters are named as the reference's keys
(``router``, ``wi``, ``wo``, ``shared.wi``, ``shared.wo``), so a weight
carry matches them by name.

The reference's ``apply_ep`` runs the experts sharded over a TPU mesh
(``shard_map``); one GPU has no counterpart, and a config with
``moe_ep=True`` is refused when its model is built
(``transformer.check_ported``).  ``moe_dispatch_sharded`` only adds
sharding constraints there and changes nothing here.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from .layers import MLP, ModelConfig, _param, dense_init, swiglu


class MoE(nn.Module):
    """``router`` (d, E) float32 whatever the model's dtype, ``wi``
    (E, d, 2f) fused gate|up, ``wo`` (E, f, d) and, with shared experts,
    ``shared``, one SwiGLU ``MLP`` of width f · n_shared.  Drawn from
    ``gen`` when it is given (the reference's scheme: fan-in of d for
    ``wi``, of f for ``wo``), uninitialised otherwise (for a weight
    carry)."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
        shapes = {"router": ((d, E), torch.float32, 0),
                  "wi": ((E, d, 2 * f), cfg.dtype, 1),
                  "wo": ((E, f, d), cfg.dtype, 1)}
        for name, (shape, dtype, in_axis) in shapes.items():
            w = (dense_init(gen, shape, dtype, device, in_axis=in_axis)
                 if gen is not None
                 else torch.empty(shape, dtype=dtype, device=device))
            setattr(self, name, _param(w))
        if cfg.moe_shared_experts:
            self.shared = MLP(cfg, f * cfg.moe_shared_experts, gen=gen,
                              device=device)


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert: the capacity factor's share of the pairs,
    truncated, then rounded up to a multiple of 8 (at least 8)."""
    c = int(cfg.moe_capacity_factor * n_tokens * cfg.moe_top_k
            / cfg.moe_experts)
    return max(8, -(-c // 8) * 8)


def route(p: MoE, cfg: ModelConfig, xt: torch.Tensor):
    """Router of the (T, d) tokens ``xt``: softmax probabilities (T, E) in
    float32, the top-k experts (T, K) and their gates renormalised over
    the K, in xt's dtype."""
    logits = xt.to(torch.float32) @ p.router
    probs = torch.softmax(logits, dim=-1)
    gate, topk = probs.topk(cfg.moe_top_k, dim=-1)
    gate = (gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)).to(xt.dtype)
    return probs, gate, topk


def apply(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
          use_kernel: bool = False):
    """x: (B, S, d) -> ((B, S, d), aux), aux the float32 load-balancing
    loss."""
    B, S, d = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, d)
    C = _capacity(cfg, T)
    probs, gate, topk = route(p, cfg, xt)

    # rank of each pair within its expert: a stable sort keeps token order
    ef = topk.reshape(-1)                                    # (T*K,)
    order = torch.argsort(ef, stable=True)
    counts = torch.bincount(ef, minlength=E)                 # (E,)
    if apply.routing is not None:
        apply.routing.append((topk.sort(-1).values,
                              int((counts - C).clamp(min=0).sum())))
    starts = counts.cumsum(0) - counts
    rank = torch.empty_like(ef)
    rank[order] = torch.arange(T * K, device=x.device) - starts[ef[order]]

    # dispatch: dropped pairs go to the spare row E*C, which is cut off
    kept = rank < C
    slot = torch.where(kept, ef * C + rank, E * C)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xt[tok]
    xg = buf[:E * C].view(E, C, d)

    # the experts: (E, C, ·) @ (E, ·, ·), the kernel masking rows past
    # each expert's count (zero rows here, as the buffer left them)
    if use_kernel:
        cnt = counts.clamp(max=C).to(torch.int32)
        experts = lambda a, w: ops.moe_gmm(a, w, cnt)    # noqa: E731
    else:
        experts = torch.bmm
    g, u = experts(xg, p.wi).chunk(2, dim=-1)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    yg = experts(h, p.wo)

    # combine: each pair's expert output, weighted; a token's K pairs are
    # adjacent (tok = repeat(arange(T), K)), so the segment sum is a sum
    # over K
    flat = yg.reshape(E * C, d)
    pair_out = torch.where(kept[:, None], flat[slot.clamp(max=E * C - 1)], 0)
    y = (pair_out * gate.reshape(-1)[:, None]).view(T, K, d).sum(1)

    if cfg.moe_shared_experts:
        y = y + swiglu(xt, p.shared.wi, p.shared.wo)

    frac_tok = counts.to(torch.float32) / max(T * K, 1)
    aux = E * (frac_tok * probs.mean(0)).sum()
    return y.reshape(B, S, d).to(x.dtype), aux


#: None, or a list to which every call appends each token's top-k experts
#: (T, K), sorted, and the number of pairs past the capacity
apply.routing = None
