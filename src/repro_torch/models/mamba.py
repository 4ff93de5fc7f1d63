"""Mamba mixer (SSD / Mamba-2 form) for the hybrid family — the PyTorch
counterpart of ``repro.models.mamba``.

in_proj (d → 2·di: x | z) → causal depthwise conv on x → per-head decay
a = exp(−Δ·exp(a_log)), Δ = softplus(x·dt_proj + dt_bias) → the SSD scan
(the ``ssd_scan`` kernel with ``use_kernel=True``, the sequential oracle
otherwise) → gate y·silu(z) → RMSNorm → out_proj.  Decode keeps the last
conv_k − 1 inputs and the (H, N, P) float32 state as its cache: O(1) per
token.  Parameters are named as the reference's keys; ``dt_bias`` and
``a_log`` are float32 whatever the model's dtype.

Tensor parallelism (``tp``, the "model" axis of M ranks): rank r holds
the reference's contiguous block r of the channels of the inner width di
wherever a head falls (``split``, a ``layers.HeadSplit``) — in
``in_proj`` (x block and z block), ``conv`` and ``norm``, the rows of
those channels in ``bc_proj``, ``dt_proj`` and ``out_proj`` — and
``dt_bias`` / ``a_log`` whole, of which it uses the touched heads' part
through ``copy_to`` (the ranks that share a head each add their own
columns' share of its gradient).  ``bc_proj`` / ``dt_proj``'s products,
and the gated norm's sum of squares over di, are summed over the ranks
in both directions (each rank uses the sums for its own columns);
``out_proj``'s partial sums are added.  The recurrence is separable over
a head's P columns (the decay is the head's, b and c are whole), so a
rank scans only its own columns of each head it touches, laid out as w
columns a head with zero columns where they lie unevenly
(``layers.padded_layout``): a zero column gives a zero output and state,
and is dropped before the gate.  The cache holds the rank's channels and
its own columns' state, (B, touched heads, N, w).  Under FSDP (``fs``,
the "data" axis) the rank holds its block of the d rows of ``in_proj``
and of the d columns of ``out_proj``, which each call gathers
(``layers.gathered``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops, ref as kref
from repro_torch.core.sharding import SOLO, Group, P
from .layers import (ModelConfig, _param, build, emb_axis, gathered,
                     head_split, layout, own_columns, pad_heads,
                     padded_layout, rms_norm_parts)


def _dims(cfg: ModelConfig):
    """(di, H, P, N): inner width, SSM heads, head dim, state size."""
    di = cfg.ssm_expand * cfg.d_model
    H = di // cfg.ssm_head_dim
    return di, H, cfg.ssm_head_dim, cfg.ssm_state


class Mamba(nn.Module):
    """One Mamba mixer's weights, drawn from ``gen`` when it is given (the
    reference's scheme) and left uninitialised otherwise; on ``tp`` the
    rank's part (module docstring).  ``split``: the rank's
    ``layers.HeadSplit`` of the di channels; ``u_layout``: how its own
    columns lie in its touched heads (``layers.padded_layout``)."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator | None = None,
                 device=None, tp: Group = SOLO, fs: Group = SOLO):
        super().__init__()
        d = cfg.d_model
        di, H, _, N = _dims(cfg)
        shapes = {"in_proj": (d, 2 * di), "conv": (cfg.ssm_conv, di),
                  "bc_proj": (di, 2 * N), "dt_proj": (di, H),
                  "out_proj": (di, d)}
        build(self, shapes, specs(cfg), cfg.dtype, gen, device, tp, fs)
        self.dt_bias = _param(torch.zeros(H, dtype=torch.float32, device=device))
        self.a_log = _param(torch.zeros(H, dtype=torch.float32, device=device))
        lay = layout("norm", specs(cfg)["norm"], (di,), tp.size)
        self.norm = _param(torch.ones(lay.local((di,)) if lay else di,
                                      dtype=cfg.dtype, device=device))
        if lay is not None:
            self.layouts["norm"] = lay
        self.split = head_split(H, cfg.ssm_head_dim, tp.size, tp.index)
        self.u_layout = padded_layout(self.split)


def specs(cfg: ModelConfig) -> dict:
    """The reference's specs of the mixer's weights (its ``init``)."""
    e = emb_axis(cfg.fsdp)
    return {"in_proj": P(e, "model"), "conv": P(None, "model"),
            "bc_proj": P("model", None), "dt_proj": P("model", None),
            "dt_bias": P(None), "a_log": P(None), "norm": P("model"),
            "out_proj": P("model", e)}


def _conv_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, di); w: (K, di) depthwise causal conv: the sum of K
    shifted products in x's dtype, in the reference's order, then silu in
    float32 (not ``conv1d``: cuDNN would sum in another order, and in TF32
    by default)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu(out.to(torch.float32)).to(x.dtype)


def _ssm_inputs(p: Mamba, cfg: ModelConfig, xc: torch.Tensor):
    """From the rank's channels ``xc`` (B, S, di / M): the scan's inputs
    of the heads they touch — u (B, S, heads, w), the rank's own columns
    of each (``u_layout``), and a (B, S, heads) — and b, c (B, S, N)."""
    tp, heads = p.tp, p.split.heads
    b, c = tp.reduce_both(xc @ p.bc_proj).chunk(2, dim=-1)  # (B, S, N) each
    dt = tp.reduce_both(xc.to(torch.float32) @ p.dt_proj.to(torch.float32))
    # softplus as jax.nn.softplus writes it, log(exp(x) + 1)
    dt = torch.logaddexp(dt[..., heads] + tp.copy_to(p.dt_bias)[heads],
                         torch.zeros((), device=xc.device))
    a = torch.exp(-dt * torch.exp(tp.copy_to(p.a_log)[heads]))  # in (0, 1)
    xh = pad_heads(xc, p.u_layout)
    u = xh * dt[..., None].to(xh.dtype)                     # Δ-scaled input
    return u, a, b, c


def _out(p: Mamba, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
         reduce: bool) -> torch.Tensor:
    """The gate, the norm over di and ``out_proj`` of the rank's channels
    (``y`` (B, S, heads · w), the scan's output of its touched heads);
    the ranks' partial sums added unless ``reduce=False``."""
    y = own_columns(y, p.u_layout).to(z.dtype)
    y = y * F.silu(z.to(torch.float32)).to(z.dtype)
    y = rms_norm_parts(y, p.norm, _dims(cfg)[0], p.tp) @ p.out_proj
    return p.tp.reduce_from(y) if reduce else y


def apply(p: Mamba, cfg: ModelConfig, x: torch.Tensor, *,
          use_kernel: bool = False, reduce: bool = True) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); ``reduce=False`` gives the rank's
    partial sum (the caller adds the ranks')."""
    p = gathered(p)
    xi, z = (p.tp.copy_to(x) @ p.in_proj).chunk(2, dim=-1)
    xc = _conv_causal(xi, p.conv)
    u, a, b, c = _ssm_inputs(p, cfg, xc)
    scan = ops.ssd_scan if use_kernel else kref.ssd_scan
    y, _ = scan(u, a, b, c)                                 # (B, S, heads, w)
    return _out(p, cfg, y.flatten(-2), z, reduce)


def init_cache(cfg: ModelConfig, batch: int, dtype=None, device=None,
               m: int = 1, r: int = 0) -> dict:
    """``conv``: the last conv_k − 1 inputs (B, K − 1, di / m) in the
    model's dtype; ``ssm``: the state (B, heads, N, w) in float32 — the
    channels of rank ``r`` of ``m`` model ranks and its own columns of
    each head they touch (``layers.padded_layout``)."""
    dtype = dtype or cfg.dtype
    di, H, P, N = _dims(cfg)
    sp = head_split(H, P, m, r)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, di // m),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, sp.n, N, padded_layout(sp)[0]),
                               dtype=torch.float32, device=device)}


def decode(p: Mamba, cfg: ModelConfig, x: torch.Tensor, cache: dict,
           reduce: bool = True):
    """x: (B, 1, d); one step of the recurrence.  Returns (y, new cache);
    ``reduce`` as ``apply``'s."""
    B = x.shape[0]
    p = gathered(p)
    xi, z = (p.tp.copy_to(x) @ p.in_proj).chunk(2, dim=-1)  # (B, 1, di / M)
    window = torch.cat([cache["conv"], xi], dim=1)          # (B, K, di)
    w = p.conv
    xc = sum(window[:, i:i + 1, :] * w[i] for i in range(w.shape[0]))
    xc = F.silu(xc.to(torch.float32)).to(x.dtype)
    u, a, b, c = _ssm_inputs(p, cfg, xc)                    # S = 1
    h = a[:, 0, :, None, None] * cache["ssm"] + torch.einsum(
        "bn,bhp->bhnp", b[:, 0].to(torch.float32), u[:, 0].to(torch.float32))
    y = torch.einsum("bn,bhnp->bhp", c[:, 0].to(torch.float32), h)
    y = y.reshape(B, 1, -1).to(x.dtype)
    return _out(p, cfg, y, z, reduce), {"conv": window[:, 1:], "ssm": h}
