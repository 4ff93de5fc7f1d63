"""Mamba mixer (SSD / Mamba-2 form) for the hybrid family — the PyTorch
counterpart of ``repro.models.mamba``.

in_proj (d → 2·di: x | z) → causal depthwise conv on x → per-head decay
a = exp(−Δ·exp(a_log)), Δ = softplus(x·dt_proj + dt_bias) → the SSD scan
(the ``ssd_scan`` kernel with ``use_kernel=True``, the sequential oracle
otherwise) → gate y·silu(z) → RMSNorm → out_proj.  Decode keeps the last
conv_k − 1 inputs and the (H, N, P) float32 state as its cache: O(1) per
token.  Parameters are named as the reference's keys; ``dt_bias`` and
``a_log`` are float32 whatever the model's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops, ref as kref
from repro_torch.core.sharding import P
from .layers import ModelConfig, _param, dense_init, emb_axis, rms_norm


def _dims(cfg: ModelConfig):
    """(di, H, P, N): inner width, SSM heads, head dim, state size."""
    di = cfg.ssm_expand * cfg.d_model
    H = di // cfg.ssm_head_dim
    return di, H, cfg.ssm_head_dim, cfg.ssm_state


class Mamba(nn.Module):
    """One Mamba mixer's weights, drawn from ``gen`` when it is given (the
    reference's scheme) and left uninitialised otherwise."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        d = cfg.d_model
        di, H, _, N = _dims(cfg)
        shapes = {"in_proj": (d, 2 * di), "conv": (cfg.ssm_conv, di),
                  "bc_proj": (di, 2 * N), "dt_proj": (di, H),
                  "out_proj": (di, d)}
        for name, shape in shapes.items():
            w = (dense_init(gen, shape, cfg.dtype, device) if gen is not None
                 else torch.empty(shape, dtype=cfg.dtype, device=device))
            setattr(self, name, _param(w))
        self.dt_bias = _param(torch.zeros(H, dtype=torch.float32, device=device))
        self.a_log = _param(torch.zeros(H, dtype=torch.float32, device=device))
        self.norm = _param(torch.ones(di, dtype=cfg.dtype, device=device))


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
    B, S, di = xc.shape
    _, H, P, N = _dims(cfg)
    b, c = (xc @ p.bc_proj).chunk(2, dim=-1)                # (B, S, N) each
    # softplus as jax.nn.softplus writes it, log(exp(x) + 1)
    dt = torch.logaddexp(xc.to(torch.float32) @ p.dt_proj.to(torch.float32)
                         + p.dt_bias, torch.zeros((), device=xc.device))
    a = torch.exp(-dt * torch.exp(p.a_log))                 # decay in (0, 1)
    xh = xc.reshape(B, S, H, P)
    u = xh * dt[..., None].to(xh.dtype)                     # Δ-scaled input
    return u, a, b, c, xh


def apply(p: Mamba, cfg: ModelConfig, x: torch.Tensor, *,
          use_kernel: bool = False) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    di = _dims(cfg)[0]
    xi, z = (x @ p.in_proj).chunk(2, dim=-1)
    xc = _conv_causal(xi, p.conv)
    u, a, b, c, _ = _ssm_inputs(p, cfg, xc)
    scan = ops.ssd_scan if use_kernel else kref.ssd_scan
    y, _ = scan(u, a, b, c)                                 # (B, S, H, P)
    y = y.reshape(B, S, di)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    return rms_norm(y, p.norm) @ p.out_proj


def init_cache(cfg: ModelConfig, batch: int, dtype=None, device=None) -> dict:
    """``conv``: the last conv_k − 1 inputs (B, K − 1, di) in the model's
    dtype; ``ssm``: the state (B, H, N, P) in float32."""
    dtype = dtype or cfg.dtype
    di, H, P, N = _dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, H, N, P), dtype=torch.float32,
                               device=device)}


def decode(p: Mamba, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """x: (B, 1, d); one step of the recurrence.  Returns (y, new cache)."""
    B = x.shape[0]
    di = _dims(cfg)[0]
    xi, z = (x @ p.in_proj).chunk(2, dim=-1)                # (B, 1, di)
    window = torch.cat([cache["conv"], xi], dim=1)          # (B, K, di)
    w = p.conv
    xc = sum(window[:, i:i + 1, :] * w[i] for i in range(w.shape[0]))
    xc = F.silu(xc.to(torch.float32)).to(x.dtype)
    u, a, b, c, _ = _ssm_inputs(p, cfg, xc)                 # S = 1
    h = a[:, 0, :, None, None] * cache["ssm"] + torch.einsum(
        "bn,bhp->bhnp", b[:, 0].to(torch.float32), u[:, 0].to(torch.float32))
    y = torch.einsum("bn,bhnp->bhp", c[:, 0].to(torch.float32), h)
    y = y.reshape(B, 1, di).to(x.dtype)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    return rms_norm(y, p.norm) @ p.out_proj, {"conv": window[:, 1:], "ssm": h}
