"""Model-stack primitives — the PyTorch counterpart of
``repro.models.layers``: the config, the parameter count, the pure
functions every block shares (``rms_norm``, ``rope``, ``swiglu``) and the
dense SwiGLU FFN module (``MLP``: a block's dense FFN and the MoE layer's
shared experts).

Weights are stored as ``(d_in, d_out)`` and applied as ``x @ w``, as in the
reference, so a reference weight carries across as a copy
(``models/convert.py``).  Each function keeps the reference's casts: the
same float32 islands inside a bfloat16 model, and the same cast back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.sharding import P


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Every field of the reference's config, with ``dtype`` a torch dtype.

    ``remat`` recomputes each repeat of the layer group in the backward
    pass (``transformer.trunk``): ``remat_policy="full"`` saves only the
    group's input, any other policy also the plain matmuls' outputs (the
    reference's ``dots_with_no_batch_dims_saveable``).  ``fsdp`` and
    ``moe_dispatch_sharded`` shard parameters and activations across the
    reference's mesh; the port realizes ``fsdp``'s "data" entries as
    replication (``transformer.param_specs`` gives them) and
    ``moe_dispatch_sharded`` changes nothing.  ``moe_ep`` runs the experts
    sharded over a mesh's "model" axis (``moe.apply_ep``); a model with it
    needs a mesh when it is built.  ``scan_layers`` picks ``lax.scan`` or an unrolled loop in the
    reference; the port always runs its layers in a Python loop, which
    gives the same numbers either way."""
    name: str = "model"
    family: str = "dense"       # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 256
    vocab: int = 256
    head_dim: int = 0           # 0 ⇒ d_model // n_heads
    window: int | None = None   # sliding-window attention
    qkv_bias: bool = False
    parallel_block: bool = False    # stablelm: attn ∥ ffn
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_every: int = 1          # MoE layer every k-th layer
    moe_first_dense: bool = False
    moe_capacity_factor: float = 1.25
    dense_ff: int = 0           # d_ff of the non-MoE layers (jamba) / dense l0
    # hybrid (jamba)
    attn_every: int = 0         # 1 attention layer per this many (0 = all)
    # ssm
    ssm_state: int = 16
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # xlstm
    slstm_every: int = 0        # sLSTM block every k-th layer (0 = none)
    # vlm / audio frontends (stubs provide these token streams)
    cross_attn_every: int = 0   # cross-attn layer every k-th layer
    n_frontend_tokens: int = 0  # precomputed patch/frame embeddings
    # numerics / distribution
    dtype: Any = torch.bfloat16
    fsdp: bool = False          # realized as replication
    remat: bool = True          # recompute each layer group in backward
    remat_policy: str = "full"  # "full" | anything else: save the matmuls
    fast_decode: bool = False   # grouped-GQA decode attention
    moe_dispatch_sharded: bool = False  # ignored
    mlstm_chunk: int = 0        # chunked mLSTM prefill (0 = full parallel)
    moe_ep: bool = False        # expert parallelism over a mesh
    scan_layers: bool = True    # the port always loops; same numbers
    rope_theta: float = 1e4

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def active_params(self) -> float:
        """Active (per-token) parameter count — for 6·N·D roofline math."""
        return _param_count(self, active_only=True)

    def total_params(self) -> float:
        return _param_count(self, active_only=False)


def _param_count(cfg: ModelConfig, active_only: bool) -> float:
    d, hd = cfg.d_model, cfg.hd
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
    total = 2.0 * cfg.vocab * d          # embed + head
    for li in range(cfg.n_layers):
        is_attn = cfg.attn_every == 0 or li % cfg.attn_every == 0
        if cfg.family == "ssm":
            di = cfg.ssm_expand * d
            total += 2 * d * di + di * d + di * cfg.ssm_conv \
                + 2 * di * cfg.ssm_state
            continue
        if is_attn:
            total += attn
        else:                           # mamba layer (hybrid)
            di = cfg.ssm_expand * d
            total += 2 * d * di + di * d + di * cfg.ssm_conv \
                + 2 * di * cfg.ssm_state
        is_moe = (cfg.moe_experts > 0 and li % cfg.moe_every == 0
                  and not (cfg.moe_first_dense and li == 0))
        if is_moe:
            e = cfg.moe_top_k if active_only else cfg.moe_experts
            total += (e + cfg.moe_shared_experts) * 3 * d * cfg.d_ff \
                + d * cfg.moe_experts
        else:
            ff = cfg.dense_ff or cfg.d_ff
            if ff:
                total += 3 * d * ff
    return total


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, device=None,
               in_axis: int = 0) -> torch.Tensor:
    """Normal(0, 1/fan_in) in float32 on ``gen``'s device, cast to
    ``dtype``; the reference's scheme, not its random bits.  The draw is
    scaled in place, so a float32 weight needs one buffer of its size and
    no temporary (Jamba's expert ``wi`` is 25.8 GB in float32)."""
    scale = 1.0 / math.sqrt(shape[in_axis])
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device or gen.device).mul_(scale)
    return w.to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast back to x's dtype, then ``* scale``."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, D) with D even; positions: broadcastable to (..., S).
    Angles in float32; ``x * cos`` promotes to float32; cast back at the
    end."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """wi: (d, 2f) fused gate|up; wo: (f, d).  silu in float32, cast back,
    then ``* up``."""
    h = x @ wi
    gate, up = h.chunk(2, dim=-1)
    return (F.silu(gate.to(torch.float32)).to(x.dtype) * up) @ wo


def mlp_init(gen: torch.Generator, d: int, f: int, dtype,
             device=None) -> dict[str, torch.Tensor]:
    """The dense SwiGLU FFN's weights: ``wi`` (d, 2f), ``wo`` (f, d)."""
    return {"wi": dense_init(gen, (d, 2 * f), dtype, device),
            "wo": dense_init(gen, (f, d), dtype, device)}


def emb_axis(fsdp: bool):
    """Mesh axis for the embed dim of params: FSDP shards it over 'data'."""
    return "data" if fsdp else None


def mlp_specs(cfg: ModelConfig) -> dict:
    """The dense SwiGLU FFN's specs (the reference's ``mlp_init``)."""
    e = emb_axis(cfg.fsdp)
    return {"wi": P(e, "model"), "wo": P("model", e)}


def _param(t: torch.Tensor) -> nn.Parameter:
    """A parameter, frozen: serving takes no gradients, and training
    asks for them (``launch.train.init_state`` and ``fit`` call
    ``model.requires_grad_(True)``)."""
    return nn.Parameter(t, requires_grad=False)


class MLP(nn.Module):
    """The dense SwiGLU FFN: ``wi`` (d, 2f) fused gate|up, ``wo`` (f, d),
    drawn from ``gen`` when it is given and left uninitialised otherwise
    (for a weight carry)."""

    def __init__(self, cfg: ModelConfig, ff: int, *,
                 gen: torch.Generator | None = None, device=None):
        super().__init__()
        d = cfg.d_model
        w = (mlp_init(gen, d, ff, cfg.dtype, device) if gen is not None else
             {"wi": torch.empty((d, 2 * ff), dtype=cfg.dtype, device=device),
              "wo": torch.empty((ff, d), dtype=cfg.dtype, device=device)})
        self.wi, self.wo = _param(w["wi"]), _param(w["wo"])
