"""AdamW with float32 master weights, global-norm clipping, a
warmup-cosine schedule and int8 gradient compression — the counterpart of
``repro.optim.adamw``, written as the reference writes it.

The state is a plain dict, ``{"master", "mu", "nu"}`` each mapping a
parameter's name to a float32 tensor, and ``"step"`` an int32 scalar, so
the checkpointer can store it like the parameters (``models.convert``
gives it the reference's layout).  A gradient of ``None`` (a parameter
the loss does not reach, the audio family's ``embed``) counts as zeros,
as the reference's zero leaf does: it adds nothing to the norm, and
weight decay still moves its parameter.  ``torch.optim.AdamW`` is not
this update: it skips such parameters, decays before the step and has no
global clip or schedule of this shape.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in float32: linear warmup,
    then cosine down to ``min_lr_frac``."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: dict) -> dict:
    """Optimizer state of ``params`` (name -> tensor): float32 master copy,
    first and second moments, and the step."""
    any_p = next(iter(params.values()))
    return {
        "master": {k: p.detach().to(torch.float32, copy=True)
                   for k, p in params.items()},
        "mu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()},
        "nu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=any_p.device),
    }


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in float32."""
    sq = [torch.sum(g.to(torch.float32) ** 2) for g in grads.values()
          if g is not None]
    return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())


@torch.no_grad()
def apply(cfg: AdamWConfig, grads: dict, state: dict, params: dict):
    """One AdamW step, in place: ``state``'s master, mu and nu and the
    ``params`` (re-cast from the master) are updated, and ``state["step"]``
    is the next step.  Returns (params, state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))
    for k, p in params.items():
        m, v, w = state["mu"][k], state["nu"][k], state["master"][k]
        g = grads.get(k)
        g = (torch.zeros_like(w) if g is None else g.to(torch.float32)) * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mhat, vhat = m / b1c, v / b2c
        w.copy_(w - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * w))
        p.copy_(w)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# -- gradient compression (int8 around the data-parallel all-reduce) ----------

def compress_int8(g: torch.Tensor):
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    gf = g.to(torch.float32)
    scale = (gf.abs().max() + 1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def psum_compressed(grads: dict) -> dict:
    """The int8-compressed gradient all-reduce over a one-member group:
    each gradient quantized with its own per-tensor scale (the group's
    shared scale, when the group is one device), summed (itself) and
    dequantized into its dtype — what the reference computes on a
    one-device mesh.  ``None`` stays ``None`` (zeros quantize to zeros).
    A group of several GPUs waits for ROADMAP queue 1, item 9.6."""
    out = {}
    for k, g in grads.items():
        if g is None:
            out[k] = None
            continue
        q, scale = compress_int8(g)
        out[k] = decompress_int8(q.to(torch.int32), scale).to(g.dtype)
    return out
