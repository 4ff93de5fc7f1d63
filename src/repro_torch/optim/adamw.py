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

On a mesh, the gradient norm is the whole model's: the squares of each
leaf a rank holds a part of (``transformer.sharded_leaves``: tensor
parallelism's dense leaves and the experts over "model", FSDP's over
"data", some over both) are summed over every axis it is split over,
and over no other, before the root (``apply(..., sharded=, mesh=)``), so
each element counts once.
``psum_compressed`` over a process group is the reference's int8
all-reduce of the data axis.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.core import sharding


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


#: elements of a leaf ``apply`` updates at a time (its temporaries: a few
#: float32 chunks, not a few copies of the largest leaf)
UPDATE_CHUNK = 1 << 22


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


def global_norm(grads: dict, sharded=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in float32.
    ``sharded`` maps the name of each leaf a rank holds a part of to the
    axes of ``mesh`` it is split over: its squares are summed over those
    axes first (the leaves of one set of axes together, in the order of
    ``grads``)."""
    sums: dict = {}
    for k, g in grads.items():
        if g is not None:
            axes = tuple((sharded or {}).get(k, ()))
            sums.setdefault(axes, []).append(torch.sum(g.to(torch.float32)
                                                       ** 2))
    sq = [sharding.all_reduce(torch.stack(v).sum(), mesh, axes) if axes
          else torch.stack(v).sum() for axes, v in sums.items()]
    return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())


@torch.no_grad()
def apply(cfg: AdamWConfig, grads: dict, state: dict, params: dict, *,
          sharded=None, mesh=None):
    """One AdamW step, in place: ``state``'s master, mu and nu and the
    ``params`` (re-cast from the master) are updated, and ``state["step"]``
    is the next step.  ``sharded`` / ``mesh``: ``global_norm``'s.
    Returns (params, state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads, sharded, mesh)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))
    for k, p in params.items():
        m, v, w = (state[part][k].view(-1) for part in ("mu", "nu", "master"))
        g = grads.get(k)
        g = None if g is None else g.reshape(-1)
        # the reference's expressions, each rounding in its order, a chunk
        # of the leaf at a time (elementwise, so the same bits; a few
        # temporaries of a chunk, not of the leaf):
        # m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g;
        # w = w - lr (m / b1c / (sqrt(v / b2c) + eps) + wd w)
        for lo in range(0, w.numel(), UPDATE_CHUNK):
            c = slice(lo, lo + UPDATE_CHUNK)
            gc = (torch.zeros_like(w[c]) if g is None
                  else g[c].to(torch.float32)) * scale
            t = gc * (1 - cfg.b1)
            m[c].mul_(cfg.b1).add_(t)
            torch.mul(gc, 1 - cfg.b2, out=t).mul_(gc)
            v[c].mul_(cfg.b2).add_(t)
            torch.div(v[c], b2c, out=t).sqrt_().add_(cfg.eps)
            u = torch.div(m[c], b1c).div_(t)
            u.add_(torch.mul(w[c], cfg.weight_decay, out=t)).mul_(lr)
            w[c].sub_(u)
        p.copy_(state["master"][k])
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


def psum_compressed(grads: dict, group=None) -> dict:
    """int8-compressed gradient all-reduce over ``group`` (the reference's
    over a data axis): agree on a shared scale (all-reduce MAX of the local
    amax, plus 1e-12), quantize, all-reduce SUM in int32, dequantize into
    each gradient's dtype.  4x less on the wire than float32; equals the
    sum up to quantization error.  ``group=None`` or a one-member group is
    the reference's one-device mesh: each gradient quantized with its own
    scale and dequantized.  ``None`` stays ``None`` (zeros quantize to
    zeros; every member has the same ``None`` leaves)."""
    out = {}
    for k, g in grads.items():
        if g is None:
            out[k] = None
            continue
        gf = g.to(torch.float32)
        amax = gf.abs().max()
        if group is not None:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = (amax + 1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        qsum = q.to(torch.int32)
        if group is not None:
            dist.all_reduce(qsum, group=group)
        out[k] = decompress_int8(qsum, scale).to(g.dtype)
    return out
