"""Model-stack primitives — the PyTorch counterpart of
``repro.models.layers``: the config, the parameter count, the pure
functions every block shares (``rms_norm``, ``rope``, ``swiglu``), the
dense SwiGLU FFN module (``MLP``: a block's dense FFN and the MoE layer's
shared experts) and the layout rule of tensor parallelism (``layout``).

Weights are stored as ``(d_in, d_out)`` and applied as ``x @ w``, as in the
reference, so a reference weight carries across as a copy
(``models/convert.py``).  Each function keeps the reference's casts: the
same float32 islands inside a bfloat16 model, and the same cast back.

Tensor parallelism: on a mesh whose "model" axis has M > 1 ranks, a leaf
whose spec names "model" is held as the rank's block of that dimension
(``layout``).  A fused leaf — two halves side by side on its last
dimension, gate | up or x | z — is held as the rank's block of each half,
so that the rank's own gate and up columns meet without communication;
the reference's contiguous block of such a leaf is another placement of
the same bytes.  Each rank draws every leaf as one process draws it, a
slab of rows at a time (``leaf``), and keeps its part.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.sharding import SOLO, Group, P


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
    replication (``transformer.param_specs`` gives them; the "model"
    entries are shards, ``layout``) and ``moe_dispatch_sharded`` changes
    nothing.  ``moe_ep`` runs the experts sharded over a mesh's "model"
    axis (``moe.apply_ep``); a model with it needs a mesh when it is
    built.  ``scan_layers`` picks ``lax.scan`` or an unrolled loop in the
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
    fsdp: bool = False          # its "data" entries realized as replication
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

#: elements of the largest slab of rows ``leaf`` draws at once (1 GiB in
#: float32) unless one row is larger: a leaf larger than that is drawn a
#: slab at a time
DRAW_ELEMS = 1 << 28


def leaf(gen: torch.Generator | None, shape, dtype, device=None, lay=None,
         index: int = 0, in_axis: int = 0) -> torch.Tensor:
    """A weight of the whole ``shape``, Normal(0, 1/fan_in) drawn from
    ``gen`` in float32 (the reference's scheme, not its random bits) in
    slabs of whole rows of its first dimension, as many as DRAW_ELEMS
    elements hold and at least one (Jamba's expert ``wi`` draws a row of
    402 M elements, 1.6 GB, at a time), each slab scaled in place, then
    cast to ``dtype``; the rank of ``index`` keeps its part under the
    ``Layout`` ``lay``; uninitialised, of the part's shape, without
    ``gen``.  A leaf of more than DRAW_ELEMS elements thus holds other
    numbers than one draw of its whole shape would.  Every rank draws
    every slab, so its part equals that part of the one process's weight
    of the same seed, and no rank holds more than a slab of a leaf it does
    not keep."""
    shape = tuple(shape)
    local = lay.local(shape) if lay else shape
    if gen is None:
        return torch.empty(local, dtype=dtype, device=device)
    scale = 1.0 / math.sqrt(shape[in_axis])
    step = max(1, DRAW_ELEMS // max(math.prod(shape[1:]), 1))
    dev = device or gen.device
    out = None
    for a in range(0, shape[0], step):
        b = min(a + step, shape[0])
        w = torch.randn((b - a, *shape[1:]), generator=gen,
                        dtype=torch.float32, device=dev).mul_(scale)
        if lay is None and b - a == shape[0]:
            return w.to(dtype)          # one slab: the whole leaf
        if out is None:
            out = torch.empty(local, dtype=dtype, device=dev)
        if lay is None:
            out[a:b] = w
        elif lay.dim == 0:
            at = 0                      # the part's first row in ``out``
            for s in lay.parts(index):
                lo, hi = max(s.start, a), min(s.stop, b)
                if lo < hi:
                    out[at + lo - s.start:at + hi - s.start] = w[lo - a:hi - a]
                at += s.stop - s.start
        else:
            out[a:b] = lay.take(w, index)
        del w
    return out


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
    then ``* up``.  With a rank's blocks (``layout``: gate block and up
    block side by side, wo's rows), the rank's partial sum."""
    h = x @ wi
    gate, up = h.chunk(2, dim=-1)
    return (F.silu(gate.to(torch.float32)).to(x.dtype) * up) @ wo


def rms_norm_parts(x: torch.Tensor, scale: torch.Tensor, n: int,
                   tp: Group, eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm`` of a dimension of ``n`` split over ``tp``: ``x`` and
    ``scale`` are the rank's block; the sum of squares is summed over the
    ranks both ways, since each rank then normalises its own block."""
    if tp.size == 1:
        return rms_norm(x, scale, eps)
    xf = x.to(torch.float32)
    var = tp.reduce_both((xf * xf).sum(-1, keepdim=True)) / n
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def emb_axis(fsdp: bool):
    """Mesh axis for the embed dim of params: FSDP shards it over 'data'."""
    return "data" if fsdp else None


def mlp_specs(cfg: ModelConfig) -> dict:
    """The dense SwiGLU FFN's specs (the reference's ``mlp_init``)."""
    e = emb_axis(cfg.fsdp)
    return {"wi": P(e, "model"), "wo": P("model", e)}


# ---------------------------------------------------------------------------
# tensor parallelism: the layout rule
# ---------------------------------------------------------------------------

#: the last name of a leaf whose last dimension is two halves side by side
#: (gate | up of a SwiGLU FFN and of the sLSTM's ``up``, x | z of Mamba's
#: ``in_proj``)
FUSED = ("wi", "in_proj", "up")


@dataclasses.dataclass(frozen=True)
class Layout:
    """How the ranks of an axis of ``m`` hold a leaf: dimension ``dim``
    (of whole ``size``) in blocks, rank r's block r — or, ``fused``, rank
    r's block r of each half, side by side."""
    dim: int
    size: int
    m: int
    fused: bool = False

    def parts(self, r: int) -> list[slice]:
        """Rank ``r``'s ranges of the whole dimension, in its order."""
        halves = 2 if self.fused else 1
        h = self.size // halves
        k = h // self.m
        return [slice(j * h + r * k, j * h + (r + 1) * k)
                for j in range(halves)]

    def local(self, shape) -> tuple:
        """The rank's shape of a leaf of the whole ``shape``."""
        out = list(shape)
        out[self.dim] = self.size // self.m
        return tuple(out)

    def take(self, t: torch.Tensor, r: int) -> torch.Tensor:
        """Rank ``r``'s part of the whole ``t`` (a new tensor)."""
        return torch.cat([t.narrow(self.dim, s.start, s.stop - s.start)
                          for s in self.parts(r)], dim=self.dim)

    def assemble(self, blocks) -> torch.Tensor:
        """The whole leaf from every rank's part (``blocks`` in rank
        order): the inverse of ``take``."""
        k = self.size // self.m // (2 if self.fused else 1)
        pieces = {}
        for r, b in enumerate(blocks):
            for j, s in enumerate(self.parts(r)):
                pieces[s.start] = b.narrow(self.dim, j * k, k)
        return torch.cat([pieces[a] for a in sorted(pieces)], dim=self.dim)


def layout(name: str, spec, shape, m: int, moe_ep: bool = False):
    """The ``Layout`` on a "model" axis of ``m`` ranks of the leaf ``name``
    (a dotted parameter name, or its last part) of ``spec`` and whole
    ``shape``, or None where every rank holds it whole: no "model" entry,
    ``m`` of 1, or the experts' leading dimension without ``moe_ep``.
    The fused leaves (``FUSED``, sharded on their last dimension) hold the
    rank's block of each half.  A dimension that does not divide raises."""
    dims = [i for i, p in enumerate(spec)
            if p == "model" or (isinstance(p, tuple) and "model" in p)]
    if not dims or m == 1:
        return None
    dim = dims[0]
    if len(shape) == 3 and dim == 0 and not moe_ep:
        return None                 # the experts: replicated without moe_ep
    fused = dim == len(shape) - 1 and name.rsplit(".", 1)[-1] in FUSED
    if shape[dim] % (2 * m if fused else m):
        raise ValueError(f"{name}: dimension {dim} of {tuple(shape)} does "
                         f"not split over {m} model ranks"
                         + (" in each half" if fused else ""))
    return Layout(dim, shape[dim], m, fused)


def build(module: nn.Module, shapes: dict, specs: dict, dtype, gen, device,
          tp: Group = SOLO, moe_ep: bool = False) -> None:
    """Each weight of ``shapes`` (name -> shape, or (shape, dtype,
    in_axis)), in order: drawn from ``gen`` (``leaf``) or left
    uninitialised, the rank's part under its ``layout`` on ``tp``.  Sets
    ``module.tp``, ``module.layouts`` (name -> ``Layout`` of each leaf
    the rank holds a part of) and ``module.part_index`` (the rank's index
    in those layouts)."""
    module.tp = tp
    module.layouts = {}
    module.part_index = tp.index
    for name, shape in shapes.items():
        shape, dt, in_axis = (shape if isinstance(shape[0], tuple)
                              else (shape, dtype, 0))
        lay = layout(name, specs[name], shape, tp.size, moe_ep)
        setattr(module, name, _param(leaf(gen, shape, dt, device, lay,
                                          tp.index, in_axis)))
        if lay is not None:
            module.layouts[name] = lay


def _param(t: torch.Tensor) -> nn.Parameter:
    """A parameter, frozen: serving takes no gradients, and training
    asks for them (``launch.train.init_state`` and ``fit`` call
    ``model.requires_grad_(True)``)."""
    return nn.Parameter(t, requires_grad=False)


class MLP(nn.Module):
    """The dense SwiGLU FFN: ``wi`` (d, 2f) fused gate|up, ``wo`` (f, d),
    drawn from ``gen`` when it is given and left uninitialised otherwise
    (for a weight carry); on ``tp`` the rank's columns of each half of
    ``wi`` and rows of ``wo``."""

    def __init__(self, cfg: ModelConfig, ff: int, *,
                 gen: torch.Generator | None = None, device=None,
                 tp: Group = SOLO):
        super().__init__()
        d = cfg.d_model
        build(self, {"wi": (d, 2 * ff), "wo": (ff, d)}, mlp_specs(cfg),
              cfg.dtype, gen, device, tp)


def mlp(p: MLP, x: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    """The FFN of ``p`` on the replicated ``x``: column-parallel ``wi``,
    row-parallel ``wo``, the ranks' partial sums added over the model axis
    (``reduce=False``: the rank's partial sum, for the caller to add)."""
    y = swiglu(p.tp.copy_to(x), p.wi, p.wo)
    return p.tp.reduce_from(y) if reduce else y
