"""Model-stack primitives — the PyTorch counterpart of
``repro.models.layers``: the config, the parameter count, the pure
functions every block shares (``rms_norm``, ``rope``, ``swiglu``), the
dense SwiGLU FFN module (``MLP``: a block's dense FFN and the MoE layer's
shared experts) and the placement rule of a mesh (``layout``).

Weights are stored as ``(d_in, d_out)`` and applied as ``x @ w``, as in the
reference, so a reference weight carries across as a copy
(``models/convert.py``).  Each function keeps the reference's casts: the
same float32 islands inside a bfloat16 model, and the same cast back.

Placement: on a mesh, a leaf whose spec names "model" is held, over a
"model" axis of M > 1 ranks, as the rank's block of that dimension
(tensor parallelism, and the experts' leading dimension); a fused leaf —
two halves side by side on its last dimension, gate | up or x | z — as
the rank's block of each half, so that the rank's own gate and up columns
meet without communication (the reference's contiguous block of such a
leaf is another placement of the same bytes).  A leaf whose spec names
"data" (``fsdp=True``) is held, over a "data" axis of D > 1 ranks, as
the rank's one contiguous block of that dimension, the reference's, and
gathered over "data" just before a layer uses it (``gathered``, ZeRO-3;
its gradient is reduce-scattered, ``sharding.fsdp_gather``).  A leaf
with both entries is a block on each of two dimensions (``Layout``).
The fused (heads · hd) columns of the attention, the mLSTM and Mamba
are split so too, wherever a head falls: a rank computes every head its
block touches (``head_split``), gathering what it does not hold whole
over "model" (``gather_blocks``), or only its own columns of each where
a column needs nothing from the others (``padded_layout``).  Each rank
draws every leaf as one process draws it, a slab of rows at a time
(``leaf``), and keeps its part.
The reference's ``tp1`` rewrite of the specs (``strip_model``) leaves no
"model" entry: a model placed by it is built on a "model" group of one
rank (``sharding.SOLO``), so ``layout`` splits nothing over "model".
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.sharding import SOLO, Group, P, counted_as


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Every field of the reference's config, with ``dtype`` a torch dtype.

    ``remat`` recomputes each repeat of the layer group in the backward
    pass (``transformer.trunk``): ``remat_policy="full"`` saves only the
    group's input, any other policy also the plain matmuls' outputs (the
    reference's ``dots_with_no_batch_dims_saveable``).  ``fsdp`` puts
    "data" on the embedding dimension of the parameters' specs
    (``transformer.param_specs``): on a mesh each such leaf is the rank's
    block, gathered over "data" where a layer uses it (``layout``,
    ``gathered``).  ``moe_dispatch_sharded`` only adds sharding
    constraints in the reference and changes nothing here.  ``moe_ep``
    picks ``moe.apply_ep``'s per-shard function for the MoE layers (the
    experts are split over a "model" axis with or without it); a model
    with it needs a mesh with a "model" axis when it is built.  ``scan_layers`` picks ``lax.scan`` or an unrolled loop in the
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
    fsdp: bool = False          # shard the params' embed dim over "data"
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
         index=None, in_axis: int = 0) -> torch.Tensor:
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
    # the rank's rows of the first dimension, and the splits of the others
    first = next((s for s in lay.splits if s.dim == 0), None) if lay else None
    rows = first.parts(index[first.axis]) if first else [slice(0, shape[0])]
    rest = Layout(tuple(s for s in lay.splits if s.dim)) if lay else None
    out = None
    for a in range(0, shape[0], step):
        b = min(a + step, shape[0])
        w = torch.randn((b - a, *shape[1:]), generator=gen,
                        dtype=torch.float32, device=dev).mul_(scale)
        if lay is None and b - a == shape[0]:
            return w.to(dtype)          # one slab: the whole leaf
        if out is None:
            out = torch.empty(local, dtype=dtype, device=dev)
        at = 0                          # the range's first row in ``out``
        for s in rows:
            lo, hi = max(s.start, a), min(s.stop, b)
            if lo < hi:
                piece = w[lo - a:hi - a]
                out[at + lo - s.start:at + hi - s.start] = (
                    rest.take(piece, index) if rest else piece)
            at += s.stop - s.start
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


def strip_model(spec: P) -> P:
    """The reference's ``tp1`` rewrite of one spec (its dry-run's
    ``_strip_model_axis``, ``repro/launch/dryrun.py:60-66``): every entry
    equal to "model" becomes None; a tuple entry is kept as it is."""
    return P(*(None if e == "model" else e for e in spec))


def mlp_specs(cfg: ModelConfig) -> dict:
    """The dense SwiGLU FFN's specs (the reference's ``mlp_init``)."""
    e = emb_axis(cfg.fsdp)
    return {"wi": P(e, "model"), "wo": P("model", e)}


# ---------------------------------------------------------------------------
# placement on a mesh: the layout rule
# ---------------------------------------------------------------------------

#: the last name of a leaf whose last dimension is two halves side by side
#: (gate | up of a SwiGLU FFN and of the sLSTM's ``up``, x | z of Mamba's
#: ``in_proj``)
FUSED = ("wi", "in_proj", "up")


@dataclasses.dataclass(frozen=True)
class Split:
    """How the ``n`` ranks of the mesh axis ``axis`` hold dimension
    ``dim`` (of whole ``size``) of a leaf: rank r's block r — or,
    ``fused``, rank r's block r of each half, side by side."""
    axis: str
    dim: int
    size: int
    n: int
    fused: bool = False

    def parts(self, r: int) -> list[slice]:
        """Rank ``r``'s ranges of the whole dimension, in its order."""
        halves = 2 if self.fused else 1
        h = self.size // halves
        k = h // self.n
        return [slice(j * h + r * k, j * h + (r + 1) * k)
                for j in range(halves)]

    def take(self, t: torch.Tensor, r: int) -> torch.Tensor:
        """Rank ``r``'s part of ``t``, whole on ``dim`` (a new tensor)."""
        return torch.cat([t.narrow(self.dim, s.start, s.stop - s.start)
                          for s in self.parts(r)], dim=self.dim)

    def assemble(self, blocks) -> torch.Tensor:
        """``dim`` whole from every rank's part (``blocks`` in rank
        order): the inverse of ``take``."""
        k = self.size // self.n // (2 if self.fused else 1)
        pieces = {}
        for r, b in enumerate(blocks):
            for j, s in enumerate(self.parts(r)):
                pieces[s.start] = b.narrow(self.dim, j * k, k)
        return torch.cat([pieces[a] for a in sorted(pieces)], dim=self.dim)


@dataclasses.dataclass(frozen=True)
class Layout:
    """How the ranks of a mesh hold a leaf: one ``Split`` for each axis
    that shards it ("data" first, then "model"), each on its own
    dimension.  A rank's ``index`` is ``{axis: its index along it}``: its
    part is its block of each split's dimension."""
    splits: tuple[Split, ...]

    @property
    def axes(self) -> tuple[str, ...]:
        return tuple(s.axis for s in self.splits)

    def split(self, axis: str) -> Split | None:
        return next((s for s in self.splits if s.axis == axis), None)

    def local(self, shape) -> tuple:
        """The rank's shape of a leaf of the whole ``shape``."""
        out = list(shape)
        for s in self.splits:
            out[s.dim] = s.size // s.n
        return tuple(out)

    def take(self, t: torch.Tensor, index) -> torch.Tensor:
        """The part of the rank of ``index`` of the whole ``t`` (a new
        tensor)."""
        for s in self.splits:
            t = s.take(t, index[s.axis])
        return t


def layout(name: str, spec, shape, m: int, d: int = 1) -> Layout | None:
    """The ``Layout`` of the leaf ``name`` (a dotted parameter name, or
    its last part) of ``spec`` and whole ``shape`` on a mesh of ``d``
    "data" and ``m`` "model" ranks, or None where every rank holds it
    whole (no entry of an axis larger than 1).  "model": the rank's
    block, of each half for the fused leaves (``FUSED``, sharded on their
    last dimension); "data": one contiguous block.  A dimension that does
    not divide raises a ``ValueError`` naming the leaf and the axis."""
    splits = []
    for axis, n in (("data", d), ("model", m)):
        dims = [i for i, p in enumerate(spec)
                if p == axis or (isinstance(p, tuple) and axis in p)]
        if not dims or n == 1:
            continue
        dim = dims[0]
        fused = (axis == "model" and dim == len(shape) - 1
                 and name.rsplit(".", 1)[-1] in FUSED)
        if shape[dim] % (2 * n if fused else n):
            raise ValueError(f"{name}: dimension {dim} of {tuple(shape)} does "
                             f"not split over {n} {axis} ranks"
                             + (" in each half" if fused else ""))
        splits.append(Split(axis, dim, shape[dim], n, fused))
    return Layout(tuple(splits)) if splits else None


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """Rank r's part of a fused (heads · hd) axis that the contiguous
    ``Split`` over M "model" ranks cuts into blocks, wherever a head
    falls: ``cols``, its block of columns; ``heads``, every head those
    columns touch, ``range(cols.start // hd, (cols.stop - 1) // hd + 1)``;
    ``own``, its columns within the touched heads' flattened columns;
    ``whole``, the columns are those heads' whole (nothing to gather)."""
    cols: slice
    heads: slice
    hd: int

    @property
    def n(self) -> int:
        """The number of touched heads."""
        return self.heads.stop - self.heads.start

    @property
    def own(self) -> slice:
        a = self.heads.start * self.hd
        return slice(self.cols.start - a, self.cols.stop - a)

    @property
    def whole(self) -> bool:
        return self.own == slice(0, self.n * self.hd)

    def widths(self) -> list[int]:
        """The rank's columns in each touched head, in order."""
        return [min(self.cols.stop, (h + 1) * self.hd)
                - max(self.cols.start, h * self.hd)
                for h in range(self.heads.start, self.heads.stop)]


def head_split(n_heads: int, hd: int, m: int, r: int) -> HeadSplit:
    """The ``HeadSplit`` of rank ``r`` of ``m`` over ``n_heads`` heads of
    ``hd`` (``layout`` raises first where the columns do not divide)."""
    n = n_heads * hd
    cols = slice(r * n // m, (r + 1) * n // m)
    return HeadSplit(cols, slice(cols.start // hd, (cols.stop - 1) // hd + 1),
                     hd)


def padded_layout(sp: HeadSplit):
    """(w, index, out): the rank's own columns of a fused (heads · hd)
    axis laid out as w columns in each of its touched heads, (..., heads,
    w), where a head's columns need nothing from the others' (the mLSTM's
    v, Mamba's scan input).  Where its columns are as many in each head
    (whole heads, or all in one) that is a reshape, and ``index`` /
    ``out`` are None; otherwise ``index`` (heads, w) picks each head's
    columns of the rank's block, the rest a zero column (index ``cols``),
    and ``out`` (cols,) picks the rank's columns back out of the (heads ·
    w) flattened output (``pad_heads``, ``own_columns``)."""
    widths = sp.widths()
    w = max(widths)
    if len(set(widths)) == 1:
        return w, None, None
    c = sp.cols.stop - sp.cols.start
    index = torch.full((sp.n, w), c, dtype=torch.long)
    out, at = [], 0
    for j, n in enumerate(widths):
        index[j, :n] = torch.arange(at, at + n)
        out.extend(range(j * w, j * w + n))
        at += n
    return w, index, torch.tensor(out, dtype=torch.long)


def pad_heads(t: torch.Tensor, lay) -> torch.Tensor:
    """The rank's columns ``t`` (..., cols) as (..., heads, w) under the
    ``padded_layout`` ``lay``: zero columns where they lie unevenly."""
    w, index, _ = lay
    if index is None:
        return t.unflatten(-1, (-1, w))
    t = torch.cat([t, t.new_zeros(*t.shape[:-1], 1)], dim=-1)
    return t[..., index.to(t.device)]


def own_columns(y: torch.Tensor, lay) -> torch.Tensor:
    """``pad_heads``' inverse on the flattened output: (..., heads · w)
    -> the rank's columns (..., cols), the zero columns dropped."""
    out = lay[2]
    return y if out is None else y[..., out.to(y.device)]


def gather_blocks(tp: Group, ts: list) -> list:
    """Each rank's column blocks ``ts`` (tensors of the same leading
    dimensions) whole over ``tp``, in one gather of their concatenation;
    every rank uses the wholes in its own way, so the gradients of the
    wholes are summed over the ranks (``copy_to``) before each rank takes
    its block's.  Counted in ``sharding.STATS``' ``heads_`` keys."""
    widths = [t.shape[-1] for t in ts]
    w = tp.copy_to(counted_as("heads_", lambda: tp.gather(
        torch.cat(ts, dim=-1), dim=-1)))
    w = w.unflatten(-1, (tp.size, sum(widths)))
    return [part.flatten(-2) for part in w.split(widths, dim=-1)]


def build(module: nn.Module, shapes: dict, specs: dict, dtype, gen, device,
          tp: Group = SOLO, fs: Group = SOLO) -> None:
    """Each weight of ``shapes`` (name -> shape, or (shape, dtype,
    in_axis)), in order: drawn from ``gen`` (``leaf``) or left
    uninitialised, the rank's part under its ``layout`` on ``tp`` (the
    "model" axis) and ``fs`` (the "data" axis).  Sets ``module.tp``,
    ``module.fs``, ``module.layouts`` (name -> ``Layout`` of each leaf the
    rank holds a part of), ``module.part_index`` (the rank's index in
    those layouts) and ``module.fsdp_dims`` (name -> the dimension
    ``gathered`` gathers over "data")."""
    module.tp, module.fs = tp, fs
    module.layouts = {}
    module.part_index = {"data": fs.index, "model": tp.index}
    module.fsdp_dims = {}
    for name, shape in shapes.items():
        shape, dt, in_axis = (shape if isinstance(shape[0], tuple)
                              else (shape, dtype, 0))
        lay = layout(name, specs[name], shape, tp.size, fs.size)
        setattr(module, name, _param(leaf(gen, shape, dt, device, lay,
                                          module.part_index, in_axis)))
        if lay is not None:
            module.layouts[name] = lay
            if lay.split("data"):
                module.fsdp_dims[name] = lay.split("data").dim


class _Gathered:
    """A module as a layer uses it: each leaf that FSDP splits over
    "data" gathered whole (``Group.fsdp_gather``) at its first use and
    held by this view alone, so it goes with the view at the end of the
    layer's call (under grad, autograd keeps what the backward needs);
    every other attribute is the module's own."""

    def __init__(self, module: nn.Module):
        self._module = module

    def __getattr__(self, name: str):
        module = self.__dict__["_module"]
        value = getattr(module, name)
        dim = module.fsdp_dims.get(name)
        if dim is not None:
            value = module.fs.fsdp_gather(value, dim)
            setattr(self, name, value)
        return value


def gathered(module: nn.Module):
    """``module`` with its FSDP leaves gathered over "data" on use (a
    ``_Gathered`` view), or the module itself where it has none (or the
    view itself)."""
    if isinstance(module, _Gathered) or not getattr(module, "fsdp_dims", None):
        return module
    return _Gathered(module)


def _param(t: torch.Tensor) -> nn.Parameter:
    """A parameter, frozen: serving takes no gradients, and training
    asks for them (``launch.train.init_state`` and ``fit`` call
    ``model.requires_grad_(True)``)."""
    return nn.Parameter(t, requires_grad=False)


class MLP(nn.Module):
    """The dense SwiGLU FFN: ``wi`` (d, 2f) fused gate|up, ``wo`` (f, d),
    drawn from ``gen`` when it is given and left uninitialised otherwise
    (for a weight carry); on ``tp`` the rank's columns of each half of
    ``wi`` and rows of ``wo``, on ``fs`` (FSDP) its block of the d
    rows of ``wi`` and columns of ``wo``."""

    def __init__(self, cfg: ModelConfig, ff: int, *,
                 gen: torch.Generator | None = None, device=None,
                 tp: Group = SOLO, fs: Group = SOLO):
        super().__init__()
        d = cfg.d_model
        build(self, {"wi": (d, 2 * ff), "wo": (ff, d)}, mlp_specs(cfg),
              cfg.dtype, gen, device, tp, fs)


def mlp(p: MLP, x: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    """The FFN of ``p`` on the replicated ``x``: column-parallel ``wi``,
    row-parallel ``wo``, the ranks' partial sums added over the model axis
    (``reduce=False``: the rank's partial sum, for the caller to add);
    its FSDP leaves gathered over "data" first."""
    p = gathered(p)
    y = swiglu(p.tp.copy_to(x), p.wi, p.wo)
    return p.tp.reduce_from(y) if reduce else y
