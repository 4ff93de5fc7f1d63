"""Mixture-of-Experts FFN — the PyTorch counterpart of ``repro.models.moe``:
top-k routing, sort-based capacity dispatch, shared experts (the DeepSeek /
Kimi style), the Switch load-balancing loss, and expert parallelism.

Each token's K (token, expert) pairs are ranked within their expert by a
stable sort, bucketed into an (E, C, d) capacity layout (pairs past the
capacity drop, GShard's rule), multiplied by the experts' weights (an
einsum, or the ``moe_gmm`` kernel with ``use_kernel=True``) and combined
with the router weights.  Parameters are named as the reference's keys
(``router``, ``wi``, ``wo``, ``shared.wi``, ``shared.wo``), so a weight
carry matches them by name.

On a mesh (``core.sharding``), the tokens ``x`` are this rank's rows of a
batch split over the data axes, replicated over "model", and the experts
are split over a "model" axis of M > 1 ranks whatever ``moe_ep`` says
(the reference's ``P("model", e, None)``, which ``jax.jit`` places so):
the module holds the experts [j·E/M, (j+1)·E/M) of model rank j
(``MoE.experts``).  Each rank computes its experts' (token, expert) pairs of
the replicated routing, so no token crosses the wire, and the combine is
one all-reduce over "model".  ``moe_ep`` only picks the per-shard
function:

- ``apply_ep`` is the reference's expert parallelism (``moe_ep``): the
  capacity, the ranks in an expert and the aux loss are each data shard's
  own, the aux then averaged over the data axes, as the reference's
  ``shard_map`` computes them.  The experts run as ``torch.bmm`` whatever
  ``use_kernel`` says, as the reference's einsums do
  (``moe.py:175-179``).
- ``apply(mesh=...)`` is ``apply``'s function of the whole batch (the
  reference's ``apply`` under ``jit`` sees the global batch, and its decode
  routes the global decode batch): the capacity from the global token
  count, each pair ranked after the pairs of the lower data ranks, the aux
  over the whole batch; the rank's experts through ``moe_gmm`` with
  ``use_kernel=True``.

Under FSDP (``fsdp=True`` on a "data" axis of D > 1 ranks) the router
and the rank's experts hold the rank's block of their d dimension and
are gathered over "data" just before use, in ``apply`` and ``apply_ep``
alike (the reference's ``apply_ep`` gathers them by hand,
``moe.py:151-154``): the experts a block of them at a time, as many as
EXPERT_GATHER_BYTES hold gathered, each block multiplied and freed before
the next (each expert needs only its own weights, so the function is the
same).

Under the reference's ``tp1`` specs (a model built with ``tp1=True``)
every rank holds the experts whole and computes them all; under
``moe_ep`` each rank then takes its block of them (``Group.part``, whose
backward sums the ranks' gradients over "model"), as the reference's
``shard_map`` slices its replicated experts, and the combine is the
all-reduce again.

Under tensor parallelism the shared experts hold the dense FFN's layout
(``layers.MLP``): their partial sums join the experts' combine in one
all-reduce.

The gradients follow the function: the combine sums forward and passes
the gradient through, the router's probabilities and the tokens enter
each rank's pairs replicated and their gradients are summed over "model"
(``sharding.reduce_from`` / ``copy_to``); the aux is computed from the
whole probabilities on every rank and its gradient counts once; a
gathered leaf's gradient is reduce-scattered over "data".
``moe_dispatch_sharded`` only adds sharding constraints in the reference
and changes nothing here.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import sharding
from repro_torch.core.sharding import SOLO, Group, P
from repro_torch.kernels import ops
from .layers import MLP, ModelConfig, build, emb_axis, gathered, mlp, swiglu

#: bytes of gathered expert weights (``wi`` and ``wo``) a rank holds at
#: once under FSDP: the experts are gathered and multiplied a block at a
#: time (one expert at least)
EXPERT_GATHER_BYTES = 2 << 30


def expert_ranks(cfg: ModelConfig, mesh, model_axis: str = "model",
                 tp1: bool = False) -> int:
    """The ranks of ``model_axis`` of ``mesh`` (a DeviceMesh or ``{axis:
    size}``) the experts split over, 1 where there is no such axis, or
    under ``tp1`` (the specs without "model") unless ``moe_ep``: the
    reference's ``apply_ep`` keeps its ``shard_map``'s in_specs on
    ``model_axis`` and so slices the whole experts there.  ``moe_ep``
    without a mesh that has ``model_axis`` raises, and so do experts that
    do not divide over it."""
    E = cfg.moe_experts
    has = mesh is not None and model_axis in sharding.mesh_shape(mesh)
    if cfg.moe_ep and not has:
        raise ValueError(f"{cfg.name}: moe_ep=True (expert parallelism) needs"
                         f" a mesh with a {model_axis!r} axis to shard the "
                         f"{E} experts over")
    m = sharding.axis_size(mesh, model_axis) if has and (
        cfg.moe_ep or not tp1) else 1
    if E % m:
        raise ValueError(f"{cfg.name}: the {E} experts do not split over {m} "
                         f"{model_axis!r} ranks")
    return m


class MoE(nn.Module):
    """``router`` (d, E) float32 whatever the model's dtype, ``wi``
    (E, d, 2f) fused gate|up, ``wo`` (E, f, d) and, with shared experts,
    ``shared``, one SwiGLU ``MLP`` of width f · n_shared.  Drawn from
    ``gen`` when it is given (the reference's scheme: fan-in of d for
    ``wi``, of f for ``wo``), uninitialised otherwise (for a weight
    carry).  On ``mesh``, ``wi`` and ``wo`` hold the rank's experts only
    (``self.experts``, its block over ``ep``) and, under FSDP, the rank's
    block of their d dimension, as the router does: each leaf is drawn as one
    process draws it (``layers.leaf``) and the rank keeps its part, equal
    to that part of the one-process model of the same seed.  On ``tp``
    the shared experts hold the rank's part.  ``ep``: the group the
    experts are split over (default the mesh's "model" axis; in a model,
    its "model" group, which is one rank under ``tp1``: the experts
    whole)."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator | None = None,
                 device=None, mesh=None, tp: Group = SOLO,
                 ep: Group | None = None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
        ep = sharding.group(mesh, "model") if ep is None else ep
        self.experts = ep.block(E)
        fs = sharding.group(mesh, "data")
        shapes = {"router": ((d, E), torch.float32, 0),
                  "wi": ((E, d, 2 * f), cfg.dtype, 1),
                  "wo": ((E, f, d), cfg.dtype, 1)}
        # the experts' group, then the layer's tensor-parallel one
        build(self, shapes, specs(cfg), cfg.dtype, gen, device, ep, fs)
        self.tp = tp
        if cfg.moe_shared_experts:
            self.shared = MLP(cfg, f * cfg.moe_shared_experts, gen=gen,
                              device=device, tp=tp, fs=fs)


def specs(cfg: ModelConfig) -> dict:
    """The reference's specs of the layer's weights (its ``init``)."""
    e = emb_axis(cfg.fsdp)
    out = {"router": P(e, None),
           "wi": P("model", e, None), "wo": P("model", None, e)}
    if cfg.moe_shared_experts:
        out["shared"] = {"wi": P(e, "model"), "wo": P("model", e)}
    return out


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
    probs = torch.softmax(xt.to(torch.float32) @ p.router, dim=-1)
    return (probs,) + _top_k(probs, cfg, xt.dtype)


def _top_k(probs: torch.Tensor, cfg: ModelConfig, dtype):
    gate, topk = probs.topk(cfg.moe_top_k, dim=-1)
    gate = (gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)).to(dtype)
    return gate, topk


def _rank_in_expert(ef: torch.Tensor, E: int):
    """Each pair's rank within its expert (a stable sort keeps token
    order) and each expert's count of pairs."""
    order = torch.argsort(ef, stable=True)
    # bincount's int64 counts; a scatter-add has a meta kernel (the
    # dry-run's) and is deterministic on CUDA for integers
    counts = torch.zeros(E, dtype=torch.int64, device=ef.device).scatter_add_(
        0, ef.long(), torch.ones_like(ef, dtype=torch.int64))  # (E,)
    starts = counts.cumsum(0) - counts
    rank = torch.empty_like(ef)
    rank[order] = torch.arange(ef.numel(), device=ef.device) - starts[ef[order]]
    return rank, counts


def _expert_blocks(p: MoE, wi, wo) -> list[tuple[int, int]]:
    """The ranges of the rank's experts ``wi`` / ``wo`` multiplied at
    once: all of them, or under FSDP as many as EXPERT_GATHER_BYTES hold
    gathered (at least one)."""
    n = wi.shape[0]
    if "wi" not in p.fsdp_dims:
        return [(0, n)]
    whole = (wi[0].numel() + wo[0].numel()) * wi.element_size() * p.fs.size
    k = max(1, min(n, EXPERT_GATHER_BYTES // whole))
    return [(a, min(a + k, n)) for a in range(0, n, k)]


def _expert_weights(p: MoE, wi, wo, a: int, b: int):
    """``wi`` and ``wo`` of the rank's experts [a, b), gathered over
    "data" under FSDP."""
    if "wi" not in p.fsdp_dims:
        return wi, wo
    return (p.fs.fsdp_gather(wi[a:b], p.fsdp_dims["wi"]),
            p.fs.fsdp_gather(wo[a:b], p.fsdp_dims["wo"]))


def _experts(p: MoE, xt, ef, rank, kept, gate, C: int, cnt, use_kernel: bool,
             lo: int, wi, wo):
    """The (T, d) sum over each token's kept pairs with the rank's experts
    ``wi`` / ``wo`` (the experts [lo, lo + n)) of gate × expert output.  A
    pair's slot is ``(e - lo) * C + rank``; dropped pairs and other
    ranks' pairs go to the spare row, cut off."""
    T, d = xt.shape
    n = wi.shape[0]
    K = ef.numel() // T
    mine = kept & (ef >= lo) & (ef < lo + n)
    slot = torch.where(mine, (ef - lo) * C + rank, n * C)
    tok = torch.arange(T, device=xt.device).repeat_interleave(K)
    buf = torch.zeros((n * C + 1, d), dtype=xt.dtype, device=xt.device)
    buf[slot] = xt[tok]
    xg = buf[:n * C].view(n, C, d)

    # the experts, a block at a time: (k, C, ·) @ (k, ·, ·), the kernel
    # masking rows past each expert's count (zero rows here, as the
    # buffer left them)
    if use_kernel:
        cnt = cnt.to(torch.int32)
        experts = ops.moe_gmm
    else:
        experts = lambda a, w, c: torch.bmm(a, w)       # noqa: E731
    ys = []
    for a, b in _expert_blocks(p, wi, wo):
        wia, woa = _expert_weights(p, wi, wo, a, b)
        g, u = experts(xg[a:b], wia, cnt[a:b]).chunk(2, dim=-1)
        h = torch.nn.functional.silu(g.to(torch.float32)).to(xt.dtype) * u
        ys.append(experts(h, woa, cnt[a:b]))
        del wia, woa
    yg = ys[0] if len(ys) == 1 else torch.cat(ys)

    # combine: each pair's expert output, weighted; a token's K pairs are
    # adjacent (tok = repeat(arange(T), K)), so the segment sum is a sum
    # over K
    flat = yg.reshape(n * C, d)
    pair_out = torch.where(mine[:, None], flat[slot.clamp(max=n * C - 1)], 0)
    return (pair_out * gate.reshape(-1)[:, None]).view(T, K, d).sum(1)


def apply(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
          use_kernel: bool = False, mesh=None, model_axis: str = "model",
          batch_axes=None):
    """x: (B, S, d) -> ((B, S, d), aux), aux the float32 load-balancing
    loss.  With ``mesh``, ``x`` is this data rank's rows and the result is
    that of the whole batch (module docstring); ``batch_axes``: the axes
    that split the batch, default the mesh's axes but ``model_axis`` (the
    reference's ``dp_all`` adds ``model_axis``, over which a ``tp1`` model
    holds the experts whole)."""
    return _moe(p, cfg, x, use_kernel, mesh, model_axis, per_shard=False,
                batch_axes=batch_axes)


def apply_ep(p: MoE, cfg: ModelConfig, x: torch.Tensor, *, mesh,
             model_axis: str = "model"):
    """The reference's ``apply_ep``: the rank's experts over its data
    shard's pairs, one all-reduce over ``model_axis`` as the combine, the
    capacity and the aux of each data shard, the aux averaged over the
    data axes -> ((B, S, d), aux)."""
    if mesh is None or model_axis not in sharding.mesh_shape(mesh):
        raise ValueError(f"apply_ep (expert parallelism) needs a mesh with a "
                         f"{model_axis!r} axis")
    return _moe(p, cfg, x, False, mesh, model_axis, per_shard=True)


def _moe(p: MoE, cfg: ModelConfig, x: torch.Tensor, use_kernel: bool, mesh,
         model_axis: str, per_shard: bool, batch_axes=None):
    B, S, d = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, d)
    dp = batch_axes or (sharding.other_axes(mesh, model_axis)
                        if mesh is not None else ())
    D = sharding.axis_size(mesh, dp) if dp else 1
    lo, wi, wo = p.experts.start, p.wi, p.wo
    split = wi.shape[0] < E                     # experts over model_axis
    if split and model_axis in dp:
        raise ValueError(f"a batch split over {dp} needs the experts whole "
                         f"on every {model_axis!r} rank (tp1)")
    if per_shard and not split:
        # tp1 with moe_ep: the whole experts on every rank, which takes
        # its block of them, as the reference's shard_map slices them
        # (``part`` sums the ranks' gradients of their blocks)
        ep = sharding.group(mesh, model_axis)
        if ep.size > 1:
            lo, split = ep.block(E).start, True
            wi, wo = ep.part(wi, 0), ep.part(wo, 0)

    probs = torch.softmax(xt.to(torch.float32) @ gathered(p).router, dim=-1)
    # each rank's pairs use the replicated probabilities and tokens: their
    # gradients are summed over model_axis (the aux below uses probs as
    # they are, so its gradient counts once)
    xin = sharding.copy_to(xt, mesh, model_axis) if split else xt
    gate, topk = _top_k(sharding.copy_to(probs, mesh, model_axis)
                        if split else probs, cfg, x.dtype)

    ef = topk.reshape(-1)                                    # (T*K,)
    rank, counts = _rank_in_expert(ef, E)
    if per_shard or D == 1:
        C = _capacity(cfg, T)
        kept = rank < C
        cnt = counts.clamp(max=C)
        total = counts
    else:
        # the global batch: the data ranks' counts side by side, a pair
        # ranked after its expert's pairs on the lower data ranks
        C = _capacity(cfg, T * D)
        table = torch.zeros((D, E), dtype=counts.dtype, device=x.device)
        i = sharding.axis_index(mesh, dp)
        table[i] = counts
        sharding.all_reduce(table, mesh, dp)
        offset = table[:i].sum(0)
        kept = rank + offset[ef] < C
        cnt = torch.minimum(counts, (C - offset).clamp(min=0))
        total = table.sum(0)
    if apply.routing is not None:
        apply.routing.append((topk.sort(-1).values, int((~kept).sum())))

    y = _experts(p, xin, ef, rank, kept, gate, C,
                 cnt[lo:lo + wi.shape[0]], use_kernel, lo, wi, wo)

    joined = cfg.moe_shared_experts and split and p.tp.size > 1
    if joined:      # the shared experts' partial sums join the combine
        sh = gathered(p.shared)
        y = y + swiglu(xin, sh.wi, sh.wo)
    if split:
        y = sharding.reduce_from(y, mesh, model_axis)        # the combine
    if cfg.moe_shared_experts and not joined:
        y = y + mlp(p.shared, xt)

    n_pairs = (T if per_shard else T * D) * K
    frac_tok = total.to(torch.float32) / max(n_pairs, 1)
    aux = E * (frac_tok * probs.mean(0)).sum()
    if D > 1:
        aux = sharding.mean_value(aux, mesh, dp)
    return y.reshape(B, S, d).to(x.dtype), aux


#: None, or a list to which every call appends each token's top-k experts
#: (T, K), sorted, and the number of pairs past the capacity
apply.routing = None
