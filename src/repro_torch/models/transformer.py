"""Decoder assembler — the PyTorch counterpart of
``repro.models.transformer`` for every family of the repo's configs:
embed → blocks → final norm → lm head, with the full-sequence ``forward``
(with ``use_kernel=True`` its self-attention on the ``flash_attention``
kernel, its MoE experts on ``moe_gmm`` and its Mamba scan on
``ssd_scan``) and the cached one-token ``decode_step``.

The layer plan (``_desc``, ``layer_plan``) is the reference's, for every
config.  The reference stacks the repeating group and runs it under
``lax.scan``; here the layers are an ``nn.ModuleList`` run in a Python
loop, which gives the same numbers.  Ported: the ``attn``, ``cross``
(the VLM family's image layers, over ``frontend=`` tokens), ``mamba``,
``mlstm`` and ``slstm`` mixers, the ``dense``, ``moe`` and ``none``
FFNs, ``parallel_block`` (stablelm), ``qkv_bias`` (codeqwen) and the
audio family's ``embeds=`` input.

On a mesh (``core.sharding``) the model is built with ``mesh=`` and
``x`` is the rank's rows of a batch split over the data axes.  Every
entry of ``param_specs`` is a shard (``layers.layout``).  "model", on a
"model" axis of M > 1 ranks: tensor parallelism, Megatron's column- and
row-parallel matmuls — each layer's input enters its rank's heads or
columns through ``copy_to`` and its output is the ranks' partial sums
added (``reduce_from``; one all-reduce for a ``parallel_block`` layer's
mixer and FFN), the embedding a masked lookup of the rank's vocab
rows, the logits the rank's vocab columns gathered (``loss_fn``'s
streamed CE combines the ranks' log-sum-exp instead) — and the experts,
the rank's block of them whatever ``moe_ep`` says (each MoE layer runs
``moe.apply_ep`` under ``moe_ep``, as the reference's block does, and
``moe.apply``'s result over the whole batch otherwise and in decode,
whose reference block calls ``moe.apply``; ``moe_ep`` without a mesh
that has a "model" axis raises a ``ValueError`` when the model is
built).  "data", FSDP's entry on the embedding dimension (``fsdp=True``)
on a "data" axis of D > 1 ranks: each rank holds its block and gathers a
layer's leaves over "data" just before the layer uses them
(``layers.gathered``; ZeRO-3), the embedding in ``_embed`` and the head
in ``_logits`` and the streamed CE; the gradient of a gathered leaf is
reduce-scattered over "data".  A rank's columns of the attention's,
the mLSTM's or Mamba's heads may cut a head: it computes every head they
touch (``layers.head_split``).  A config whose "model" or "data"
dimensions or experts do not split over the mesh raises, as the
reference's ``jax.jit`` refuses it (``check_ported``).  ``tp1=True``
places the model by the specs the reference's dry-run leaves for its
``tp1`` and ``dp_all`` flags
(``param_specs(cfg, tp1=True)``: no "model" entry): its "model" group
is one rank, so every rank of a "model" axis holds the
"model" dimensions and the experts whole and computes what the others
compute; FSDP's "data" entries stay, and under ``moe_ep`` each rank
takes its block of the whole experts, as the reference's ``shard_map``
slices them.  A prefill's batch may also split over "model" (the
reference's ``dp_all``; ``forward``'s ``batch_axes``).
In decode a batch replicated over the data axes may hold each
self-attention cache as the rank's block of positions (``decode_step``'s
``seq``; ``launch.serve.seq_shard``).
The training loss is ``loss_fn`` (next-token CE in float32, through the
whole logits or streamed over vocab chunks by ``_chunked_ce``, plus the
MoE aux); with ``cfg.remat`` and grad on, ``trunk`` recomputes each repeat
of the layer group in the backward pass, as the reference's
``jax.checkpoint`` of its scan body does.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core import sharding
from repro_torch.core.banked import _device
from repro_torch.core.sharding import P
from . import attention, mamba, moe, xlstm
from .layers import (MLP, ModelConfig, _param, build, emb_axis, gathered,
                     layout, mlp, mlp_specs, rms_norm, strip_model,
                     swiglu)

#: each mixer's module
_MIXERS = {"attn": attention.Attention, "cross": attention.Attention,
           "mamba": mamba.Mamba, "mlstm": xlstm.MLSTM, "slstm": xlstm.SLSTM}


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------

def _desc(cfg: ModelConfig, li: int) -> dict:
    if cfg.family == "ssm":
        mixer = "slstm" if (cfg.slstm_every and
                            li % cfg.slstm_every == cfg.slstm_every - 1) \
            else "mlstm"
        return {"mixer": mixer, "ffn": "none", "ff": 0}
    if cfg.attn_every and li % cfg.attn_every != 0:
        mixer = "mamba"
    elif cfg.cross_attn_every and \
            li % cfg.cross_attn_every == cfg.cross_attn_every - 1:
        mixer = "cross"
    else:
        mixer = "attn"
    is_moe = (cfg.moe_experts > 0 and li % cfg.moe_every == 0
              and not (cfg.moe_first_dense and li == 0))
    if is_moe:
        return {"mixer": mixer, "ffn": "moe", "ff": cfg.d_ff}
    ff = cfg.dense_ff or cfg.d_ff
    return {"mixer": mixer, "ffn": "dense" if ff else "none", "ff": ff}


def layer_plan(cfg: ModelConfig):
    """Returns (prologue_descs, period_descs, repeats)."""
    descs = [_desc(cfg, li) for li in range(cfg.n_layers)]
    cad = [c for c in (cfg.attn_every, cfg.moe_every, cfg.cross_attn_every,
                       cfg.slstm_every) if c]
    p = math.lcm(*cad) if cad else 1
    for q in range(cfg.n_layers + 1):
        rest = descs[q:]
        if len(rest) % p:
            continue
        groups = [rest[i:i + p] for i in range(0, len(rest), p)]
        if all(g == groups[0] for g in groups):
            return descs[:q], groups[0] if groups else [], len(groups)
    raise ValueError(f"no periodic plan for {cfg.name}")


def check_ported(cfg: ModelConfig, mesh=None, tp1: bool = False) -> None:
    """Raise ``ValueError`` when ``cfg`` cannot be built on ``mesh``, where
    the reference's ``jax.jit`` or ``shard_map`` refuses it too: ``moe_ep``
    needs a mesh with a "model" axis, and the experts must divide over a
    "model" axis of M > 1 ranks (``moe.expert_ranks``); tensor
    parallelism over such an axis needs every "model" dimension of
    ``param_specs`` to divide by M (``jax.jit`` refuses such a spec), each
    fused leaf's halves too (their blocks of the leaves beside them
    divide); FSDP over a "data" axis of D > 1 ranks needs every "data"
    dimension to divide by D.  Heads need not divide: a rank's columns of
    the attention's, the mLSTM's or Mamba's heads may cut a head, and it
    computes every head they touch (``layers.head_split``); a
    ``parallel_block`` layer adds any mixer's partial sum to its FFN's.
    ``tp1``: the specs without "model" (``param_specs``), so only FSDP's
    dimensions and ``moe_ep``'s experts must divide.  Each message names
    the config and the axis."""
    if any(_desc(cfg, li)["ffn"] == "moe" for li in range(cfg.n_layers)):
        moe.expert_ranks(cfg, mesh, tp1=tp1)
    specs = param_specs(cfg, tp1)
    dims = sharding.mesh_shape(mesh) if mesh is not None else {}
    m = 1 if tp1 else dims.get("model", 1)
    d = dims.get("data", 1)
    if m == 1 and d == 1:
        return
    why = f"{cfg.name}: tensor parallelism over {m} model ranks"
    whole = Transformer(dataclasses.replace(cfg, moe_ep=False), device="meta")
    shapes = {k: tuple(v.shape) for k, v in whole.named_parameters()}
    fsdp = f"{cfg.name}: FSDP over {d} data ranks"
    for name, spec in specs.items():
        for how, sizes in ((why, (m, 1)), (fsdp, (1, d))):
            try:
                layout(name, spec, shapes[name], *sizes)
            except ValueError as e:
                raise ValueError(f"{how}: {e}") from None


#: each mixer's specs
_MIXER_SPECS = {"attn": attention.specs, "cross": attention.specs,
                "mamba": mamba.specs, "mlstm": xlstm.mlstm_specs,
                "slstm": xlstm.slstm_specs}


def param_specs(cfg: ModelConfig, tp1: bool = False) -> dict:
    """The reference's ``PartitionSpec`` (``P``) of every parameter, by
    the port's parameter name: the specs of the reference's ``init`` for
    each leaf (a stacked group leaf's without its leading repeat axis;
    ``convert.reference_specs`` gives the reference's tree).  ``tp1``:
    rewritten as the reference's dry-run does for its ``tp1`` and
    ``dp_all`` flags (``layers.strip_model``: no entry "model"; "data"
    kept)."""
    e = emb_axis(cfg.fsdp)
    out = {"embed": P("model", e), "lm_head": P(e, "model"),
           "final_norm": P(None)}
    for li in range(cfg.n_layers):
        desc = _desc(cfg, li)
        blk = {"norm1": P(None), "mixer": _MIXER_SPECS[desc["mixer"]](cfg)}
        if desc["ffn"] != "none":
            blk["norm2"] = P(None)
            blk["ffn"] = (moe.specs(cfg) if desc["ffn"] == "moe"
                          else mlp_specs(cfg))
        out.update(_named(blk, f"layers.{li}."))
    return {k: strip_model(v) for k, v in out.items()} if tp1 else out


def _named(tree: dict, prefix: str):
    """A nested dict's leaves as (dotted name, leaf)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def leaf_parts(model: nn.Module) -> dict:
    """The dotted name of every parameter under ``model`` (a model or any
    of its modules) that this rank holds a part of — on a mesh, each leaf
    split over "model" (tensor parallelism, the experts) or over "data"
    (FSDP), or both — and (its ``layers.Layout``, the rank's index in it,
    ``{axis: index}``)."""
    return {f"{name}.{leaf}".lstrip("."): (lay, mod.part_index)
            for name, mod in model.named_modules()
            for leaf, lay in getattr(mod, "layouts", {}).items()}


def sharded_leaves(model: nn.Module) -> dict:
    """``leaf_parts``' names and layouts (``Layout.axes``: the axes each
    is split over)."""
    return {k: lay for k, (lay, _) in leaf_parts(model).items()}


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """``norm1``, ``mixer`` (self or cross attention, Mamba, mLSTM or
    sLSTM) and, unless the FFN is ``none``, ``norm2`` and ``ffn`` (dense or
    MoE): the reference's block keys."""

    def __init__(self, cfg: ModelConfig, desc: dict, *,
                 gen: torch.Generator | None = None, device=None, mesh=None,
                 tp=sharding.SOLO, fs=sharding.SOLO):
        super().__init__()
        d = cfg.d_model
        self.desc = desc
        self.tp = tp
        self.norm1 = _param(torch.ones(d, dtype=cfg.dtype, device=device))
        self.mixer = _MIXERS[desc["mixer"]](cfg, gen=gen, device=device, tp=tp,
                                            fs=fs)
        if desc["ffn"] != "none":
            self.norm2 = _param(torch.ones(d, dtype=cfg.dtype, device=device))
            self.ffn = (moe.MoE(cfg, gen=gen, device=device, mesh=mesh, tp=tp,
                                ep=tp)
                        if desc["ffn"] == "moe"
                        else MLP(cfg, desc["ff"], gen=gen, device=device,
                                 tp=tp, fs=fs))


class Transformer(nn.Module):
    """``embed`` (V, d), ``layers``, ``final_norm`` (d,), ``lm_head``
    (d, V).  Built on ``device`` (default ``cuda:0``; raises without CUDA
    unless ``device="cpu"``); weights drawn from ``gen`` when it is given,
    uninitialised otherwise (``models/convert.py`` fills them).  ``mesh``:
    the mesh the model runs on (``self.mesh``, the default of ``forward``,
    ``loss_fn`` and ``decode_step``), whose "model" axis (``self.tp``)
    shards the dense leaves and the experts and whose "data" axis
    (``self.fs``) the FSDP leaves: the rank draws each leaf as one
    process draws it and keeps its part.  ``tp1``: placed by the
    reference's ``tp1`` specs (``param_specs(cfg, tp1=True)``): ``self.tp``
    is the group of one (``sharding.SOLO``), so each rank holds the "model"
    dimensions and the experts whole and the ranks of a "model" axis
    compute alike; FSDP's "data" entries stay."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator | None = None,
                 device=None, mesh=None, tp1: bool = False):
        super().__init__()
        check_ported(cfg, mesh, tp1)
        dev = _device(device)
        self.cfg = cfg
        self.mesh = mesh
        # the tp1 specs hold no "model" entry (``layers.strip_model``, the
        # reference's ``_strip_model_axis``; no spec names "model" inside a
        # tuple), so the layers split nothing over a "model" group of one
        tp = sharding.SOLO if tp1 else sharding.group(mesh, "model")
        fs = sharding.group(mesh, "data")
        d, V = cfg.d_model, cfg.vocab
        e = emb_axis(cfg.fsdp)
        build(self, {"embed": (V, d), "lm_head": (d, V)},
              {"embed": P("model", e), "lm_head": P(e, "model")}, cfg.dtype,
              gen, dev, tp, fs)
        self.final_norm = _param(torch.ones(d, dtype=cfg.dtype, device=dev))
        self.layers = nn.ModuleList(
            Block(cfg, _desc(cfg, li), gen=gen, device=dev, mesh=mesh, tp=tp,
                  fs=fs)
            for li in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init(cfg: ModelConfig, *, seed: int = 0, device=None, mesh=None,
         tp1: bool = False) -> Transformer:
    """A model with seeded random weights (the reference's scheme: normal
    with variance 1 / fan-in, ones for the norms, zeros for the biases),
    drawn on ``device`` from ``torch.Generator(device).manual_seed(seed)``.
    The bits differ from the reference's ``jax.random`` ones; the parity
    tests carry the reference's weights across instead.  On ``mesh`` every
    rank draws what one process draws, a slab at a time, and keeps its
    part of each leaf (``layers.leaf``); ``tp1`` as ``Transformer``'s."""
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Transformer(cfg, gen=gen, device=dev, mesh=mesh, tp1=tp1)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _mix(p: Block, cfg: ModelConfig, h: torch.Tensor, frontend,
         use_kernel: bool, reduce: bool = True) -> torch.Tensor:
    """The block's mixer on the normed hidden ``h``; ``reduce=False``: the
    rank's partial sum of a self-attention, cross or Mamba mixer (those of
    a ``parallel_block`` layer with a dense FFN: the mLSTM and sLSTM
    layers have none)."""
    mixer = p.desc["mixer"]
    if mixer == "attn":
        return attention.apply(p.mixer, cfg, h, use_kernel=use_kernel,
                               reduce=reduce)
    if mixer == "cross":
        return attention.apply_cross(p.mixer, cfg, h, frontend,
                                     reduce=reduce)
    if mixer == "mamba":
        return mamba.apply(p.mixer, cfg, h, use_kernel=use_kernel,
                           reduce=reduce)
    if mixer == "mlstm":
        if cfg.mlstm_chunk:
            return xlstm.apply_mlstm_chunked(p.mixer, cfg, h,
                                             chunk=cfg.mlstm_chunk)
        return xlstm.apply_mlstm(p.mixer, cfg, h)
    return xlstm.apply_slstm(p.mixer, cfg, h)


def _block_apply(p: Block, cfg: ModelConfig, x: torch.Tensor,
                 use_kernel: bool, frontend=None, mesh=None, batch_axes=None):
    """One block's forward -> (x, aux), aux the MoE FFN's load-balancing
    loss (0 for the other FFNs); ``frontend`` the tokens a cross layer
    attends to; ``mesh`` the mesh whose data axes (or ``batch_axes``)
    split ``x``'s batch."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p.norm1)
    if cfg.parallel_block and p.desc["ffn"] == "dense":
        return _parallel(p, x, h, _mix(p, cfg, h, frontend, use_kernel,
                                       reduce=False)), aux
    mo = _mix(p, cfg, h, frontend, use_kernel)
    if p.desc["ffn"] == "none":
        return x + mo, aux
    x = x + mo
    h2 = rms_norm(x, p.norm2)
    if p.desc["ffn"] == "moe":
        if cfg.moe_ep:
            fo, aux = moe.apply_ep(p.ffn, cfg, h2, mesh=mesh)
        else:
            fo, aux = moe.apply(p.ffn, cfg, h2, use_kernel=use_kernel,
                                mesh=mesh, batch_axes=batch_axes)
    else:
        fo = mlp(p.ffn, h2)
    return x + fo, aux


def _parallel(p: Block, x: torch.Tensor, h: torch.Tensor,
              mo: torch.Tensor) -> torch.Tensor:
    """stablelm's attn ∥ ffn off one norm: ``x`` plus the mixer's output
    ``mo`` (any mixer's: the reference adds whatever it returns) and the
    FFN's, the ranks' partial sums of both added in one all-reduce."""
    if p.tp.size == 1:
        f = gathered(p.ffn)
        return x + mo + swiglu(h, f.wi, f.wo)
    return x + p.tp.reduce_from(mo + mlp(p.ffn, h, reduce=False))


def _mesh(model: Transformer, mesh):
    """The mesh a call runs on: ``model.mesh`` for None, none for
    ``False``."""
    return model.mesh if mesh is None else (None if mesh is False else mesh)


def as_tokens(tokens, device) -> torch.Tensor:
    """Token ids (a tensor, or anything numpy takes) as an int32 tensor on
    ``device``."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.array(tokens, dtype=np.int32))
    return tokens.to(device=device, dtype=torch.int32)


def as_frontend(frontend, device) -> torch.Tensor | None:
    """Frontend tokens (B, T, d) — a tensor, or anything numpy takes — on
    ``device`` in their own dtype (the cross layers promote them with the
    weights as jnp does)."""
    if frontend is None:
        return None
    if not isinstance(frontend, torch.Tensor):
        frontend = torch.from_numpy(np.asarray(frontend))
    return frontend.to(device)


def _embed(model: Transformer, cfg: ModelConfig, tokens, embeds):
    """The token embeddings; on a "model" axis each rank looks up the
    tokens of its vocab rows (zeros for the others) and the ranks' rows
    are added; under FSDP the rank's rows gathered over "data" first."""
    if embeds is not None:
        return embeds.to(cfg.dtype)
    ids = as_tokens(tokens, model.device)
    tp, embed = model.tp, gathered(model).embed
    if tp.size == 1:
        return embed[ids]
    rows = tp.block(cfg.vocab)
    mine = (ids >= rows.start) & (ids < rows.stop)
    e = embed[torch.where(mine, ids - rows.start, 0)]
    return tp.reduce_from(torch.where(mine[..., None], e, 0))


def _group_apply(blocks, cfg: ModelConfig, x: torch.Tensor,
                 aux: torch.Tensor, use_kernel: bool, frontend, mesh,
                 batch_axes=None):
    """Blocks in order, summing their aux into ``aux`` -> (x, aux)."""
    for blk in blocks:
        x, a = _block_apply(blk, cfg, x, use_kernel, frontend, mesh,
                            batch_axes)
        aux = aux + a
    return x, aux


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``remat_policy`` other than
    "full": keep the outputs of the plain matmuls (``x @ w`` reaches
    ``aten.mm``; a batched product, the attention's, reaches ``aten.bmm``)
    and recompute the rest, the reference's
    ``dots_with_no_batch_dims_saveable``."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn`` recomputed in the backward pass (``cfg.remat``)."""
    kw = {} if cfg.remat_policy == "full" else {
        "context_fn": functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)}
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def trunk(model: Transformer, cfg: ModelConfig, tokens=None, embeds=None,
          frontend=None, use_kernel: bool = False, mesh=None,
          batch_axes=None):
    """Embed + all blocks + final norm (pre-lm_head hidden). → (x, aux);
    ``aux`` is the sum of the MoE layers' load-balancing losses.
    ``frontend`` (B, T, d): the tokens the cross layers attend to.  With
    ``cfg.remat`` and grad on, each repeat of the layer plan's period
    (not the prologue) is recomputed in the backward pass.  ``mesh``
    (default ``model.mesh``; ``False``: none): the mesh whose data axes
    split the batch; ``batch_axes``: the axes that split it instead (the
    reference's ``dp_all`` prefill splits it over "model" too, which only
    a model whose "model" group is one rank takes: ``tp1``)."""
    mesh = _mesh(model, mesh)
    if batch_axes and "model" in batch_axes:
        if model.tp.size > 1:
            raise ValueError(f"a batch split over {batch_axes} needs a model "
                             f"without tensor parallelism (tp1)")
        if cfg.moe_ep:      # its shard_map would gather the rows over "model"
            raise ValueError(f"{cfg.name}: moe_ep with a batch split over "
                             f"{batch_axes} (dp_all): not ported")
    x = _embed(model, cfg, tokens, embeds)
    frontend = as_frontend(frontend, model.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    pro, period, repeats = layer_plan(cfg)
    layers = list(model.layers)
    x, aux = _group_apply(layers[:len(pro)], cfg, x, aux, use_kernel, frontend,
                          mesh, batch_axes)
    group = _group_apply
    if cfg.remat and torch.is_grad_enabled():
        group = _remat(cfg, _group_apply)
    n = len(period)
    for r in range(repeats):
        x, aux = group(layers[len(pro) + r * n:len(pro) + (r + 1) * n], cfg,
                       x, aux, use_kernel, frontend, mesh, batch_axes)
    return rms_norm(x, model.final_norm), aux


def forward(model: Transformer, cfg: ModelConfig, tokens=None, embeds=None,
            frontend=None, use_kernel: bool = False, mesh=None,
            batch_axes=None):
    """tokens: (B, S) int or embeds: (B, S, d); frontend: (B, T, d) for the
    VLM family; ``mesh`` / ``batch_axes`` as ``trunk``'s. Returns (logits,
    aux)."""
    x, aux = trunk(model, cfg, tokens=tokens, embeds=embeds,
                   frontend=frontend, use_kernel=use_kernel, mesh=mesh,
                   batch_axes=batch_axes)
    return _logits(model, x), aux


def _logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    """``x @ lm_head``; on a "model" axis the ranks' vocab columns
    gathered; under FSDP the head gathered over "data" first."""
    tp = model.tp
    return tp.gather(tp.copy_to(x) @ gathered(model).lm_head, dim=-1)


def _chunked_ce(x: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor,
                n_chunks: int, tp=sharding.SOLO) -> torch.Tensor:
    """Streaming CE over vocab chunks: the (B, S, V) logits are never
    whole (one (B, S, V / k) chunk at a time, a float32 running max, sum
    and gold logit).  The head is zero-padded to ``n_chunks`` chunks of
    ceil(V / n_chunks) columns; padded columns read -1e30.  On ``tp``
    ``lm_head`` is the rank's vocab columns: each rank streams its own,
    and the ranks' maxima, sums and gold logits are combined."""
    if tp.size > 1:
        x = tp.copy_to(x)
        labels = labels - tp.block(lm_head.shape[1] * tp.size).start
    m, s, gold = _ce_parts(x, lm_head, labels, n_chunks)
    if tp.size > 1:
        # the log-sum-exp of every rank's columns: the largest maximum (a
        # shift, no gradient), each rank's sum rescaled to it and added
        mg = sharding.all_reduce(m.detach().clone(), tp.mesh, tp.axis,
                                 op=sharding.dist.ReduceOp.MAX)
        s = tp.reduce_from(s * torch.exp(m - mg))
        m, gold = mg, tp.reduce_from(gold)
    return (m + torch.log(s) - gold).mean()


def _ce_parts(x: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor,
              n_chunks: int):
    """``_chunked_ce``'s float32 running max, sum and gold logit (0 where
    the label is not among the columns) over ``lm_head``'s columns."""
    d, V = lm_head.shape
    vc = -(-V // n_chunks)
    w = torch.nn.functional.pad(lm_head, (0, n_chunks * vc - V))
    B, S = labels.shape
    m = torch.full((B, S), -1e30, dtype=torch.float32, device=x.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    gold = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    cols = torch.arange(vc, device=x.device)
    for start in range(0, n_chunks * vc, vc):
        lg = (x @ w[:, start:start + vc]).to(torch.float32)    # (B, S, vc)
        lg = torch.where(start + cols < V, lg, -1e30)
        m_new = torch.maximum(m, lg.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            lg - m_new[..., None]).sum(-1)
        inb = (labels >= start) & (labels < start + vc)
        idx = (labels - start).clamp(0, vc - 1)
        gold = gold + torch.where(
            inb, lg.gather(-1, idx[..., None])[..., 0], 0.0)
        m = m_new
    return m, s, gold


def loss_fn(model: Transformer, cfg: ModelConfig, batch: dict,
            use_kernel: bool = False, loss_chunks: int = 0, mesh=None):
    """batch: {"tokens" or "embeds", "labels" (B, S), optional "frontend"}
    (``launch.train.to_device``).  Mean next-token CE, its log-sum-exp and
    gold logit in float32, + 0.01 × the MoE aux -> (loss, {"ce", "aux"}).
    On a mesh, the CE is this data rank's rows' (``launch.train`` averages
    the ranks')."""
    labels = as_tokens(batch["labels"], model.device).long()
    if loss_chunks:
        x, aux = trunk(model, cfg, tokens=batch.get("tokens"),
                       embeds=batch.get("embeds"),
                       frontend=batch.get("frontend"), use_kernel=use_kernel,
                       mesh=mesh)
        ce = _chunked_ce(x, gathered(model).lm_head, labels, loss_chunks,
                         model.tp)
    else:
        logits, aux = forward(model, cfg, tokens=batch.get("tokens"),
                              embeds=batch.get("embeds"),
                              frontend=batch.get("frontend"),
                              use_kernel=use_kernel, mesh=mesh)
        lf = logits.to(torch.float32)
        gold = lf.gather(-1, labels[..., None])[..., 0]
        ce = (torch.logsumexp(lf, dim=-1) - gold).mean()
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode (serve path)
# ---------------------------------------------------------------------------

def _block_cache(p: Block, cfg: ModelConfig, batch: int, max_len: int,
                 frontend, device, seq=sharding.SOLO) -> dict:
    """The block's cache: the rank's kv heads, channels or heads; a
    self-attention layer's, the rank's block of positions on ``seq``."""
    mixer, m = p.desc["mixer"], p.tp.size
    if mixer == "attn":
        pos = seq.block(max_len)
        return attention.init_cache(cfg, batch, pos.stop - pos.start,
                                    device=device, kv_heads=p.mixer.heads[1])
    if mixer == "cross":
        return attention.init_cross_cache(p.mixer, cfg, frontend)
    if mixer == "mamba":
        return mamba.init_cache(cfg, batch, device=device, m=m,
                                r=p.tp.index)
    if mixer == "mlstm":
        return xlstm.init_mlstm_cache(cfg, batch, device=device, m=m,
                                      r=p.tp.index)
    return xlstm.init_slstm_cache(cfg, batch, device=device)


def init_cache(model: Transformer, cfg: ModelConfig, batch: int,
               max_len: int, frontend=None, seq=sharding.SOLO) -> dict:
    """One cache per layer, ``{"layers": [...]}``, on the model's device:
    a KV cache for a self-attention layer, the frontend's keys and values
    ``{"ck", "cv"}`` for a cross layer (``frontend`` (B, T, d)),
    ``{"conv", "ssm"}`` for a Mamba one, ``{"C", "n", "m"}`` for an mLSTM
    and ``{"c", "n", "m"}`` for an sLSTM (the reference stacks the
    repeating group's caches for its scan); on a "model" axis, the rank's
    kv heads, channels and heads.  ``seq``: the group of the data axes
    over which the self-attention caches' ``max_len`` positions are split
    (``launch.serve.seq_shard``): each holds the rank's block."""
    dev = model.device
    frontend = as_frontend(frontend, dev)
    return {"layers": [_block_cache(blk, cfg, batch, max_len, frontend, dev,
                                    seq) for blk in model.layers]}


def _block_decode(p: Block, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                  mesh=None, seq=sharding.SOLO):
    h = rms_norm(x, p.norm1)
    mixer = p.desc["mixer"]
    par = cfg.parallel_block and p.desc["ffn"] == "dense"
    if mixer == "attn":
        mo, cache = attention.decode(p.mixer, cfg, h, cache, reduce=not par,
                                     seq=seq)
    elif mixer == "cross":
        mo, cache = attention.decode_cross(p.mixer, cfg, h, cache,
                                           reduce=not par)
    elif mixer == "mamba":
        mo, cache = mamba.decode(p.mixer, cfg, h, cache, reduce=not par)
    elif mixer == "mlstm":
        mo, cache = xlstm.decode_mlstm(p.mixer, cfg, h, cache)
    else:
        mo, cache = xlstm.decode_slstm(p.mixer, cfg, h, cache)
    if par:
        return _parallel(p, x, h, mo), cache
    if p.desc["ffn"] == "none":
        return x + mo, cache
    x = x + mo
    h2 = rms_norm(x, p.norm2)
    if p.desc["ffn"] == "moe":      # routing over the B tokens of the step
        fo, _ = moe.apply(p.ffn, cfg, h2, mesh=mesh)
    else:
        fo = mlp(p.ffn, h2)
    return x + fo, cache


def decode_step(model: Transformer, cfg: ModelConfig, tokens, cache: dict,
                embeds=None, frontend=None, mesh=None, seq=sharding.SOLO):
    """One decode step. tokens: (B, 1) int, or embeds (B, 1, d) (the audio
    family's frame embeddings).  ``frontend`` is accepted as the
    reference's step takes it; the cross layers read the keys and values
    ``init_cache`` made from it.  Returns (logits (B, 1, V), cache); the
    cache is updated in place.  On a mesh (default ``model.mesh``) the
    tokens are this data rank's streams, and each MoE layer routes the
    whole decode batch, as the reference's ``moe.apply`` does.  ``seq``:
    the data axes over which the self-attention caches hold blocks of
    positions (``init_cache``); each such layer merges the ranks' partial
    softmaxes over them (``attention.attend_cached``)."""
    mesh = _mesh(model, mesh)
    x = _embed(model, cfg, tokens, embeds)
    for li, blk in enumerate(model.layers):
        x, cache["layers"][li] = _block_decode(blk, cfg, x,
                                               cache["layers"][li], mesh,
                                               seq)
    x = rms_norm(x, model.final_norm)
    return _logits(model, x), cache
