"""Serving, on one GPU or on a mesh of ranks — the PyTorch counterpart of
``repro.launch.serve``: a decode cache, a decode step, and the simple
batched greedy decoding loop.

Cache sharding rule (per leaf, greedy; ``cache_spec_for`` /
``cache_specs``, the reference's, pure functions of shapes): give "data"
(or ("pod","data")) the largest divisible dim — the batch dim for batched
decode, the *sequence* dim for long-context batch-1 decode (ring-style KV
sharding) — then give "model" the next largest divisible dim (heads /
head_dim / state).

On a mesh the batch goes over the data axes when it divides
(``batch % data == 0``, the reference's rule): each data rank holds its
streams' rows of the cache and decodes them, and every MoE layer routes
the whole decode batch with the rank's experts (``transformer``).  A
batch that does not divide is replicated, as the reference replicates its
inputs: every rank decodes it whole.  Over the "model" axis the model is
tensor parallel whatever the batch: each rank's cache holds the kv
heads its query heads use (whole, where its columns cut a head:
``attention.kv_heads``), Mamba channels and its own columns' state of
each head they touch (``mamba.init_cache``), and for the mLSTM heads its
columns touch (its own columns of C, n and m whole,
``xlstm.init_mlstm_cache``) — the specs' "model" shard of heads / state,
or more where a rank computes a head that it shares (musicgen-medium on
16 ranks: 2 of 24 kv heads, 4/3 of the spec's bytes).  Under FSDP each decode step
gathers each layer's leaves over "data" just before the layer and frees
them after it, whether the batch is split or replicated (the model's own
"data" group).

A batch replicated over data axes of D > 1 ranks (batch 1 at long_500k's
524,288 positions; batch 2 on data 4) splits each self-attention KV leaf
(B, KVH, max_len, hd) along the sequence where the spec of the whole
leaf's shape (``cache_spec_for``, decided from the whole shape, as the
reference's ``make_cache`` calls ``eval_shape`` before it places
anything) puts the data axes on ``max_len`` (``seq_shard``): data rank i
(pod major) holds positions [i · max_len / D, (i + 1) · max_len / D);
the rank that owns position ``len`` writes it, and each step's attention
merges the ranks' partial softmaxes over the data axes
(``models.attention.merge_partials``) — the same function as a whole
cache, in 1 / D of its memory.  Where the spec puts the data axes on
another dimension or on none (a ``max_len`` that does not divide by D,
or that is shorter than ``hd``), the cache stays replicated.  Three
placements differ from the spec, each the same function:
- a batch that divides keeps its rows a rank, whatever dimension the
  spec gives "data" (its bytes a rank are the spec's);
- the recurrent states (Mamba's ``conv`` / ``ssm``, the mLSTM's and the
  sLSTM's) stay replicated over the data axes at a replicated batch
  (MBs, not GBs);
- the cross layers' ``ck`` / ``cv`` stay replicated too.
"""
from __future__ import annotations

import torch

from repro_torch.core import sharding
from repro_torch.core.sharding import P, axis_size, data_axes, mesh_shape
from repro_torch.models import transformer
from repro_torch.models.layers import ModelConfig
from .train import rows


def cache_spec_for(shape: tuple[int, ...], ndata: int, nmodel: int,
                   dp, skip_dim0: bool = False) -> P:
    parts: list = [None] * len(shape)
    order = sorted(range(1 if skip_dim0 else 0, len(shape)),
                   key=lambda i: -shape[i])
    for ax_name, ax_size in ((dp, ndata), ("model", nmodel)):
        for i in order:
            if parts[i] is None and shape[i] >= ax_size and \
                    shape[i] % ax_size == 0 and ax_size > 1:
                parts[i] = ax_name
                break
    return P(*parts)


def cache_specs(cache_shapes, mesh):
    """Spec tree for a cache pytree (leaves with ``shape`` and ``ndim``:
    tensors, arrays, shape structs), in the reference's layout or the
    port's ``{"layers": [...]}``."""
    dp = data_axes(mesh)
    nd = axis_size(mesh, dp)
    nm = mesh_shape(mesh).get("model", 1)

    def leaf(path, a):
        skip = path and path[0] == "group"   # don't shard the scan axis
        if a.ndim == 0:
            return P()
        return cache_spec_for(tuple(a.shape), nd, nm, dp, skip_dim0=skip)

    return _map_with_path(leaf, cache_shapes)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(t) if isinstance(tree, tuple) else t
    return fn(path, tree)


def batch_mesh(mesh, batch: int):
    """The mesh a decode batch of ``batch`` streams runs on: ``mesh``
    when the batch splits over its data axes (or it has none), else its
    "model" axis alone (the batch replicated, the reference's
    ``bp = None``; ``batch=0`` too, as there), else ``False``: no mesh
    (``mesh=None`` means the model's own)."""
    if mesh is None:
        return None
    shape = mesh_shape(mesh)
    dp = tuple(a for a in ("pod", "data") if a in shape)
    if not dp or (batch and batch % axis_size(mesh, dp) == 0):
        return mesh
    return mesh["model"] if "model" in shape else False


def seq_shard(mesh, cfg: ModelConfig, batch: int, max_len: int):
    """The group of the data axes over which a decode cache of ``batch``
    streams of ``max_len`` positions splits its self-attention KV leaves
    along the sequence (module docstring): where ``batch_mesh`` replicates
    the batch and ``cache_spec_for`` of the whole leaf (batch, KVH,
    max_len, hd) puts the data axes on ``max_len``; ``SOLO`` (a whole
    cache) otherwise, or without a mesh."""
    if mesh is None or batch <= 0 or batch_mesh(mesh, batch) is mesh:
        return sharding.SOLO
    dp = data_axes(mesh)
    spec = cache_spec_for((batch, cfg.n_kv_heads, max_len, cfg.hd),
                          axis_size(mesh, dp),
                          mesh_shape(mesh).get("model", 1), dp)
    return sharding.group(mesh, dp) if spec[2] == dp else sharding.SOLO


def make_cache(model, cfg: ModelConfig, batch: int, max_len: int,
               frontend=None, mesh=None) -> dict:
    """A decode cache for ``batch`` streams of up to ``max_len`` tokens on
    the model's device; the VLM family's cross layers cache the keys and
    values of ``frontend`` (B, T, d).  On ``mesh`` (default the model's),
    this rank's streams' rows (``frontend`` is then the whole batch's),
    or, where the batch is replicated, the rank's block of positions of
    each self-attention layer (``seq_shard``)."""
    mesh = mesh if mesh is not None else model.mesh
    bm = batch_mesh(mesh, batch)
    if bm and "data" in bm.mesh_dim_names:
        r = rows(batch, bm)
        frontend = None if frontend is None else frontend[r]
        return transformer.init_cache(model, cfg, r.stop - r.start, max_len,
                                      frontend=frontend)
    return transformer.init_cache(model, cfg, batch, max_len,
                                  frontend=frontend,
                                  seq=seq_shard(mesh, cfg, batch, max_len))


def make_serve_step(cfg: ModelConfig, mesh=None, *, batch: int = 0,
                    max_len: int = 0):
    """``step(model, cache, tokens=None, embeds=None, frontend=None)`` ->
    (logits (B, 1, V), cache): one ``transformer.decode_step`` of this
    rank's streams.  On ``mesh`` (default the model's) the step belongs to
    a decode batch of ``batch`` streams, split or replicated
    (``batch_mesh``), over a cache that ``make_cache`` made of ``max_len``
    positions, whose positions the data axes may split (``seq_shard``):
    the step raises on a cache of another length.  ``max_len`` 0 (not
    known) is taken only where the batch splits or there are no data
    ranks to split over; a batch replicated over D > 1 data ranks needs
    it, since its cache may hold a block of positions a rank."""
    def step(model, cache, tokens=None, embeds=None, frontend=None):
        m = mesh if mesh is not None else model.mesh
        bm = batch_mesh(m, batch)
        seq = sharding.SOLO
        if max_len:
            seq = seq_shard(m, cfg, batch, max_len)
            _check_block(cache, seq.block(max_len))
        elif bm is not m and axis_size(m, data_axes(m)) > 1:
            raise ValueError(
                f"a decode batch of {batch} streams is replicated over "
                f"{axis_size(m, data_axes(m))} data ranks: make_serve_step "
                f"needs the cache's max_len")
        return transformer.decode_step(model, cfg, tokens, cache,
                                       embeds=embeds, frontend=frontend,
                                       mesh=bm, seq=seq)
    return step


def _check_block(cache: dict, pos: slice) -> None:
    """Raise unless every self-attention cache holds the block ``pos``'s
    length of positions (a cache made with another ``max_len``, or split
    where the step's is whole)."""
    for c in cache["layers"]:
        if "k" in c and c["k"].shape[2] != pos.stop - pos.start:
            raise ValueError(f"the cache holds {c['k'].shape[2]} positions "
                             f"a rank, not the {pos.stop - pos.start} of "
                             f"the step's max_len")


@torch.no_grad()
def greedy_generate(model, cfg: ModelConfig, prompt, max_new: int,
                    frontend=None, mesh=None) -> torch.Tensor:
    """Batched greedy decoding: the prompt is fed token by token through
    ``decode_step`` (the reference's schedule, ``serve.py:110-121``), then
    ``max_new`` tokens are picked by argmax.  ``prompt`` (B, S) int;
    ``frontend`` (B, T, d) the VLM family's image tokens, handed to the
    step only for that family, as the reference does; returns
    (B, S + max_new) int32 on the model's device.  On ``mesh`` (default
    the model's) every rank passes the whole prompt and gets its streams'
    rows back (the whole batch where it is replicated)."""
    mesh = mesh if mesh is not None else model.mesh
    prompt = transformer.as_tokens(prompt, model.device)
    frontend = transformer.as_frontend(frontend, model.device)
    B, S = prompt.shape
    bm = batch_mesh(mesh, B)
    if bm and "data" in bm.mesh_dim_names:
        prompt = prompt[rows(B, bm)]
    cache = make_cache(model, cfg, B, S + max_new, frontend=frontend,
                       mesh=mesh)
    if frontend is not None and bm and "data" in bm.mesh_dim_names:
        frontend = frontend[rows(B, bm)]
    step = make_serve_step(cfg, mesh, batch=B, max_len=S + max_new)
    tok = prompt[:, :1]
    out = [tok]
    for i in range(S + max_new - 1):
        logits, cache = step(model, cache, tok, None,
                             frontend if cfg.family == "vlm" else None)
        if i + 1 < S:
            tok = prompt[:, i + 1:i + 2]
        else:
            tok = logits[:, -1:, :].argmax(dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)
