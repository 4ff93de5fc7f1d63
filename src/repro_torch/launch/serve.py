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
tensor parallel whatever the batch: each rank's cache holds its kv heads
(or the kv heads its query heads use), Mamba channels and mLSTM heads —
the specs' "model" shard of heads / state.  Under FSDP each decode step
gathers each layer's leaves over "data" just before the layer and frees
them after it, whether the batch is split or replicated (the model's own
"data" group).  The specs' "data" shard of the sequence (the
long-context batch-1 cache) is realized as replication, the same
function in more memory.
"""
from __future__ import annotations

import torch

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


def make_cache(model, cfg: ModelConfig, batch: int, max_len: int,
               frontend=None, mesh=None) -> dict:
    """A decode cache for ``batch`` streams of up to ``max_len`` tokens on
    the model's device; the VLM family's cross layers cache the keys and
    values of ``frontend`` (B, T, d).  On ``mesh`` (default the model's),
    this rank's streams' rows (``frontend`` is then the whole batch's)."""
    bm = batch_mesh(mesh if mesh is not None else model.mesh, batch)
    if bm and "data" in bm.mesh_dim_names:
        r = rows(batch, bm)
        batch = r.stop - r.start
        frontend = None if frontend is None else frontend[r]
    return transformer.init_cache(model, cfg, batch, max_len,
                                  frontend=frontend)


def make_serve_step(cfg: ModelConfig, mesh=None, *, batch: int = 0):
    """``step(model, cache, tokens=None, embeds=None, frontend=None)`` ->
    (logits (B, 1, V), cache): one ``transformer.decode_step`` of this
    rank's streams.  On ``mesh`` (default the model's) the step belongs to
    a decode batch of ``batch`` streams, split or replicated
    (``batch_mesh``)."""
    def step(model, cache, tokens=None, embeds=None, frontend=None):
        bm = batch_mesh(mesh if mesh is not None else model.mesh, batch)
        return transformer.decode_step(model, cfg, tokens, cache,
                                       embeds=embeds, frontend=frontend,
                                       mesh=bm)
    return step


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
    step = make_serve_step(cfg, mesh, batch=B)
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
