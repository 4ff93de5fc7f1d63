"""Weight carry both ways: the reference's parameter tree, as numpy
arrays, into the port's model with the same numbers
(``params_from_reference``), and the port's model or optimizer state back
into the reference's tree (``params_to_reference``,
``opt_state_to_reference`` / ``opt_state_from_reference``), the layout of
a training checkpoint that either package resumes from.

The reference keeps the blocks before the repeating group as a
``prologue`` list and stacks the group's blocks leaf-wise along a leading
repeat axis (``jax.vmap`` of the block init), so global layer ``li`` is
``group[pos][leaf][r]`` with ``(r, pos) = divmod(li - n_prologue,
period_len)`` — the indexing of ``repro.models.pim_bridge._layer_params``.
Both packages store weights as ``(d_in, d_out)``, so every leaf is a copy,
never a transpose.  A caller holding the reference's jax arrays passes
``jax.tree.map(np.asarray, params)``; this module imports no JAX.

On a mesh a rank holds its part of each leaf that the model shards
(``transformer.sharded_leaves``, by ``layers.layout``: over "model" the
dense leaves of tensor parallelism and the experts, over "data" FSDP's
leaves, a block on each of two dimensions where a leaf has both): a
carry from the reference keeps that part of the leaf (and of the
optimizer's, so a rank's optimizer state is its part too, ZeRO-3's
saving), and a carry back gathers the parts over "model" and "data" and
puts each where the whole leaf holds it (``Split.assemble``, which
undoes the fused leaves' placement), so the reference's tree is whole
and a checkpoint resumes in either package on any mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import sharding
from repro_torch.core.banked import _device
from repro_torch.core.sharding import P
from .layers import ModelConfig
from .transformer import Transformer, layer_plan, leaf_parts, sharded_leaves

#: the leaves outside the blocks
_TOP = ("embed", "final_norm", "lm_head")


def _tensor(a) -> torch.Tensor:
    """A numpy array (or a tensor) as a CPU tensor (a copy); bfloat16
    (``ml_dtypes``) by its bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True)
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _take(tree, r: int):
    """Index every leaf of ``tree`` (arrays or tensors) at ``r`` on its
    leading axis."""
    if isinstance(tree, dict):
        return {k: _take(v, r) for k, v in tree.items()}
    return tree[r]


def _layer_tree(tree: dict, n_prologue: int, period_len: int, li: int):
    if li < n_prologue:
        return tree["prologue"][li]
    r, pos = divmod(li - n_prologue, period_len)
    return _take(tree["group"][pos], r)


def _dotted(tree: dict, prefix: str = "") -> dict:
    """A nested dict's leaves by dotted name."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_dotted(v, f"{prefix}{k}."))
        else:
            flat[prefix + k] = v
    return flat


def _nested(flat: dict) -> dict:
    """The inverse of ``_dotted``."""
    root: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = root
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return root


def _part(t: torch.Tensor, name: str, parts: dict):
    """``t``, the whole leaf ``name``, or the rank's part of it (a block
    of one or two dimensions) where ``parts`` (``transformer.leaf_parts``)
    has it."""
    if name not in parts:
        return t
    lay, index = parts[name]
    return lay.take(t, index)


def _load(module: torch.nn.Module, tree: dict, where: str) -> None:
    """Copy ``tree``'s leaves into ``module``'s parameters of the same
    dotted names; the two must hold the same names, shapes and dtypes,
    but for the leaves a rank holds a part of, which take their part."""
    flat = _dotted(tree)
    params = dict(module.named_parameters())
    if set(flat) != set(params):
        raise ValueError(f"{where}: reference leaves {sorted(flat)} != port "
                         f"parameters {sorted(params)}")
    parts = leaf_parts(module)
    for name, p in params.items():
        src = _part(_tensor(flat[name]), name, parts)
        if src.shape != p.shape or src.dtype != p.dtype:
            raise ValueError(f"{where}.{name}: reference {tuple(src.shape)} "
                             f"{src.dtype}, port {tuple(p.shape)} {p.dtype}")
        with torch.no_grad():
            p.copy_(src)


def params_from_reference(tree: dict, cfg: ModelConfig, device=None,
                          mesh=None) -> Transformer:
    """The port's model on ``device`` (default ``cuda:0``) holding the
    reference's weights ``tree`` (numpy leaves, or tensors) for ``cfg``,
    built on ``mesh`` (the rank keeps its part of each sharded leaf, over
    "model" and "data")."""
    model = Transformer(cfg, device=device, mesh=mesh)
    pro, period, _ = layer_plan(cfg)
    parts = leaf_parts(model)
    with torch.no_grad():
        for k in _TOP:
            getattr(model, k).copy_(_part(_tensor(tree[k]), k, parts))
    for li, blk in enumerate(model.layers):
        _load(blk, _layer_tree(tree, len(pro), max(len(period), 1), li),
              f"layer {li}")
    return model


# -- the port's tensors back into the reference's tree --------------------------


def reference_tree(named: dict, cfg: ModelConfig, stack=torch.stack) -> dict:
    """The reference's tree of ``named``, tensors by the port's parameter
    names (``model.named_parameters()``, or the optimizer's master, mu or
    nu): the top leaves, the ``prologue`` list of block dicts, and the
    ``group`` list with each position's leaves stacked on a leading
    repeat axis (``stack`` of the repeats' leaves).  Leaves stay tensors
    on their device."""
    pro, period, repeats = layer_plan(cfg)
    layers: dict[int, dict] = {}
    for name, t in named.items():
        if name not in _TOP:
            _, li, rest = name.split(".", 2)
            layers.setdefault(int(li), {})[rest] = t
    tree = {k: named[k] for k in _TOP}
    if pro:
        tree["prologue"] = [_nested(layers[li]) for li in range(len(pro))]
    n = len(period)
    if repeats:
        tree["group"] = [_nested({
            k: stack([layers[len(pro) + r * n + pos][k]
                      for r in range(repeats)])
            for k in layers[len(pro) + pos]}) for pos in range(n)]
    return tree


def reference_specs(specs: dict, cfg: ModelConfig) -> dict:
    """The reference's spec tree (``repro.models.transformer.init``'s
    second value) of the port's ``transformer.param_specs(cfg)``: a
    stacked group leaf's spec gains the leading ``None`` of its repeat
    axis."""
    return reference_tree(specs, cfg, stack=lambda ss: P(None, *ss[0]))


def from_reference_tree(tree: dict, cfg: ModelConfig) -> dict:
    """The inverse of ``reference_tree``: the port's parameter names ->
    the reference's leaves (numpy arrays or tensors, as given; a group
    leaf indexed at its repeat)."""
    pro, period, repeats = layer_plan(cfg)
    named = {k: tree[k] for k in _TOP}
    for li in range(len(pro) + len(period) * repeats):
        leaf = _layer_tree(tree, len(pro), max(len(period), 1), li)
        named.update(_dotted(leaf, f"layers.{li}."))
    return named


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array (a copy); bfloat16 as ``ml_dtypes``'s,
    the reference's leaf type (the port's own checkpoints take tensors and
    never need it)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def whole(named: dict, model: Transformer) -> dict:
    """``named`` (the model's parameters, or the optimizer's master, mu or
    nu) with every leaf the rank holds a part of gathered onto the CPU
    over each axis that splits it, "model" then "data", and put in its
    place (``Split.assemble``): the leaves of the one-process model.  Off
    a mesh, ``named`` itself."""
    parts = sharded_leaves(model)
    out = {}
    for k, v in named.items():
        lay = parts.get(k)
        if lay is not None:
            dev = v.device
            for s in reversed(lay.splits):
                blocks = sharding.all_gather(v.to(dev), model.mesh, s.axis,
                                             dim=s.dim)
                v = s.assemble(blocks.chunk(s.n, dim=s.dim))
        out[k] = v
    return out


def params_to_reference(model: Transformer, cfg: ModelConfig) -> dict:
    """The model's weights as the reference's tree of numpy arrays, the
    inverse of ``params_from_reference``; on a mesh the sharded leaves
    are gathered (every rank of the mesh calls it)."""
    return _map(_numpy, reference_tree(
        whole(dict(model.named_parameters()), model), cfg))


def opt_state_to_reference(state: dict, cfg: ModelConfig,
                           model: Transformer | None = None) -> dict:
    """The port's optimizer state (``optim.init``: master, mu and nu by
    parameter name, an int32 step) as the reference's tree of numpy
    arrays; with ``model`` on a mesh, the sharded leaves' state is
    gathered."""
    tree = {k: reference_tree(state[k] if model is None
                              else whole(state[k], model), cfg)
            for k in ("master", "mu", "nu")}
    return _map(_numpy, {**tree, "step": state["step"]})


def opt_state_from_reference(tree: dict, cfg: ModelConfig, device=None,
                             model: Transformer | None = None) -> dict:
    """The reference's optimizer state (numpy arrays or tensors) as the
    port's, on ``device`` (default ``cuda:0``); with ``model`` on a mesh,
    the part of each leaf that the model holds (over "model" and "data":
    a rank keeps the optimizer state of its parts alone, ZeRO-3's
    saving)."""
    dev = _device(device)
    parts = {} if model is None else leaf_parts(model)
    state = {k: {name: _part(_tensor(v), name, parts)
                 .to(dev).contiguous()
                 for name, v in from_reference_tree(tree[k], cfg).items()}
             for k in ("master", "mu", "nu")}
    state["step"] = _tensor(tree["step"]).to(dev, torch.int32)
    return state
