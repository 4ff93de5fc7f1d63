"""Weight carry: the reference's parameter tree, as numpy arrays, into the
port's model with the same numbers.

The reference keeps the blocks before the repeating group as a
``prologue`` list and stacks the group's blocks leaf-wise along a leading
repeat axis (``jax.vmap`` of the block init), so global layer ``li`` is
``group[pos][leaf][r]`` with ``(r, pos) = divmod(li - n_prologue,
period_len)`` — the indexing of ``repro.models.pim_bridge._layer_params``.
Both packages store weights as ``(d_in, d_out)``, so every leaf is a copy,
never a transpose.  A caller holding the reference's jax arrays passes
``jax.tree.map(np.asarray, params)``; this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import ModelConfig
from .transformer import Transformer, layer_plan


def _tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor (a copy); bfloat16 (``ml_dtypes``) by
    its bits."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _take(tree, r: int):
    """Index every leaf of ``tree`` at ``r`` on its leading axis."""
    if isinstance(tree, dict):
        return {k: _take(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def _layer_tree(tree: dict, n_prologue: int, period_len: int, li: int):
    if li < n_prologue:
        return tree["prologue"][li]
    r, pos = divmod(li - n_prologue, period_len)
    return _take(tree["group"][pos], r)


def _load(module: torch.nn.Module, tree: dict, where: str) -> None:
    """Copy ``tree``'s leaves into ``module``'s parameters of the same
    dotted names; the two must hold the same names, shapes and dtypes."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = v

    walk(tree, "")
    params = dict(module.named_parameters())
    if set(flat) != set(params):
        raise ValueError(f"{where}: reference leaves {sorted(flat)} != port "
                         f"parameters {sorted(params)}")
    for name, p in params.items():
        src = _tensor(flat[name])
        if src.shape != p.shape or src.dtype != p.dtype:
            raise ValueError(f"{where}.{name}: reference {tuple(src.shape)} "
                             f"{src.dtype}, port {tuple(p.shape)} {p.dtype}")
        with torch.no_grad():
            p.copy_(src)


def params_from_reference(tree: dict, cfg: ModelConfig,
                          device=None) -> Transformer:
    """The port's model on ``device`` (default ``cuda:0``) holding the
    reference's weights ``tree`` (numpy leaves) for ``cfg``."""
    model = Transformer(cfg, device=device)
    pro, period, _ = layer_plan(cfg)
    top = {k: tree[k] for k in ("embed", "final_norm", "lm_head")}
    with torch.no_grad():
        for k, v in top.items():
            getattr(model, k).copy_(_tensor(v))
    for li, blk in enumerate(model.layers):
        _load(blk, _layer_tree(tree, len(pro), max(len(period), 1), li),
              f"layer {li}")
    return model
