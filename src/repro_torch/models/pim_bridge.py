"""Model → PIM bridge — the PyTorch counterpart of
``repro.models.pim_bridge``: a decoder's per-layer matvec operands in the
banked layout the decode engine pins on the ranks.

Per token, every layer runs four attention projections (q/k/v/o) and the
two MLP halves (fused gate|up and down).  ``repro_torch.pim.decode``
routes exactly those six matvecs through the PrIM workloads ``GEMV-B``
(``W @ x + b``) and ``GEMV-G`` (the SwiGLU gated hidden); everything else
(norms, rope, KV append, attention softmax, lm_head) stays on the host.

Each projection becomes the row-major operand the GEMV decomposition
shards by output row: the model's ``(d_in, d_out)`` weight transposed once
to ``(d_out, d_in)``; a bias materialised (zeros when the arch has none);
the fused ``wi = gate|up`` split into its two ``(d_ff, d_model)`` halves.
Everything is float32 numpy on the host: token-exact parity with
``greedy_generate`` is only claimed for float32 weights.  The port's model
already holds its layers in order (``models/convert.py`` undid the
reference's stacked group), so layer ``li`` is ``model.layers[li]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .layers import ModelConfig
from .transformer import layer_plan


@dataclasses.dataclass(frozen=True)
class LayerWeights:
    """One decoder layer's PIM-side operands + host-side norm scales.

    ``q``/``k``/``v``/``o``/``down`` are GEMV-B pytrees ``{"w", "b"}``;
    ``gate_up`` is the GEMV-G pytree ``{"wg", "wu"}``.  Each is what the
    engine wraps in one ``ResidentHandle`` and pins as a unit.
    """

    q: dict
    k: dict
    v: dict
    o: dict
    gate_up: dict
    down: dict
    norm1: Any                 # (d,) host-side rms_norm scales (CPU tensor)
    norm2: Any


def validate_decode_config(cfg: ModelConfig) -> None:
    """Reject configs outside the decode engine's contract: anything that
    changes the block dataflow (parallel residual, MoE routing, SSM / xLSTM
    mixers, cross attention) or the numerics contract (non-float32
    weights) raises here, at construction."""
    if cfg.dtype != torch.float32:
        raise ValueError(
            f"decode engine requires float32 params for token-exact parity "
            f"with greedy_generate; {cfg.name} has dtype={cfg.dtype}")
    if cfg.parallel_block:
        raise ValueError(
            f"{cfg.name}: parallel_block (attn ∥ ffn off one norm) changes "
            "the residual dataflow — not supported by the decode engine")
    pro, period, _ = layer_plan(cfg)
    for li, desc in enumerate(pro + period):
        if desc["mixer"] != "attn":
            raise ValueError(
                f"{cfg.name} layer {li}: mixer {desc['mixer']!r} is not "
                "offloadable — the decode engine handles attention blocks "
                "only (mamba/xlstm/cross layers have no GEMV hot path)")
        if desc["ffn"] != "dense":
            raise ValueError(
                f"{cfg.name} layer {li}: ffn {desc['ffn']!r} — only the "
                "dense SwiGLU FFN maps onto GEMV-G/GEMV-B (MoE routing is "
                "token-dependent; 'none' has nothing to offload)")


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _rows(t: torch.Tensor) -> np.ndarray:
    """Transpose to the row-sharded (d_out, d_in) GEMV layout, contiguous
    so the per-chunk device pushes are single copies."""
    return np.ascontiguousarray(_f32(t).T)


def _bias(m: torch.nn.Module, name: str, n: int) -> np.ndarray:
    return _f32(getattr(m, name)) if hasattr(m, name) \
        else np.zeros(n, np.float32)


def extract_decode_weights(model, cfg: ModelConfig) -> list[LayerWeights]:
    """Per-layer PIM operands for every decoder layer, in layer order.
    Validates the config first."""
    validate_decode_config(cfg)
    d, hd = cfg.d_model, cfg.hd
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    layers = []
    for blk in model.layers:
        m = blk.mixer
        wi = _f32(blk.ffn.wi)                      # (d, 2f) fused gate|up
        f = wi.shape[1] // 2
        layers.append(LayerWeights(
            q={"w": _rows(m.wq), "b": _bias(m, "bq", H * hd)},
            k={"w": _rows(m.wk), "b": _bias(m, "bk", KVH * hd)},
            v={"w": _rows(m.wv), "b": _bias(m, "bv", KVH * hd)},
            o={"w": _rows(m.wo), "b": np.zeros(d, np.float32)},
            gate_up={"wg": np.ascontiguousarray(wi[:, :f].T),
                     "wu": np.ascontiguousarray(wi[:, f:].T)},
            down={"w": _rows(blk.ffn.wo), "b": np.zeros(d, np.float32)},
            norm1=blk.norm1.detach().cpu(), norm2=blk.norm2.detach().cpu()))
    return layers
