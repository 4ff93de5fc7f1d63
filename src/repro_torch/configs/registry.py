"""Architecture/shape registry — the counterpart of
``repro.configs.registry``: ``--arch <id>`` × the assigned input shapes.

Each arch module defines FULL (the exact public-literature config) and
SMOKE (a reduced same-family config for CPU tests); the modules are copies
of the reference's, with torch dtypes.  ``input_specs`` gives tensors on
the meta device as stand-ins for every model input (the reference's
``ShapeDtypeStruct``: shape and dtype, no memory), for the dry-run
(``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.layers import ModelConfig

ARCHS = [
    "jamba_1_5_large_398b", "h2o_danube_3_4b", "codeqwen1_5_7b",
    "stablelm_12b", "tinyllama_1_1b", "llama_3_2_vision_11b",
    "musicgen_medium", "xlstm_125m", "deepseek_moe_16b", "kimi_k2_1t_a32b",
]

ARCH_IDS = {a.replace("_", "-"): a for a in ARCHS}


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq: int
    batch: int
    kind: str        # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    norm = arch.replace(".", "_").replace("-", "_")
    if norm not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{norm}")
    return mod.SMOKE if smoke else mod.FULL


def is_subquadratic(cfg: ModelConfig) -> bool:
    """long_500k applicability: SSM / hybrid / sliding-window archs only."""
    return cfg.family in ("ssm", "hybrid") or cfg.window is not None


def skip_reason(cfg: ModelConfig, shape: Shape) -> str | None:
    if shape.name == "long_500k" and not is_subquadratic(cfg):
        return "SKIP(full-attention)"
    return None


def _spec(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: Shape) -> dict:
    """Meta-device stand-ins for every input of the traced step, the
    reference's keys, shapes and dtypes: tokens and labels int32, the
    audio family's ``embeds`` and the VLM family's ``frontend`` in
    ``cfg.dtype``; decode takes one new token (its cache comes from
    ``launch.serve.make_cache``)."""
    B, S = shape.batch, shape.seq
    i32 = torch.int32
    if shape.kind == "decode":
        if cfg.family == "audio":
            return {"embeds": _spec((B, 1, cfg.d_model), cfg.dtype)}
        return {"tokens": _spec((B, 1), i32)}
    if cfg.family == "audio":
        batch = {"embeds": _spec((B, S, cfg.d_model), cfg.dtype)}
    else:
        batch = {"tokens": _spec((B, S), i32)}
    if shape.kind == "train":
        batch["labels"] = _spec((B, S), i32)
    if cfg.family == "vlm":
        batch["frontend"] = _spec((B, cfg.n_frontend_tokens, cfg.d_model),
                                  cfg.dtype)
    return batch
