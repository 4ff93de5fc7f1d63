"""Architecture/shape registry — the counterpart of
``repro.configs.registry``: ``--arch <id>`` × the assigned input shapes.

Each arch module defines FULL (the exact public-literature config) and
SMOKE (a reduced same-family config for CPU tests); the modules are copies
of the reference's, with torch dtypes.  The reference's ``input_specs``
builds JAX ``ShapeDtypeStruct`` stand-ins for its dry-run and is not
ported yet: it comes with the dry-run (ROADMAP queue 1, item 9.8).
"""
from __future__ import annotations

import dataclasses
import importlib

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


# input_specs (the reference's JAX ShapeDtypeStruct stand-ins for its
# dry-run) is not ported yet: it comes with the dry-run (ROADMAP queue 1,
# item 9.8).
