"""Kimi K2 — trillion-param MoE, paper-table config [arXiv:2501.kimi2].
61L d7168 64H (GQA kv=8 — as assigned; real K2 uses MLA, see DESIGN.md
§Arch-applicability) expert d_ff 2048, 384 routed top-8 + 1 shared,
vocab 163840; layer 0 dense (d_ff 18432)."""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840,
    moe_experts=384, moe_top_k=8, moe_shared_experts=1,
    moe_first_dense=True, dense_ff=18432,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="kimi-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab=128,
    moe_experts=16, moe_top_k=4, moe_shared_experts=1,
    moe_first_dense=True, dense_ff=96, moe_capacity_factor=8.0,
    dtype=torch.float32, remat=False,
)
