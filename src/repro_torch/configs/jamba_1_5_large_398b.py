"""Jamba 1.5 Large — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]. 72L d8192 64H (GQA kv=8) d_ff 24576 vocab 65536."""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    moe_experts=16, moe_top_k=2, moe_every=2, dense_ff=24576,
    attn_every=8,                      # 1 attention layer per 8 (1:7)
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=128,
    moe_experts=4, moe_top_k=2, moe_every=2, dense_ff=128, moe_capacity_factor=8.0,
    attn_every=8,
    ssm_state=8, ssm_head_dim=16, ssm_expand=2, ssm_conv=4,
    dtype=torch.float32, remat=False,
)
