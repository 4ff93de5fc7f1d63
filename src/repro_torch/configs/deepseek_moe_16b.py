"""DeepSeekMoE 16B — 2 shared + 64 routed top-6 fine-grained experts
[arXiv:2401.06066]. 28L d2048 16H (kv=16, MHA) expert d_ff 1408
vocab 102400; layer 0 dense (d_ff 10944)."""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    moe_experts=64, moe_top_k=6, moe_shared_experts=2,
    moe_first_dense=True, dense_ff=10944,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=48, vocab=128,
    moe_experts=8, moe_top_k=2, moe_shared_experts=2,
    moe_first_dense=True, dense_ff=128, moe_capacity_factor=8.0,
    dtype=torch.float32, remat=False,
)
