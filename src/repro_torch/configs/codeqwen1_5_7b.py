"""CodeQwen1.5 7B — qwen1.5 arch, MHA with QKV bias
[hf:Qwen/CodeQwen1.5-7B]. 32L d4096 32H (kv=32) d_ff 13440 vocab 92416."""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416, qkv_bias=True,
)

SMOKE = ModelConfig(
    name="codeqwen-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab=128, qkv_bias=True,
    dtype=torch.float32, remat=False,
)
