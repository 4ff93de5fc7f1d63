"""Llama 3.2 Vision 11B — text backbone with cross-attention image layers
every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision]. 40L d4096 32H (GQA
kv=8) d_ff 14336 vocab 128256.  Vision frontend is a STUB: input_specs()
supplies precomputed patch embeddings (B, 1600, d_model)."""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    cross_attn_every=5, n_frontend_tokens=1600,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=128,
    cross_attn_every=5, n_frontend_tokens=16,
    dtype=torch.float32, remat=False,
)
