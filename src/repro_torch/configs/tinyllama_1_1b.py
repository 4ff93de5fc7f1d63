"""TinyLlama 1.1B — llama2-arch small [arXiv:2401.02385].
22L d2048 32H (GQA kv=4) d_ff 5632 vocab 32000."""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000,
)

SMOKE = ModelConfig(
    name="tinyllama-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=176, vocab=128,
    dtype=torch.float32, remat=False,
)
