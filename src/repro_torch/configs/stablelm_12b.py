"""StableLM 2 12B — parallel attention∥FFN residual form
[hf:stabilityai/stablelm-2-12b]. 40L d5120 32H (GQA kv=8) d_ff 13824
vocab 100352."""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352, parallel_block=True,
)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=128, parallel_block=True,
    dtype=torch.float32, remat=False,
)
