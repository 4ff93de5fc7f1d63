"""H2O-Danube3 4B — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]. 24L d3840 32H (GQA kv=8) d_ff 10240 vocab 32000."""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000,
    window=4096,                       # Mistral-style SWA
)

SMOKE = ModelConfig(
    name="danube-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=128, window=16,
    dtype=torch.float32, remat=False,
)
