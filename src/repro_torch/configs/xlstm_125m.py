"""xLSTM 125M — sLSTM + mLSTM blocks [arXiv:2405.04517].
12L d768 4H d_ff=0 (block-internal projections only) vocab 50304.
sLSTM every 4th layer, mLSTM otherwise."""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, slstm_every=4,
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab=128, slstm_every=4,
    dtype=torch.float32, remat=False,
)
