"""MusicGen Medium — decoder-only over EnCodec tokens [arXiv:2306.05284].
48L d1536 24H (kv=24, MHA) d_ff 6144 vocab 2048.  The EnCodec frontend is a
STUB: input_specs() supplies precomputed frame embeddings (B, S, d_model);
labels are EnCodec codebook token ids."""
import torch

from repro_torch.models.layers import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048,
)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=6,
    d_ff=96, vocab=64,
    dtype=torch.float32, remat=False,
)
