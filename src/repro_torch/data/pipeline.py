"""Data pipeline: deterministic, stateless-seekable synthetic token stream
— the port's copy of ``repro.data.pipeline`` (numpy only, so the batches
are the reference's, byte for byte; ``launch.train.to_device`` puts them
on the card).

Production framing: every batch is a pure function of (seed, step), so a
restarted/elastically-resized job regenerates exactly the batches it would
have seen — no loader state in checkpoints, no sample loss on failure
(DESIGN.md §6 fault-tolerance).  Host-side numpy generation feeds the
copies to the device.

The synthetic distribution is a Zipf-ish unigram stream with short-range
correlation, which keeps the CE losses of smoke runs meaningful (learnable
but not degenerate).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.layers import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq: int = 128


def _rng_for(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def make_batch(cfg: ModelConfig, dc: DataConfig, step: int) -> dict:
    """Deterministic batch for ``step``: {"tokens"/"embeds", "labels"[, "frontend"]}."""
    rng = _rng_for(dc.seed, step)
    B, S, V = dc.batch, dc.seq, cfg.vocab
    # zipf unigram with local repeats
    base = rng.zipf(1.5, size=(B, S + 1)) % V
    rep = rng.random((B, S + 1)) < 0.3
    seq = base.copy()
    seq[:, 1:][rep[:, 1:]] = seq[:, :-1][rep[:, 1:]]
    seq = seq.astype(np.int32)
    batch: dict = {"labels": seq[:, 1:]}
    if cfg.family == "audio":
        # frontend stub: frame embeddings from a fixed random codebook
        code_rng = np.random.default_rng(dc.seed + 7)
        book = code_rng.normal(size=(V, cfg.d_model)).astype(np.float32) * 0.02
        batch["embeds"] = book[seq[:, :-1]]
    else:
        batch["tokens"] = seq[:, :-1]
    if cfg.family == "vlm":
        batch["frontend"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32) \
            * 0.02
    return batch


class Loader:
    """Iterator facade; entirely derived state (seekable by construction)."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig, start_step: int = 0):
        self.cfg, self.dc, self.step = cfg, dc, start_step

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = make_batch(self.cfg, self.dc, self.step)
        self.step += 1
        return b
