"""Serving on one GPU — the PyTorch counterpart of ``repro.launch.serve``:
a decode cache, a decode step, and the simple batched greedy decoding loop.

The reference shards its decode cache over a TPU mesh (``cache_spec_for``,
``cache_specs``, the shardings of ``make_cache`` and ``make_serve_step``);
one GPU has no mesh, so those have no counterpart here (ROADMAP queue 1,
item 9) and the cache and step are plain closures over the model.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.layers import ModelConfig


def make_cache(model, cfg: ModelConfig, batch: int, max_len: int,
               frontend=None) -> dict:
    """A decode cache for ``batch`` streams of up to ``max_len`` tokens on
    the model's device; the VLM family's cross layers cache the keys and
    values of ``frontend`` (B, T, d)."""
    return transformer.init_cache(model, cfg, batch, max_len,
                                  frontend=frontend)


def make_serve_step(cfg: ModelConfig):
    """``step(model, cache, tokens=None, embeds=None, frontend=None)`` ->
    (logits (B, 1, V), cache): one ``transformer.decode_step``."""
    def step(model, cache, tokens=None, embeds=None, frontend=None):
        return transformer.decode_step(model, cfg, tokens, cache,
                                       embeds=embeds, frontend=frontend)
    return step


@torch.no_grad()
def greedy_generate(model, cfg: ModelConfig, prompt, max_new: int,
                    frontend=None) -> torch.Tensor:
    """Batched greedy decoding: the prompt is fed token by token through
    ``decode_step`` (the reference's schedule, ``serve.py:110-121``), then
    ``max_new`` tokens are picked by argmax.  ``prompt`` (B, S) int;
    ``frontend`` (B, T, d) the VLM family's image tokens, handed to the
    step only for that family, as the reference does; returns
    (B, S + max_new) int32 on the model's device."""
    prompt = transformer.as_tokens(prompt, model.device)
    frontend = transformer.as_frontend(frontend, model.device)
    B, S = prompt.shape
    cache = make_cache(model, cfg, B, S + max_new, frontend=frontend)
    step = make_serve_step(cfg)
    tok = prompt[:, :1]
    out = [tok]
    for i in range(S + max_new - 1):
        logits, cache = step(model, cache, tok, None,
                             frontend if cfg.family == "vlm" else None)
        if i + 1 < S:
            tok = prompt[:, i + 1:i + 2]
        else:
            tok = logits[:, -1:, :].argmax(dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)
