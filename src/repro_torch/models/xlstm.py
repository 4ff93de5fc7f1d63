"""xLSTM blocks (arXiv:2405.04517) — the PyTorch counterpart of
``repro.models.xlstm``: mLSTM (matrix memory, parallel form) and sLSTM
(scalar memory, recurrent form), the mixers of the ``ssm`` family
(xlstm-125m: mLSTM blocks with an sLSTM every ``cfg.slstm_every``-th
layer, no FFN).

mLSTM parallel form (prefill):
  F_t = Σ_{τ≤t} logσ(f_τ);  D[t,s] = exp(F_t − F_s + i_s − m_t), s ≤ t
  y_t = Σ_s D[t,s] (q_t·k_s) v_s / max(|Σ_s D (q·k)|, exp(−m_t))
``apply_mlstm_chunked`` is the same function in O(S·L): the parallel form
inside each chunk of L, and the chunks' (C, n, m) summaries combined in
chunk order with the reference's stabilised ``combine`` (the reference
runs it under ``lax.associative_scan``; a loop over the chunk axis
combines the same terms, in float32).  Decode keeps (C, n, m) per head:
O(1) a token.

sLSTM: the stabilised exponential-gating scalar recurrence; the
reference's ``lax.scan`` over time is a Python loop over the sequence.

The rounding points are the reference's: ``x @ w`` in the model dtype,
then float32 for the gate logits; silu in float32, cast back before
``* u``; the ``-1e30`` start of ``m``; ``log_sigmoid`` in float32.  The
query's ``/ sqrt(hd)``: the reference divides by a numpy float64 scalar,
which jnp does not treat as weakly typed, so a bfloat16 query comes out
float32 (every use casts it to float32 anyway); here it is divided in
float32 too.  No Pallas kernel runs here in the reference, and none runs
here.  Parameters are named as the reference's keys.

Tensor parallelism (``tp``, the "model" axis of M ranks): an mLSTM rank
holds the reference's contiguous block r of the columns of ``wq`` /
``wk`` / ``wv`` / ``wz`` and the same rows of ``wo``, wherever a head
falls (``mlstm_split``), and ``wi`` / ``wf`` / ``norm`` whole, of which
it uses the touched heads' and its own columns' part through
``copy_to``.  Where its columns cut a head it gathers q and k over
"model" and keeps the touched heads whole (q·k, n and q·n sum over the
whole head), and keeps only its own columns of v
(``layers.padded_layout``): its output's columns are (w / norm) @ v[:,
own], and its decode state C is (B, heads, hd, own columns), n and m
whole for the touched heads.
The norm over d sums its squares over the ranks in both directions, and
``wo``'s partial sums are added.  The sLSTM recurrence runs whole on
every rank; its ``up`` holds the rank's block of each half (g | u) and it
multiplies by its rows of ``down`` (held whole, used through
``copy_to``), the partial sums added.  Under FSDP (``fs``, the "data"
axis) the rank holds its block of the d rows of every mLSTM weight but
``wo`` (its d columns) and of every sLSTM weight but ``down`` (its d
columns), which each call gathers (``layers.gathered``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.sharding import SOLO, Group, P
from .layers import (HeadSplit, ModelConfig, _param, build, emb_axis,
                     gather_blocks, gathered, head_split, own_columns,
                     pad_heads, padded_layout, rms_norm, rms_norm_parts)

#: the start of the stabiliser m (the reference's)
M_START = -1e30


def _dims(cfg: ModelConfig):
    H = cfg.n_heads
    return H, cfg.d_model // H


def _weights(module: nn.Module, shapes: dict, specs: dict,
             cfg: ModelConfig, gen: torch.Generator | None, device,
             tp: Group, fs: Group) -> None:
    """Each weight drawn from ``gen`` (the reference's scheme) in the
    reference's key order, or left uninitialised for a weight carry, the
    rank's part on ``tp`` and ``fs``; then ``norm``, ones."""
    build(module, shapes, specs, cfg.dtype, gen, device, tp, fs)
    module.norm = _param(torch.ones(cfg.d_model, dtype=cfg.dtype,
                                    device=device))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wz``, ``wo`` (d, d); ``wi``, ``wf`` (d, H),
    the input and forget gates' logits; ``norm`` (d,).  ``split``: the
    rank's ``layers.HeadSplit`` of the d columns; ``v_layout``: how its
    own columns of v lie in its touched heads (``layers.padded_layout``)."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator | None = None,
                 device=None, tp: Group = SOLO, fs: Group = SOLO):
        super().__init__()
        d = cfg.d_model
        H, _ = _dims(cfg)
        _weights(self, {"wq": (d, d), "wk": (d, d), "wv": (d, d),
                        "wi": (d, H), "wf": (d, H), "wz": (d, d),
                        "wo": (d, d)}, mlstm_specs(cfg), cfg, gen, device, tp,
                 fs)
        self.split = mlstm_split(cfg, tp.size, tp.index)
        self.v_layout = padded_layout(self.split)


def mlstm_specs(cfg: ModelConfig) -> dict:
    """The reference's specs of the mLSTM's weights (its ``init_mlstm``)."""
    e = emb_axis(cfg.fsdp)
    return {"wq": P(e, "model"), "wk": P(e, "model"), "wv": P(e, "model"),
            "wi": P(e, None), "wf": P(e, None), "wz": P(e, "model"),
            "wo": P("model", e), "norm": P(None)}


def mlstm_split(cfg: ModelConfig, m: int = 1, r: int = 0) -> HeadSplit:
    """Rank ``r`` of ``m``'s block of the d columns of ``wq`` / ``wk`` /
    ``wv`` / ``wz`` and the heads it touches."""
    H, hd = _dims(cfg)
    return head_split(H, hd, m, r)


def _mlstm_heads(p: MLSTM, cfg: ModelConfig, x: torch.Tensor):
    """q (float32, scaled), k (B, heads, S, hd); v (B, heads, S, w) (the
    rank's own columns of each touched head, ``layers.padded_layout``);
    i, f (B, heads, S) float32 — of the replicated ``x`` (which enters
    through ``copy_to``).  q and k of the touched heads are gathered whole over
    "model" where the rank's columns cut a head (q·k, n and q·n sum over
    the whole head); v stays the rank's own."""
    B, S, _ = x.shape
    H, hd = _dims(cfg)
    sp, tp = p.split, p.tp
    q, k = x @ p.wq, x @ p.wk
    if not sp.whole:
        cols = slice(sp.heads.start * hd, sp.heads.stop * hd)
        q, k = (t[..., cols] for t in gather_blocks(tp, [q, k]))
    q, k = (t.reshape(B, S, sp.n, hd).transpose(1, 2) for t in (q, k))
    q = q.to(torch.float32) / math.sqrt(hd)
    v = pad_heads(x @ p.wv, p.v_layout).transpose(1, 2)
    i, f = ((x @ tp.copy_to(g)[:, sp.heads]).to(torch.float32)
            .transpose(1, 2) for g in (p.wi, p.wf))
    return q, k, v, i, f


def _out(p, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The output gate and projection: y (B, S, heads · w) float32, the
    rank's columns of its touched heads (``layers.padded_layout``); the
    ranks' partial sums added."""
    tp = p.tp
    y = own_columns(y, p.v_layout).to(x.dtype)
    z = F.silu((x @ p.wz).to(torch.float32)).to(x.dtype)
    o = rms_norm_parts(y * z, tp.part(p.norm, 0), x.shape[-1], tp) @ p.wo
    return tp.reduce_from(o)


def _causal(n: int, device) -> torch.Tensor:
    return torch.ones((n, n), dtype=torch.bool, device=device).tril()


def apply_mlstm(p: MLSTM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The parallel form, O(S²). x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    p = gathered(p)
    x = p.tp.copy_to(x)
    q, k, v, i, f = _mlstm_heads(p, cfg, x)
    F_ = torch.cumsum(F.logsigmoid(f), dim=-1)                  # (B, H, S)
    dmat = F_[..., :, None] - F_[..., None, :] + i[..., None, :]
    dmat = dmat.masked_fill(~_causal(S, x.device), float("-inf"))
    m = dmat.amax(dim=-1, keepdim=True)                          # (B,H,S,1)
    dexp = torch.exp(dmat - m)
    w = (q @ k.to(torch.float32).transpose(-1, -2)) * dexp
    norm = torch.maximum(w.sum(-1, keepdim=True).abs(), torch.exp(-m))
    y = (w / norm) @ v.to(torch.float32)
    return _out(p, x, y.transpose(1, 2).reshape(B, S, -1))


def _combine(a, b):
    """The reference's stabilised combine of two chunk summaries
    (f, m, C, n), ``a`` before ``b``."""
    fa, ma, ca, na = a
    fb, mb, cb, nb = b
    m = torch.maximum(ma + fb, mb)
    sa = torch.exp(ma + fb - m)[..., None]
    sb = torch.exp(mb - m)[..., None]
    return fa + fb, m, sa[..., None] * ca + sb[..., None] * cb, \
        sa * na + sb * nb


def apply_mlstm_chunked(p: MLSTM, cfg: ModelConfig, x: torch.Tensor,
                        chunk: int = 256) -> torch.Tensor:
    """The same function in O(S·L), L = min(chunk, S), which must divide
    S: the parallel form within a chunk plus the state carried in from
    the chunks before it."""
    B, S, d = x.shape
    L = min(chunk, S)
    assert S % L == 0, f"chunk {L} must divide the sequence {S}"
    nc = S // L
    p = gathered(p)
    x = p.tp.copy_to(x)
    q, k, v, i, f = _mlstm_heads(p, cfg, x)
    H = q.shape[1]
    qf, kf, vf = (t.to(torch.float32).reshape(B, H, nc, L, t.shape[-1])
                  for t in (q, k, v))
    i = i.reshape(B, H, nc, L)
    logf = F.logsigmoid(f).reshape(B, H, nc, L)

    floc = torch.cumsum(logf, dim=-1)                            # (B,H,nc,L)
    fsum = floc[..., -1:]                                        # (B,H,nc,1)
    # each chunk's summary: its contribution to the state on its own
    w_state = fsum - floc + i
    m_seg = w_state.amax(dim=-1)                                 # (B,H,nc)
    wexp = torch.exp(w_state - m_seg[..., None])
    c_seg = torch.einsum("bhcl,bhcld,bhcle->bhcde", wexp, kf, vf)
    n_seg = torch.einsum("bhcl,bhcld->bhcd", wexp, kf)

    # the state before each chunk: identity at chunk 0, then the inclusive
    # combine of the chunks before it
    m_in = [torch.full_like(m_seg[..., 0], M_START)]
    c_in = [torch.zeros_like(c_seg[:, :, 0])]
    n_in = [torch.zeros_like(n_seg[:, :, 0])]
    acc = None
    for c in range(nc - 1):
        seg = (fsum[:, :, c, 0], m_seg[:, :, c], c_seg[:, :, c],
               n_seg[:, :, c])
        acc = seg if acc is None else _combine(acc, seg)
        m_in.append(acc[1])
        c_in.append(acc[2])
        n_in.append(acc[3])
    m_in = torch.stack(m_in, dim=2)                              # (B,H,nc)
    c_in = torch.stack(c_in, dim=2)                          # (B,H,nc,hd,hd)
    n_in = torch.stack(n_in, dim=2)                              # (B,H,nc,hd)

    # within-chunk parallel outputs plus the carried-in state's
    dmat = floc[..., :, None] - floc[..., None, :] + i[..., None, :]
    dmat = dmat.masked_fill(~_causal(L, x.device), float("-inf"))
    m_loc = dmat.amax(dim=-1)                                    # (B,H,nc,L)
    carry_w = floc + m_in[..., None]
    m_t = torch.maximum(m_loc, carry_w)
    dexp = torch.exp(dmat - m_t[..., None])
    wgt = (qf @ kf.transpose(-1, -2)) * dexp                     # (B,H,nc,L,L)
    carry_s = torch.exp(carry_w - m_t)
    num = wgt @ vf + carry_s[..., None] * (qf @ c_in)
    den = wgt.sum(-1) + carry_s * torch.einsum("bhcld,bhcd->bhcl", qf, n_in)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    return _out(p, x, h.reshape(B, H, S, -1).transpose(1, 2)
                .reshape(B, S, -1))


def init_mlstm_cache(cfg: ModelConfig, batch: int, device=None,
                     m: int = 1, r: int = 0) -> dict:
    """(C, n, m) of the heads that rank ``r`` of ``m`` touches: C (B,
    heads, hd, w) holds the rank's own columns of v
    (``layers.padded_layout``), n (B, heads, hd) and m (B, heads) whole."""
    sp = mlstm_split(cfg, m, r)
    n, w = sp.n, padded_layout(sp)[0]
    return {"C": torch.zeros((batch, n, sp.hd, w), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, n, sp.hd), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, n), M_START, dtype=torch.float32,
                            device=device)}


def decode_mlstm(p: MLSTM, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """One token. x: (B, 1, d); returns (y, new cache)."""
    B = x.shape[0]
    p = gathered(p)
    x = p.tp.copy_to(x)
    q, k, v, i, f = _mlstm_heads(p, cfg, x)                      # S = 1
    q, k, v = (t[:, :, 0].to(torch.float32) for t in (q, k, v))
    i, f = i[..., 0], f[..., 0]                                  # (B, H)
    logf = F.logsigmoid(f)
    m_new = torch.maximum(logf + cache["m"], i)
    fg = torch.exp(logf + cache["m"] - m_new)[..., None]
    ig = torch.exp(i - m_new)[..., None]
    C = fg[..., None] * cache["C"] + ig[..., None] * \
        (k[..., :, None] * v[..., None, :])
    n = fg * cache["n"] + ig * k
    num = (q[..., None, :] @ C)[..., 0, :]
    den = torch.maximum((q * n).sum(-1).abs(), torch.exp(-m_new))[..., None]
    y = (num / den).reshape(B, 1, -1)
    return _out(p, x, y), {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """``wz``, ``wi``, ``wf``, ``wo_gate`` (d, d), the gates' logits;
    ``up`` (d, 2d) fused gate|up and ``down`` (d, d); ``norm`` (d,)."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator | None = None,
                 device=None, tp: Group = SOLO, fs: Group = SOLO):
        super().__init__()
        d = cfg.d_model
        _weights(self, {"wz": (d, d), "wi": (d, d), "wf": (d, d),
                        "wo_gate": (d, d), "up": (d, 2 * d),
                        "down": (d, d)}, slstm_specs(cfg), cfg, gen, device,
                 tp, fs)


def slstm_specs(cfg: ModelConfig) -> dict:
    """The reference's specs of the sLSTM's weights (its ``init_slstm``)."""
    e = emb_axis(cfg.fsdp)
    return {"wz": P(e, None), "wi": P(e, None), "wf": P(e, None),
            "wo_gate": P(e, None), "up": P(e, "model"),
            "down": P(None, e), "norm": P(None)}


def _slstm_step(carry, gates):
    """One step of the recurrence on float32 (B, d) states and gates;
    returns (new carry, h)."""
    c, n, m = carry
    z, i, f, o = gates
    logf = F.logsigmoid(f)
    m_new = torch.maximum(logf + m, i)
    fg = torch.exp(logf + m - m_new)
    ig = torch.exp(i - m_new)
    c = fg * c + ig * torch.tanh(z)
    n = fg * n + ig
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1e-6)
    return (c, n, m_new), h


def _slstm_gates(p: SLSTM, x: torch.Tensor):
    return tuple((x @ w).to(torch.float32)
                 for w in (p.wz, p.wi, p.wf, p.wo_gate))


def _slstm_out(p: SLSTM, h: torch.Tensor) -> torch.Tensor:
    """The norm and the up / down FFN of the replicated ``h``: the rank's
    block of each half of ``up``, its rows of ``down``, the partial sums
    added."""
    tp = p.tp
    h = tp.copy_to(rms_norm(h, p.norm))
    g, u = (h @ p.up).chunk(2, dim=-1)
    y = (F.silu(g.to(torch.float32)).to(h.dtype) * u) @ tp.part(p.down, 0)
    return tp.reduce_from(y)


def apply_slstm(p: SLSTM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), one recurrence step a position."""
    B, S, d = x.shape
    p = gathered(p)
    gates = _slstm_gates(p, x)
    carry = tuple(init_slstm_cache(cfg, B, device=x.device).values())
    hs = []
    for t in range(S):
        carry, h = _slstm_step(carry, tuple(g[:, t] for g in gates))
        hs.append(h)
    return _slstm_out(p, torch.stack(hs, dim=1).to(x.dtype))


def init_slstm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    d = cfg.d_model
    return {"c": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "m": torch.full((batch, d), M_START, dtype=torch.float32,
                            device=device)}


def decode_slstm(p: SLSTM, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """One token. x: (B, 1, d); returns (y, new cache)."""
    p = gathered(p)
    gates = _slstm_gates(p, x[:, 0])
    (c, n, m), h = _slstm_step((cache["c"], cache["n"], cache["m"]), gates)
    return _slstm_out(p, h[:, None, :].to(x.dtype)), {"c": c, "n": n, "m": m}
