"""Fused GEMV variants for the LLM decode hot path — the counterpart of
``repro.prim.gemv_fused``.

The decode engine (``repro_torch.pim.decode``) routes every per-token
matvec — attention q/k/v/o projections and the MLP up/down halves —
through these two workloads.  Both follow GEMV's decomposition (paper
§4.2: consecutive output rows → DPU i, activation vector broadcast), but
fuse the epilogue the model would otherwise run on the host:

* ``GEMV-B`` — ``y = W @ x + b``.  The resident operand is the pytree
  ``{"w": (n, d), "b": (n,)}``; a layer without a bias passes zeros.
* ``GEMV-G`` — ``y = silu(Wg @ x) * (Wu @ x)``, the SwiGLU gated hidden,
  both halves' rows sharded together so an output element's gate and up
  rows sit on one bank.  The silu runs in float32 and casts back, as
  ``models.layers.swiglu`` does.

As in the reference, the bank-local phases are plain matvecs over the
bank axis (``torch.matmul``), not the ``gemv`` kernel.  Row chunks are the
pipeline's chunks and the residency chunks, so a warm decode step
scatters only the activation vector.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import transfer as tx
from repro_torch.core.banked import BankGrid
from .common import ChunkedWorkload, PhaseTimer, pad_chunks, register_chunked, sync


def _silu_f32(g: torch.Tensor) -> torch.Tensor:
    """silu in float32, cast back — the swiglu gate's exact numerics."""
    return F.silu(g.to(torch.float32)).to(g.dtype)


def _local_b(wb, bb, xb):
    return wb @ xb + bb


def _local_g(gb, ub, xb):
    return _silu_f32(gb @ xb) * (ub @ xb)


# -- GEMV-B: y = W @ x + b ----------------------------------------------------

def ref_b(w: dict, x: np.ndarray) -> np.ndarray:
    return w["w"] @ x + w["b"]


def pim_b(grid: BankGrid, w: dict, x: np.ndarray):
    t = PhaseTimer()
    with t.phase("cpu_dpu"):
        wc, m = pad_chunks(w["w"], grid.n_banks)
        bc, _ = pad_chunks(w["b"], grid.n_banks)
        dw = sync(grid.to_banks(wc))
        db = sync(grid.to_banks(bc))
        dx = sync(grid.broadcast(np.asarray(x)))
    f = grid.bank_local(_local_b)
    with t.phase("dpu"):
        out = sync(f(dw, db, dx))
    with t.phase("dpu_cpu"):
        host = grid.from_banks(out).reshape(-1)[:m]
    return host, t.times


def _split_resident_b(grid, n_chunks, w):
    wch, m = tx.split_chunks(np.asarray(w["w"]), n_chunks)
    bch, _ = tx.split_chunks(np.asarray(w["b"]), n_chunks)
    chunks = [{"w": wc, "b": bc} for wc, bc in zip(wch, bch)]
    return {"m": m, "per": wch[0].shape[0]}, chunks


def _split_varying(grid, n_chunks, res_meta, w, x):
    return {**res_meta, "dx": grid.broadcast(np.asarray(x))}, None


def _split_b(grid, n_chunks, w, x):
    res_meta, chunks = _split_resident_b(grid, n_chunks, w)
    meta, _ = _split_varying(grid, n_chunks, res_meta, w, x)
    return meta, chunks


def _scatter_b(grid, meta, chunk):
    wc, _ = pad_chunks(chunk["w"], grid.n_banks)
    bc, _ = pad_chunks(chunk["b"], grid.n_banks)
    return grid.to_banks(wc), grid.to_banks(bc)


def _compute_b(grid, meta, bufs):
    dw, db = bufs
    return grid.bank_local(_local_b)(dw, db, meta["dx"])


def _retrieve(grid, meta, out):
    return grid.from_banks(out).reshape(-1)[:meta["per"]]


def _merge(grid, meta, parts):
    return np.concatenate(parts)[:meta["m"]]


chunked_b = register_chunked(ChunkedWorkload(
    "GEMV-B", _split_b, _scatter_b, _compute_b, _retrieve, _merge,
    resident_args=(0,), split_resident=_split_resident_b,
    split_varying=_split_varying))


# -- GEMV-G: y = silu(Wg @ x) * (Wu @ x) --------------------------------------

def ref_g(w: dict, x: np.ndarray) -> np.ndarray:
    """The gated hidden with each matvec summed in float64 and rounded
    once.  The reference sums them in float32, and its product amplifies
    that rounding: silu(g) multiplies u's error, so where u nearly cancels
    the float32 oracle misses the exact value by more than the registry's
    rtol = atol = 1e-4 (at scale 1024, by 1.08e-4 where y = -0.043 and
    silu(g) = 24).  Rounded once, the oracle holds every float32 order of
    summation, the card's included, to that tolerance."""
    dtype = np.result_type(w["wg"], x)
    x64 = np.asarray(x, np.float64)
    g = (np.asarray(w["wg"], np.float64) @ x64).astype(dtype)
    u = (np.asarray(w["wu"], np.float64) @ x64).astype(dtype)
    return (_silu_f32(torch.from_numpy(g)) * torch.from_numpy(u)).numpy()


def pim_g(grid: BankGrid, w: dict, x: np.ndarray):
    t = PhaseTimer()
    with t.phase("cpu_dpu"):
        gc, m = pad_chunks(w["wg"], grid.n_banks)
        uc, _ = pad_chunks(w["wu"], grid.n_banks)
        dg = sync(grid.to_banks(gc))
        du = sync(grid.to_banks(uc))
        dx = sync(grid.broadcast(np.asarray(x)))
    f = grid.bank_local(_local_g)
    with t.phase("dpu"):
        out = sync(f(dg, du, dx))
    with t.phase("dpu_cpu"):
        host = grid.from_banks(out).reshape(-1)[:m]
    return host, t.times


def _split_resident_g(grid, n_chunks, w):
    gch, m = tx.split_chunks(np.asarray(w["wg"]), n_chunks)
    uch, _ = tx.split_chunks(np.asarray(w["wu"]), n_chunks)
    chunks = [{"wg": gc, "wu": uc} for gc, uc in zip(gch, uch)]
    return {"m": m, "per": gch[0].shape[0]}, chunks


def _split_g(grid, n_chunks, w, x):
    res_meta, chunks = _split_resident_g(grid, n_chunks, w)
    meta, _ = _split_varying(grid, n_chunks, res_meta, w, x)
    return meta, chunks


def _scatter_g(grid, meta, chunk):
    gc, _ = pad_chunks(chunk["wg"], grid.n_banks)
    uc, _ = pad_chunks(chunk["wu"], grid.n_banks)
    return grid.to_banks(gc), grid.to_banks(uc)


def _compute_g(grid, meta, bufs):
    dg, du = bufs
    return grid.bank_local(_local_g)(dg, du, meta["dx"])


chunked_g = register_chunked(ChunkedWorkload(
    "GEMV-G", _split_g, _scatter_g, _compute_g, _retrieve, _merge,
    resident_args=(0,), split_resident=_split_resident_g,
    split_varying=_split_varying))
