"""PrIM MLP — Multilayer Perceptron inference (paper §4.9), the
counterpart of ``repro.prim.mlp``.

Each layer is the GEMV decomposition (§4.2): weight rows split across
banks, input vector broadcast.  Faithful to the paper, the host gathers the
layer output, reconstructs the full vector, and re-broadcasts it as the
next layer's input — that per-layer host round-trip is the "Inter-DPU" cost
that Fig. 13 shows shrinking with parallel transfers.  ReLU after every
layer.  The products are plain ``torch.matmul``, as the reference's are
``jnp`` products outside any Pallas kernel.  The registry compares MLP at
rtol = atol = 1e-4 against a float32 host product, so importing this module
turns TF32 off, as ``prim.gemv`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import transfer as tx
from repro_torch.core.banked import BankGrid
from .common import ChunkedWorkload, PhaseTimer, pad_chunks, register_chunked, sync

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def ref(weights: list[np.ndarray], x: np.ndarray) -> np.ndarray:
    """Each layer's product summed in float64 and rounded once to the
    layers' dtype, then the ReLU.  The reference sums in float32: at
    make_args scale 1024 the last layer sums 262,144 terms, and where an
    output nearly cancels, the float32 oracle and the card's float32 sum
    (in another order) differ by more than the registry's rtol = atol =
    1e-4 (0.0085 at an output of 57).  Rounded once, the oracle holds the
    exact value's float32 neighbour."""
    h = np.asarray(x)
    for w in weights:
        dtype = np.result_type(w, h)
        y = np.asarray(w, np.float64) @ np.asarray(h, np.float64)
        h = np.maximum(y.astype(dtype), 0)
    return h


def _layer(wb: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(wb @ hb, 0)


def pim(grid: BankGrid, weights: list[np.ndarray], x: np.ndarray):
    t = PhaseTimer()
    f = grid.bank_local(_layer)
    h = np.asarray(x)
    for li, w in enumerate(weights):
        with t.phase("inter_dpu" if li else "cpu_dpu"):
            wc, m = pad_chunks(w, grid.n_banks)
            dw = sync(grid.to_banks(wc))           # weight distribution
            dh = sync(grid.broadcast(h))           # input vector broadcast
        with t.phase("dpu"):
            out = sync(f(dw, dh))
        with t.phase("dpu_cpu"):
            h = grid.from_banks(out).reshape(-1)[:m]
    return h, t.times


# -- chunked phases (pipelined runtime) --------------------------------------
# The per-layer host round-trip of pim() would serialize the pipeline.  The
# chunked adaptation (DESIGN.md §4) keeps chunks independent by replicating
# the hidden layers: split broadcasts every non-final weight and enqueues
# the replicated hidden forward pass, then only the *final* layer's rows
# are chunked across banks.  The weight stack is the residency candidate
# (DESIGN.md §12): the hidden layers stay broadcast on the banks and the
# final layer's row chunks are the pipeline's chunks, so a warm hit pays
# only the input broadcast and the hidden forward pass per request.

def _split_resident(grid, n_chunks, weights):
    dws = [grid.broadcast(np.asarray(w)) for w in weights[:-1]]
    chunks, m = tx.split_chunks(np.asarray(weights[-1]), n_chunks)
    return {"m": m, "per": chunks[0].shape[0], "dws": dws}, chunks


def _split_varying(grid, n_chunks, res_meta, weights, x):
    h = grid.broadcast(np.asarray(x))
    for dw in res_meta["dws"]:
        h = _layer(dw, h)
    return {"m": res_meta["m"], "per": res_meta["per"], "dh": h}, None


def _split(grid, n_chunks, weights, x):
    res_meta, chunks = _split_resident(grid, n_chunks, weights)
    meta, _ = _split_varying(grid, n_chunks, res_meta, weights, x)
    return meta, chunks


def _scatter(grid, meta, chunk):
    wc, _ = pad_chunks(chunk, grid.n_banks)
    return grid.to_banks(wc)


def _compute(grid, meta, dw):
    return grid.bank_local(_layer)(dw, meta["dh"])


def _retrieve(grid, meta, out):
    return grid.from_banks(out).reshape(-1)[:meta["per"]]


def _merge(grid, meta, parts):
    return np.concatenate(parts)[:meta["m"]]


chunked = register_chunked(ChunkedWorkload(
    "MLP", _split, _scatter, _compute, _retrieve, _merge,
    resident_args=(0,), split_resident=_split_resident,
    split_varying=_split_varying))
