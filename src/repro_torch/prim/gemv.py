"""PrIM GEMV — Matrix-Vector Multiply (paper §4.2), the counterpart of
``repro.prim.gemv``.

Decomposition: consecutive matrix rows → DPU i (parallel transfer); the
input vector is broadcast once and every bank reads it; each bank
multiply-accumulates its rows; per-bank output chunks are retrieved and
concatenated by the host.  ``use_kernel=True`` runs the ``gemv`` kernel
over all banks in one launch; the default is a plain ``torch.matmul``, as
the reference leaves its default to XLA.

The registry compares GEMV at rtol = atol = 1e-4 against a float32 host
product.  TF32 keeps about three decimal digits, so importing this module
turns TF32 off for matmuls and cuDNN.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import transfer as tx
from repro_torch.core.banked import BankGrid
from repro_torch.kernels import ops
from .common import ChunkedWorkload, PhaseTimer, pad_chunks, register_chunked, sync

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def ref(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    return a @ x


def pim(grid: BankGrid, a: np.ndarray, x: np.ndarray, use_kernel: bool = False):
    t = PhaseTimer()
    with t.phase("cpu_dpu"):
        ac, m = pad_chunks(a, grid.n_banks)
        da = sync(grid.to_banks(ac))
        dx = sync(grid.broadcast(np.asarray(x)))

    def local(ab, xb):
        if use_kernel:
            return ops.gemv(ab, xb)
        return ab @ xb

    f = grid.bank_local(local)
    with t.phase("dpu"):
        out = sync(f(da, dx))
    with t.phase("dpu_cpu"):
        host = grid.from_banks(out).reshape(-1)[:m]
    return host, t.times


# -- chunked phases (pipelined runtime) --------------------------------------
# Row chunks pipeline through the banks; the input vector is broadcast once
# per request during split (it is a per-request constant, not a chunk).
# The matrix is the residency candidate (DESIGN.md §12): its row chunks are
# the pipeline's chunks, so a warm hit elides the scatter stage entirely and
# only the small vector broadcast remains per request.

def _split_resident(grid, n_chunks, a):
    chunks, m = tx.split_chunks(np.asarray(a), n_chunks)
    return {"m": m, "per": chunks[0].shape[0]}, chunks


def _split_varying(grid, n_chunks, res_meta, a, x):
    return {**res_meta, "dx": grid.broadcast(np.asarray(x))}, None


def _split(grid, n_chunks, a, x):
    res_meta, chunks = _split_resident(grid, n_chunks, a)
    meta, _ = _split_varying(grid, n_chunks, res_meta, a, x)
    return meta, chunks


def _scatter(grid, meta, chunk):
    ac, _ = pad_chunks(chunk, grid.n_banks)
    return grid.to_banks(ac)


def _compute(grid, meta, da):
    return grid.bank_local(lambda ab, xb: ab @ xb)(da, meta["dx"])


def _retrieve(grid, meta, out):
    return grid.from_banks(out).reshape(-1)[:meta["per"]]


def _merge(grid, meta, parts):
    return np.concatenate(parts)[:meta["m"]]


chunked = register_chunked(ChunkedWorkload(
    "GEMV", _split, _scatter, _compute, _retrieve, _merge,
    resident_args=(0,), split_resident=_split_resident,
    split_varying=_split_varying))
