"""PrIM VA — Vector Addition (paper §4.1), the counterpart of
``repro.prim.va``.

Decomposition: vectors a, b split into equal chunks (chunk i → DPU i) via
parallel CPU→DPU transfer; each bank adds its chunk locally, all banks in
one elementwise launch; results retrieved in parallel.  No inter-DPU phase.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import transfer as tx
from repro_torch.core.banked import BankGrid
from .common import ChunkedWorkload, PhaseTimer, pad_chunks, register_chunked, sync


def ref(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a + b


def _add(xb, yb):
    return xb + yb


def pim(grid: BankGrid, a: np.ndarray, b: np.ndarray):
    t = PhaseTimer()
    with t.phase("cpu_dpu"):
        ac, n = pad_chunks(a, grid.n_banks)
        bc, _ = pad_chunks(b, grid.n_banks)
        da = sync(grid.to_banks(ac))
        db = sync(grid.to_banks(bc))
    local = grid.bank_local(_add)
    with t.phase("dpu"):
        out = sync(local(da, db))
    with t.phase("dpu_cpu"):
        host = grid.from_banks(out).reshape(-1)[:n]
    return host, t.times


# -- chunked phases (pipelined runtime) --------------------------------------

def _split(grid, n_chunks, a, b):
    ac, n = tx.split_chunks(np.asarray(a), n_chunks)
    bc, _ = tx.split_chunks(np.asarray(b), n_chunks)
    return {"n": n, "per": ac[0].shape[0]}, list(zip(ac, bc))


def _scatter(grid, meta, chunk):
    a, b = chunk
    ac, _ = pad_chunks(a, grid.n_banks)
    bc, _ = pad_chunks(b, grid.n_banks)
    return grid.to_banks(ac), grid.to_banks(bc)


def _compute(grid, meta, bufs):
    return grid.bank_local(_add)(*bufs)


def _retrieve(grid, meta, out):
    return grid.from_banks(out).reshape(-1)[:meta["per"]]


def _merge(grid, meta, parts):
    return np.concatenate(parts)[:meta["n"]]


chunked = register_chunked(ChunkedWorkload(
    "VA", _split, _scatter, _compute, _retrieve, _merge))
