"""PrIM BS — Binary Search (paper §4.6), the counterpart of
``repro.prim.bs``.

Decomposition: the *sorted array is replicated* on every bank (broadcast —
the paper notes this makes CPU→DPU cost grow with bank count); the query
values are split across banks; each bank binary-searches its queries
locally; positions retrieved in parallel.  The paper's loop runs as
⌈log₂(n+1)⌉ steps over every query of every bank at once, a query whose
range is empty standing still (the reference runs a ``while_loop`` per
query under ``vmap``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import transfer as tx
from repro_torch.core.banked import BankGrid
from .common import ChunkedWorkload, PhaseTimer, pad_chunks, register_chunked, sync


def ref(sorted_arr: np.ndarray, queries: np.ndarray) -> np.ndarray:
    return np.searchsorted(sorted_arr, queries).astype(np.int32)


def binary_search(arr: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Lower bound of every query in the sorted ``arr``: the first index
    whose value is not below it, int32, of ``q``'s shape."""
    n = arr.shape[0]
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    hi = torch.full(q.shape, n, dtype=torch.int32, device=q.device)
    for _ in range(n.bit_length()):           # ⌈log₂(n+1)⌉ halvings
        live = lo < hi
        mid = (lo + hi) // 2
        go_right = arr[mid.clamp(max=max(n - 1, 0)).long()] < q
        lo = torch.where(live & go_right, mid + 1, lo)
        hi = torch.where(live & ~go_right, mid, hi)
    return lo


def pim(grid: BankGrid, sorted_arr: np.ndarray, queries: np.ndarray):
    t = PhaseTimer()
    with t.phase("cpu_dpu"):
        qc, nq = pad_chunks(queries, grid.n_banks)
        darr = sync(grid.broadcast(np.asarray(sorted_arr)))
        dq = sync(grid.to_banks(qc))

    f = grid.bank_local(binary_search)
    with t.phase("dpu"):
        pos = sync(f(darr, dq))
    with t.phase("dpu_cpu"):
        host = grid.from_banks(pos).reshape(-1)[:nq].astype(np.int32)
    return host, t.times


# -- chunked phases (pipelined runtime) --------------------------------------
# Query chunks pipeline through the banks; the sorted array is a
# per-request constant broadcast once during split.  It is the residency
# candidate (DESIGN.md §12) and lives in the meta, not in the chunk stream:
# *meta-resident* caching — warm hits skip the replicated broadcast, while
# the query chunks (the varying operand) still scatter.

def _split_resident(grid, n_chunks, sorted_arr):
    return {"darr": grid.broadcast(np.asarray(sorted_arr))}, None


def _split_varying(grid, n_chunks, res_meta, sorted_arr, queries):
    qc, nq = tx.split_chunks(np.asarray(queries), n_chunks)
    return {"nq": nq, "per": qc[0].shape[0], **res_meta}, qc


def _split(grid, n_chunks, sorted_arr, queries):
    res_meta, _ = _split_resident(grid, n_chunks, sorted_arr)
    return _split_varying(grid, n_chunks, res_meta, sorted_arr, queries)


def _scatter(grid, meta, chunk):
    qc, _ = pad_chunks(chunk, grid.n_banks)
    return grid.to_banks(qc)


def _compute(grid, meta, dq):
    return grid.bank_local(binary_search)(meta["darr"], dq)


def _retrieve(grid, meta, pos):
    return grid.from_banks(pos).reshape(-1)[:meta["per"]]


def _merge(grid, meta, parts):
    return np.concatenate(parts)[:meta["nq"]].astype(np.int32)


chunked = register_chunked(ChunkedWorkload(
    "BS", _split, _scatter, _compute, _retrieve, _merge,
    resident_args=(0,), split_resident=_split_resident,
    split_varying=_split_varying, meta_resident=True))
