"""PrIM SpMV — Sparse Matrix-Vector Multiply (paper §4.3), the counterpart
of ``repro.prim.spmv``.

Decomposition: matrix rows split evenly across banks; the dense vector is
broadcast once and every bank reads it.  The paper uses CSR with per-row
fine-grained DMA; the reference re-lays the matrix out as padded ELL
(``cols == -1`` marks padding) so that parallel transfers stay legal, and
the port keeps that layout.  ``use_kernel=True`` runs the ``spmv_ell``
kernel over all banks in one launch; the default is the plain oracle of
``kernels/ref.py``, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import transfer as tx
from repro_torch.core.banked import BankGrid
from repro_torch.kernels import ops, ref as kref
from .common import ChunkedWorkload, PhaseTimer, pad_chunks, register_chunked, sync


def csr_to_ell(indptr, indices, data, n_rows):
    """Convert CSR to padded ELL (cols == -1 ⇒ padding)."""
    counts = np.diff(indptr)
    k = max(int(counts.max()), 1) if len(counts) else 1
    cols = np.full((n_rows, k), -1, np.int32)
    vals = np.zeros((n_rows, k), np.float32)
    for r in range(n_rows):
        c = indptr[r + 1] - indptr[r]
        cols[r, :c] = indices[indptr[r]:indptr[r + 1]]
        vals[r, :c] = data[indptr[r]:indptr[r + 1]]
    return vals, cols


def random_csr(rows, ncols, nnz_per_row, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, nnz_per_row + 1, size=rows)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = np.concatenate(
        [np.sort(rng.choice(ncols, size=c, replace=False)) for c in counts]
    ).astype(np.int32) if counts.sum() else np.zeros(0, np.int32)
    data = rng.normal(size=int(counts.sum())).astype(np.float32)
    return indptr, indices, data


def ref(vals: np.ndarray, cols: np.ndarray, x: np.ndarray) -> np.ndarray:
    return kref.spmv_ell(torch.from_numpy(np.asarray(vals)),
                         torch.from_numpy(np.asarray(cols)),
                         torch.from_numpy(np.asarray(x))).numpy()


def pim(grid: BankGrid, vals: np.ndarray, cols: np.ndarray, x: np.ndarray,
        use_kernel: bool = False):
    t = PhaseTimer()
    with t.phase("cpu_dpu"):
        vc, m = pad_chunks(vals, grid.n_banks)
        cc, _ = pad_chunks(cols, grid.n_banks, fill=-1)
        dv = sync(grid.to_banks(vc))
        dc = sync(grid.to_banks(cc))
        dx = sync(grid.broadcast(np.asarray(x)))

    def local(vb, cb, xb):
        if use_kernel:
            return ops.spmv_ell(vb, cb, xb)
        return kref.spmv_ell(vb, cb, xb)

    f = grid.bank_local(local)
    with t.phase("dpu"):
        out = sync(f(dv, dc, dx))
    with t.phase("dpu_cpu"):
        host = grid.from_banks(out).reshape(-1)[:m]
    return host, t.times


# -- chunked phases (pipelined runtime) --------------------------------------
# Row chunks pipeline through the banks like GEMV; the dense vector is a
# per-request constant broadcast once during split.  split_chunks zero-pads
# the tail rows of vals, which makes the col padding value irrelevant
# (0-valued entries contribute nothing).  As in the reference, the chunked
# compute runs the oracle, not the kernel.
#
# The ELL matrix (vals + cols together) is the residency candidate
# (DESIGN.md §12): its paired row chunks are the pipeline's chunks, so a
# warm hit elides both bank pushes and only the dense-vector broadcast
# remains per request.

def _local(vb, cb, xb):
    return kref.spmv_ell(vb, cb, xb)


def _split_resident(grid, n_chunks, vals, cols):
    vc, m = tx.split_chunks(np.asarray(vals), n_chunks)
    cc, _ = tx.split_chunks(np.asarray(cols), n_chunks)
    return {"m": m, "per": vc[0].shape[0]}, list(zip(vc, cc))


def _split_varying(grid, n_chunks, res_meta, vals, cols, x):
    return {**res_meta, "dx": grid.broadcast(np.asarray(x))}, None


def _split(grid, n_chunks, vals, cols, x):
    res_meta, chunks = _split_resident(grid, n_chunks, vals, cols)
    meta, _ = _split_varying(grid, n_chunks, res_meta, vals, cols, x)
    return meta, chunks


def _scatter(grid, meta, chunk):
    vals, cols = chunk
    vc, _ = pad_chunks(vals, grid.n_banks)
    cc, _ = pad_chunks(cols, grid.n_banks, fill=-1)
    return grid.to_banks(vc), grid.to_banks(cc)


def _compute(grid, meta, bufs):
    dv, dc = bufs
    return grid.bank_local(_local)(dv, dc, meta["dx"])


def _retrieve(grid, meta, out):
    return grid.from_banks(out).reshape(-1)[:meta["per"]]


def _merge(grid, meta, parts):
    return np.concatenate(parts)[:meta["m"]]


chunked = register_chunked(ChunkedWorkload(
    "SpMV", _split, _scatter, _compute, _retrieve, _merge,
    resident_args=(0, 1), split_resident=_split_resident,
    split_varying=_split_varying))
