"""PrIM TRNS — Matrix Transposition (paper §4.14), the counterpart of
``repro.prim.trns``.

The paper's 3-step tiled in-place algorithm for an (M'·m) × (N'·n) array:
  step 1: M×N' transpose of n-sized tiles — performed *by the CPU→DPU
          transfer itself* (n-sized transfers land tiles bank-major);
  step 2: per-bank m×n tile transposes (one tasklet per tile);
  step 3: per-bank M'×n transpose of m-sized tiles (collaborative, mutex
          flags in the paper — a single permutation here).
The N' rows of step 1 are split across the banks; steps 2 and 3 permute
within each row, and end in ``.contiguous()`` so the transposition happens
in the bank-local phase rather than in the copy back.  Result gathered by
the host.  Validated against ``x.T``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import transfer as tx
from repro_torch.core.banked import BankGrid
from .common import ChunkedWorkload, PhaseTimer, register_chunked, sync


def ref(x: np.ndarray) -> np.ndarray:
    return x.T


def _steps23(xb, m: int, n: int):
    """(N'_loc, M'·m, n) -> (N'_loc, n, M', m): step 2 transposes each
    (m, n) tile, step 3 each N'-row's (M', n) grid of m-tiles."""
    b, rows = xb.shape[0], xb.shape[1]
    tiles = xb.reshape(b, rows // m, m, n).permute(0, 1, 3, 2)
    return tiles.permute(0, 2, 1, 3).contiguous()


def _step1(x: np.ndarray, n: int) -> np.ndarray:
    """(M'·m, N'·n) -> (N', M'·m, n): the transfer's relayout."""
    rows, N = x.shape
    return np.ascontiguousarray(x.reshape(rows, N // n, n).transpose(1, 0, 2))


def pim(grid: BankGrid, x: np.ndarray, m: int = 8, n: int = 8):
    """x: (M'*m, N'*n). N' must be a multiple of n_banks (pad upstream)."""
    t = PhaseTimer()
    M, N = x.shape
    Mp, Np = M // m, N // n
    assert Mp * m == M and Np * n == N, "factorization must divide shape"
    assert Np % grid.n_banks == 0, "N' must divide across banks"

    with t.phase("cpu_dpu"):
        dx = sync(grid.to_banks(_step1(np.asarray(x), n)))  # N' rows / banks

    f = grid.bank_local(lambda xb: _steps23(xb, m, n))
    with t.phase("dpu"):
        out = sync(f(dx))
    with t.phase("dpu_cpu"):
        host = grid.from_banks(out).reshape(N, M)
    return host, t.times


# -- chunked phases (pipelined runtime) --------------------------------------
# A chunk of input *rows* is a chunk of output *columns*: each chunk runs the
# same 3-step tiled decomposition on its (rows, N) slab (step 1 relayout in
# scatter, steps 2-3 bank-local), and merge concatenates the transposed slabs
# along the column axis.  Chunk rows are zero-padded to a multiple of m so
# the tile factorization divides; the pad columns are trimmed in retrieve.

def _split(grid, n_chunks, x, m: int = 8, n: int = 8):
    x = np.asarray(x)
    M, N = x.shape
    assert (N // n) * n == N, "n must divide N"
    assert (N // n) % grid.n_banks == 0, "N' must divide across banks"
    chunks, _ = tx.split_chunks(x, n_chunks)
    per = chunks[0].shape[0]
    pad = (-per) % m
    if pad:
        chunks = [np.pad(c, ((0, pad), (0, 0))) for c in chunks]
    return {"M": M, "N": N, "m": m, "n": n, "per": per}, chunks


def _scatter(grid, meta, chunk):
    return grid.to_banks(_step1(chunk, meta["n"]))


def _compute(grid, meta, dx):
    return grid.bank_local(lambda xb: _steps23(xb, meta["m"], meta["n"]))(dx)


def _retrieve(grid, meta, out):
    slab = grid.from_banks(out)                     # (N', n, M'_c, m)
    rows = slab.shape[2] * slab.shape[3]
    return slab.reshape(meta["N"], rows)[:, :meta["per"]]


def _merge(grid, meta, parts):
    return np.concatenate(parts, axis=1)[:, :meta["M"]]


chunked = register_chunked(ChunkedWorkload(
    "TRNS", _split, _scatter, _compute, _retrieve, _merge))
