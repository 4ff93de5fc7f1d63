"""PrIM UNI — database Unique (paper §4.5), the counterpart of
``repro.prim.uni``: collapse runs of equal values.

Like SEL, plus the paper's extra handshake: each bank needs the *last*
valid value of the previous bank to decide whether its first element starts
a new run.  That boundary exchange is an explicit inter-DPU phase
(host-mediated, one value per bank — exactly the paper's description); the
compaction is SEL's.  The valid lengths are SEL's clip formula, so ``pim``
agrees with ``ref()`` at every size (see ``sel.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import transfer as tx
from repro_torch.core.banked import BankGrid
from .common import ChunkedWorkload, PhaseTimer, pad_chunks, register_chunked, sync
from .sel import compact, in_len, ragged, trim, valid_lens


def ref(x: np.ndarray) -> np.ndarray:
    if len(x) == 0:
        return x
    keep = np.concatenate([[True], x[1:] != x[:-1]])
    return x[keep]


def _sentinel(dtype):
    """Bank 0's "previous value": one that never equals data."""
    return np.asarray(np.iinfo(dtype).min if np.issubdtype(dtype, np.integer)
                      else np.nan, dtype)


def _prevs(xc: np.ndarray, lens: np.ndarray, prev0) -> np.ndarray:
    """Bank i's previous value: bank i-1's last valid element (its last
    slot when it has none, and then bank i has none either)."""
    prev = np.empty(xc.shape[0], xc.dtype)
    prev[0] = prev0
    prev[1:] = xc[np.arange(xc.shape[0] - 1), lens[:-1] - 1]
    return prev


def _local(xb, pb, lb):
    keep = torch.cat([(xb[:, 0] != pb)[:, None], xb[:, 1:] != xb[:, :-1]],
                     dim=1)
    return compact(xb, keep & in_len(xb, lb))


def pim(grid: BankGrid, x: np.ndarray):
    t = PhaseTimer()
    n_banks = grid.n_banks
    with t.phase("cpu_dpu"):
        xc, n = pad_chunks(x, n_banks)
        lens = valid_lens(n, n_banks, xc.shape[1])
        dx = sync(grid.to_banks(xc))
        dl = sync(grid.to_banks(lens))

    with t.phase("inter_dpu"):
        # boundary handshake via host: bank i gets the last valid element
        # of bank i-1 (bank 0 gets a sentinel that never equals data)
        dprev = sync(grid.to_banks(_prevs(xc, lens, _sentinel(x.dtype))))

    f = grid.bank_local(_local)
    with t.phase("dpu"):
        buf, counts = sync(f(dx, dprev, dl))
    with t.phase("dpu_cpu"):
        bufs = grid.from_banks(buf)
        cnts = grid.from_banks(counts).reshape(-1)
    with t.phase("inter_dpu"):
        host = trim(bufs, cnts)
    return host, t.times


# -- chunked phases (pipelined runtime) --------------------------------------
# The boundary handshake does NOT serialize the chunk pipeline: every
# boundary value is an element of the *input*, so split resolves chunk k's
# predecessor from the raw array on the host, and scatter resolves the
# intra-chunk bank boundaries the same way.  Chunks stay fully
# independent; the ragged merge is SEL's.

def _split(grid, n_chunks, x):
    x = np.asarray(x)
    chunks, n = tx.split_chunks(x, n_chunks)
    per = chunks[0].shape[0]
    prevs = [_sentinel(x.dtype) if i == 0 or i * per > n - 1
             else x[i * per - 1] for i in range(len(chunks))]
    valid = [min(per, max(0, n - i * per)) for i in range(len(chunks))]
    return {"n": n}, list(zip(chunks, prevs, valid))


def _scatter(grid, meta, chunk):
    x, prev0, valid = chunk
    xc, _ = pad_chunks(x, grid.n_banks)
    lens = valid_lens(valid, grid.n_banks, xc.shape[1])
    return (grid.to_banks(xc), grid.to_banks(_prevs(xc, lens, prev0)),
            grid.to_banks(lens))


def _compute(grid, meta, bufs):
    return grid.bank_local(_local)(*bufs)


def _retrieve(grid, meta, outs):
    return ragged(grid, outs)


def _merge(grid, meta, parts):
    return np.concatenate(parts)


chunked = register_chunked(ChunkedWorkload(
    "UNI", _split, _scatter, _compute, _retrieve, _merge))
