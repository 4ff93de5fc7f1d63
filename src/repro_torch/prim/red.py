"""PrIM RED — Reduction (paper §4.12), the counterpart of
``repro.prim.red``.

Per-tasklet local sums + single-tasklet final merge → one launch of the
per-bank ``reduce_sum`` kernel over all banks, then an exchange-sum across
banks (``via="host"`` is the paper's host merge, in numpy as in the
reference, so the result is int64 for int32 input; ``via="fabric"`` sums
on the device in the input's dtype).
"""
from __future__ import annotations

import numpy as np
import torch.nn.functional as F

from repro_torch.core import transfer as tx
from repro_torch.core.banked import BankGrid
from repro_torch.kernels import ops, ref as kref
from .common import ChunkedWorkload, PhaseTimer, pad_chunks, register_chunked, sync


def ref(x: np.ndarray):
    return x.sum()


def pim(grid: BankGrid, x: np.ndarray, via: str = "host",
        use_kernel: bool = True, variant: str = "single"):
    """variant (paper §4.12 / appendix 9.2.3):
      "single"          one accumulator merges per-tasklet partials
                        (the version the paper finds never worse);
      "tree-barrier"    log2 tree merge with a barrier per level;
      "tree-handshake"  log2 tree merge with pairwise handshakes.
    The tasklet tree is a pairwise-halving reduction over 16 per-bank
    partials, all banks at once."""
    t = PhaseTimer()
    with t.phase("cpu_dpu"):
        xc, n = pad_chunks(x, grid.n_banks)
        dx = sync(grid.to_banks(xc))

    def local_single(xb):
        return ops.reduce_sum(xb) if use_kernel else kref.reduce_sum(xb)

    def local_tree(xb, pairwise: bool):
        # per-"tasklet" partials: 16 lanes, then log2 tree merge
        banks, per_bank = xb.shape
        lanes = 16
        per = -(-per_bank // lanes)
        pad = F.pad(xb, (0, per * lanes - per_bank))
        parts = pad.reshape(banks, lanes, per).sum(-1, dtype=xb.dtype)
        while parts.shape[1] > 1:                          # tree levels
            half = parts.shape[1] // 2
            if pairwise:      # handshake: explicit pair slices
                parts = parts[:, :half] + parts[:, half:]
            else:             # barrier: same math, level-at-once reshape
                parts = parts.reshape(banks, 2, half).sum(1, dtype=xb.dtype)
        return parts[:, 0]

    if variant == "single":
        f = grid.bank_local(local_single)
    elif variant == "tree-barrier":
        f = grid.bank_local(lambda xb: local_tree(xb, False))
    elif variant == "tree-handshake":
        f = grid.bank_local(lambda xb: local_tree(xb, True))
    else:
        raise ValueError(variant)
    with t.phase("dpu"):
        partials = sync(f(dx))
    with t.phase("inter_dpu"):
        total = sync(grid.exchange_sum(partials, via=via))
    with t.phase("dpu_cpu"):
        return grid.from_banks(total).reshape(()), t.times


# -- chunked phases (pipelined runtime) --------------------------------------
# Each chunk yields one partial sum per bank; the final merge sums the
# per-chunk partials on the host (the paper's "host" inter-DPU mode).

def _local(xb):
    return xb.sum(-1, dtype=xb.dtype)


def _split(grid, n_chunks, x):
    chunks, n = tx.split_chunks(np.asarray(x), n_chunks)  # zero pad: sum-safe
    return {"n": n}, chunks


def _scatter(grid, meta, chunk):
    xc, _ = pad_chunks(chunk, grid.n_banks)
    return grid.to_banks(xc)


def _compute(grid, meta, dx):
    return grid.bank_local(_local)(dx)


def _retrieve(grid, meta, partials):
    return grid.from_banks(partials)  # (banks,) per-bank partial sums


def _merge(grid, meta, parts):
    return np.concatenate(parts).sum()


chunked = register_chunked(ChunkedWorkload(
    "RED", _split, _scatter, _compute, _retrieve, _merge))
