"""PrIM HST — Image Histogram, short & long variants (paper §4.11), the
counterpart of ``repro.prim.hist``.

HST-S: per-tasklet private histograms merged at a barrier → the
``histogram`` kernel, whose thread blocks keep private shared-memory
histograms merged with atomics; one launch over all banks.
HST-L: one shared mutex-guarded histogram per DPU → the plain clip and
scatter-add of ``kernels/ref.py`` over every bank row (serialized adds,
like the mutex).

Both merge per-bank histograms on the host (tiny inter-DPU phase).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import transfer as tx
from repro_torch.core.banked import BankGrid
from repro_torch.kernels import ops, ref as kref
from .common import ChunkedWorkload, PhaseTimer, pad_chunks, register_chunked, sync


def ref(pixels: np.ndarray, nbins: int) -> np.ndarray:
    return np.bincount(np.clip(pixels, 0, nbins - 1),
                       minlength=nbins).astype(np.int32)


def _pim(grid: BankGrid, pixels: np.ndarray, nbins: int, variant: str):
    t = PhaseTimer()
    with t.phase("cpu_dpu"):
        pc, n = pad_chunks(pixels, grid.n_banks, fill=-1)  # -1 ⇒ bin 0, fixed
        pad_total = pc.size - n
        dp = sync(grid.to_banks(pc))

    def local_s(pb):
        return ops.histogram(pb, nbins)

    def local_l(pb):
        return kref.histogram(pb, nbins)

    f = grid.bank_local(local_s if variant == "short" else local_l)
    with t.phase("dpu"):
        parts = sync(f(dp))
    with t.phase("inter_dpu"):
        hist = grid.from_banks(parts).sum(axis=0).astype(np.int32)
        hist[0] -= pad_total          # remove padding sentinel counts
    return hist, t.times


def pim_short(grid: BankGrid, pixels: np.ndarray, nbins: int = 256):
    return _pim(grid, pixels, nbins, "short")


def pim_long(grid: BankGrid, pixels: np.ndarray, nbins: int = 256):
    return _pim(grid, pixels, nbins, "long")


# -- chunked phases (pipelined runtime) --------------------------------------
# Histograms are associative: each chunk yields per-bank partial histograms
# that retrieve sums bank-wise and merge sums chunk-wise.  Both padding kinds
# (split_chunks zeros at the chunk tail, pad_chunks -1 sentinels at the bank
# tail) land in bin 0, so merge subtracts one precomputed spurious count.
# Uses the HST-L scatter-add form per bank (exact, variant-independent math).

def _split(grid, n_chunks, pixels, nbins=256):
    chunks, n = tx.split_chunks(np.asarray(pixels), n_chunks)
    per = chunks[0].shape[0]
    per_bank = -(-per // grid.n_banks)
    spurious = len(chunks) * per_bank * grid.n_banks - n
    return {"nbins": nbins, "spurious": spurious}, chunks


def _scatter(grid, meta, chunk):
    pc, _ = pad_chunks(chunk, grid.n_banks, fill=-1)
    return grid.to_banks(pc)


def _compute(grid, meta, dp):
    return grid.bank_local(lambda pb: kref.histogram(pb, meta["nbins"]))(dp)


def _retrieve(grid, meta, parts):
    return grid.from_banks(parts).sum(axis=0)


def _merge(grid, meta, parts):
    hist = np.sum(parts, axis=0).astype(np.int32)
    hist[0] -= meta["spurious"]
    return hist


chunked = register_chunked(ChunkedWorkload(
    "HST", _split, _scatter, _compute, _retrieve, _merge))
