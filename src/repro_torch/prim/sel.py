"""PrIM SEL — database Select (paper §4.4), the counterpart of
``repro.prim.sel``: drop elements satisfying the predicate, keep the rest.

Decomposition: array chunks → banks; inside a bank the tasklet handshake
prefix-sum becomes a running count of the keep-flags along the bank row
(``torch.cumsum`` over every bank at once), and each kept element is
scattered to its compacted slot.  Compacted chunks have *different* lengths
per bank, so the host trims each bank's buffer to its count on retrieval,
as the paper's serial DPU→CPU transfers do (parallel transfers are illegal
for ragged buffers — Key Obs./PR-5).

Each bank's valid length is ``clip(n - per·b, 0, per)``, the formula of the
reference's chunked path, in ``pim`` too: the reference's ``pim`` gives the
last bank ``per - padding``, which goes negative when the padding spans more
than one bank, and then counts whole banks of padding as data.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import transfer as tx
from repro_torch.core.banked import BankGrid
from .common import ChunkedWorkload, PhaseTimer, pad_chunks, register_chunked, sync

PRED_MOD = 2   # predicate: drop x where x % 2 == 0 (paper uses a compare)


def ref(x: np.ndarray) -> np.ndarray:
    return x[x % PRED_MOD != 0]


def valid_lens(valid: int, n_banks: int, per: int) -> np.ndarray:
    """Per-bank count of real (not padding) elements among ``valid``."""
    return np.clip(valid - per * np.arange(n_banks), 0, per).astype(np.int32)


def in_len(xb: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """(banks, per) mask of each bank's first ``lb[b]`` slots."""
    return (torch.arange(xb.shape[1], device=xb.device)[None, :]
            < lb[:, None])


def compact(xb: torch.Tensor, keep: torch.Tensor):
    """Move each bank's kept elements to the front of its row, in order;
    returns the (banks, per) buffer (zeros past the count) and the
    (banks,) int32 counts.  Dropped elements are scattered to a spare
    column past the row, which is cut off (torch has no ``mode="drop"``)."""
    per = xb.shape[1]
    slot = torch.cumsum(keep, dim=1, dtype=torch.int32) - 1
    idx = torch.where(keep, slot, per).long()
    out = xb.new_zeros((xb.shape[0], per + 1)).scatter_(1, idx, xb)
    return out[:, :per], keep.sum(dim=1, dtype=torch.int32)


def trim(bufs: np.ndarray, cnts: np.ndarray) -> np.ndarray:
    """The host merge: each bank's first ``count`` elements, in bank
    order."""
    return bufs[np.arange(bufs.shape[1])[None, :] < cnts[:, None]]


def ragged(grid: BankGrid, outs) -> np.ndarray:
    """Retrieve the compacted buffers and their counts, and merge."""
    buf, counts = outs
    return trim(grid.from_banks(buf), grid.from_banks(counts).reshape(-1))


def _local(xb, lb):
    return compact(xb, (xb % PRED_MOD != 0) & in_len(xb, lb))


def pim(grid: BankGrid, x: np.ndarray):
    t = PhaseTimer()
    n_banks = grid.n_banks
    with t.phase("cpu_dpu"):
        xc, n = pad_chunks(x, n_banks)
        lens = valid_lens(n, n_banks, xc.shape[1])
        dx = sync(grid.to_banks(xc))
        dl = sync(grid.to_banks(lens))

    f = grid.bank_local(_local)
    with t.phase("dpu"):
        buf, counts = sync(f(dx, dl))
    with t.phase("dpu_cpu"):
        # ragged retrieve: serial, like dpu_copy_from in the paper
        bufs = grid.from_banks(buf)
        cnts = grid.from_banks(counts).reshape(-1)
    with t.phase("inter_dpu"):
        host = trim(bufs, cnts)
    return host, t.times


# -- chunked phases (pipelined runtime) --------------------------------------
# Compacted chunk outputs stay ragged per bank, so each chunk carries its
# valid length and the retrieve trims per bank exactly like pim()'s serial
# path — but chunk k's ragged host merge overlaps chunk k+1's compute.

def _split(grid, n_chunks, x):
    chunks, n = tx.split_chunks(np.asarray(x), n_chunks)
    per = chunks[0].shape[0]
    valid = [min(per, max(0, n - i * per)) for i in range(len(chunks))]
    return {"n": n}, list(zip(chunks, valid))


def _scatter(grid, meta, chunk):
    x, valid = chunk
    xc, _ = pad_chunks(x, grid.n_banks)
    lens = valid_lens(valid, grid.n_banks, xc.shape[1])
    return grid.to_banks(xc), grid.to_banks(lens)


def _compute(grid, meta, bufs):
    return grid.bank_local(_local)(*bufs)


def _retrieve(grid, meta, outs):
    return ragged(grid, outs)


def _merge(grid, meta, parts):
    return np.concatenate(parts)


chunked = register_chunked(ChunkedWorkload(
    "SEL", _split, _scatter, _compute, _retrieve, _merge))
