"""PrIM SCAN — exclusive prefix sum, SSA and RSS variants (paper §4.13), the
counterpart of ``repro.prim.scan``.

SCAN-SSA (scan-scan-add):   local scan → host scans per-bank last elements →
                            local add of the per-bank offset.
SCAN-RSS (reduce-scan-scan): local reduce → host scans per-bank totals →
                            local scan + offset.

The inter-bank step is ``exchange_scan``.  Its host mode computes the
offsets in int64 and narrows them to int32 on the way back, as the
reference's ``device_put`` does, so both variants return int32 for int32
input.  On-bank scans and reductions are one kernel launch over all banks.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import transfer as tx
from repro_torch.core.banked import BankGrid
from repro_torch.kernels import ops
from .common import ChunkedWorkload, PhaseTimer, pad_chunks, register_chunked, sync


def ref(x: np.ndarray) -> np.ndarray:
    c = np.cumsum(x)
    return np.concatenate([[np.int64(0).astype(x.dtype)], c[:-1]])


def _plain_exclusive(xb: torch.Tensor) -> torch.Tensor:
    return xb.cumsum(-1, dtype=xb.dtype) - xb


def pim_ssa(grid: BankGrid, x: np.ndarray, via: str = "host",
            use_kernel: bool = True):
    t = PhaseTimer()
    with t.phase("cpu_dpu"):
        xc, n = pad_chunks(x, grid.n_banks)
        dx = sync(grid.to_banks(xc))

    def local_scan(xb):
        s = ops.scan_exclusive(xb) if use_kernel else _plain_exclusive(xb)
        return s, s[:, -1] + xb[:, -1]

    f1 = grid.bank_local(local_scan)
    with t.phase("dpu"):
        scans, lasts = sync(f1(dx))
    with t.phase("inter_dpu"):
        offsets = sync(grid.exchange_scan(lasts, via=via))
    f2 = grid.bank_local(lambda sb, ob: sb + ob[:, None])
    with t.phase("dpu"):
        out = sync(f2(scans, offsets))
    with t.phase("dpu_cpu"):
        host = grid.from_banks(out).reshape(-1)[:n]
    return host, t.times


def pim_rss(grid: BankGrid, x: np.ndarray, via: str = "host",
            use_kernel: bool = True):
    t = PhaseTimer()
    with t.phase("cpu_dpu"):
        xc, n = pad_chunks(x, grid.n_banks)
        dx = sync(grid.to_banks(xc))

    f1 = grid.bank_local(
        lambda xb: (ops.reduce_sum(xb) if use_kernel
                    else xb.sum(-1, dtype=xb.dtype)))
    with t.phase("dpu"):
        totals = sync(f1(dx))
    with t.phase("inter_dpu"):
        offsets = sync(grid.exchange_scan(totals, via=via))

    def local_scan(xb, ob):
        s = ops.scan_exclusive(xb) if use_kernel else _plain_exclusive(xb)
        return s + ob[:, None]

    f2 = grid.bank_local(local_scan)
    with t.phase("dpu"):
        out = sync(f2(dx, offsets))
    with t.phase("dpu_cpu"):
        host = grid.from_banks(out).reshape(-1)[:n]
    return host, t.times


# -- chunked phases (pipelined runtime) --------------------------------------
# SSA shape: the bank-local phase produces per-bank exclusive scans plus
# per-bank totals; the host applies the per-bank offsets during the blocking
# retrieve (the paper's CPU scan) and the cross-chunk running offset during
# merge.  split_chunks zero-pads the tail, which is scan-safe.

def _local(xb):
    s = _plain_exclusive(xb)
    return s, s[:, -1] + xb[:, -1]


def _split(grid, n_chunks, x):
    chunks, n = tx.split_chunks(np.asarray(x), n_chunks)
    return {"n": n, "per": chunks[0].shape[0],
            "dtype": np.asarray(x).dtype}, chunks


def _scatter(grid, meta, chunk):
    xc, _ = pad_chunks(chunk, grid.n_banks)
    return grid.to_banks(xc)


def _compute(grid, meta, dx):
    return grid.bank_local(_local)(dx)


def _retrieve(grid, meta, outs):
    scans, lasts = outs
    s = grid.from_banks(scans)                       # (banks, per)
    t = grid.from_banks(lasts).reshape(-1)           # (banks,)
    off = np.concatenate([[0], np.cumsum(t)[:-1]]).astype(s.dtype)
    # trim bank-tail padding: the chunk contributes exactly `per` elements
    return (s + off[:, None]).reshape(-1)[:meta["per"]], t.sum()


def _merge(grid, meta, parts):
    out, run = [], 0
    for flat, total in parts:
        out.append(flat + run)
        run += total
    return np.concatenate(out)[:meta["n"]].astype(meta["dtype"])


chunked = register_chunked(ChunkedWorkload(
    "SCAN", _split, _scatter, _compute, _retrieve, _merge))
