"""Microbenchmark harness — the paper's §3 characterization methodology,
the PyTorch counterpart of ``repro.core.characterize``.

Each function mirrors one of the paper's microbenchmarks and returns rows
of measurements taken on a torch device: the grid's, or ``device=`` for the
sweeps that take no grid (default ``cuda:0``; the CPU only when asked
for).  The names, arguments and row keys are the reference's.

Measurement discipline (:func:`_time`): one warm-up call, which pays every
first use (a kernel library's build, the growth of a pinned staging
buffer, the caching allocator's first blocks), then the host time around
each call, which ends in ``torch.cuda.synchronize`` on the devices of its
outputs (:func:`~repro_torch.core.transfer.block_until_ready`); the median
of ``reps``.  Host time is what the reference measures, and the stage fits'
``alpha`` is meant to hold the dispatch cost, so no CUDA events here.

64-bit narrowing.  The reference runs with JAX's 64-bit types off, so its
``"int64"`` / ``"double"`` arrays are really int32 / float32, and
``stream_wram``'s int64 ``arange`` is int32 too.  ``_DTYPES`` narrows the
same way, as the port's ``to_banks`` does, and every byte count follows
the reference's arithmetic (the array's itemsize where the reference takes
it from the array, the declared dtype's where it takes it from the dtype),
so rows for the same arguments report the same ``nbytes`` / ``elements``
in both packages.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from .banked import BankGrid, _device
from . import transfer as tx


def _time(fn: Callable, *args, reps: int = 5) -> float:
    tx.block_until_ready(fn(*args))     # warm-up: every first use
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        tx.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# -- §3.1 arithmetic throughput (Fig. 4) -------------------------------------

_OPS = {
    "add": lambda x, s: x + s,
    "sub": lambda x, s: x - s,
    "mul": lambda x, s: x * s,
    "div": lambda x, s: x / s if x.is_floating_point() else x // s,
}
#: the reference's dtypes as its arrays really are with 64-bit types off
_DTYPES = {"int32": torch.int32, "int64": torch.int32,
           "float": torch.float32, "double": torch.float32}
#: the dtypes as declared: the itemsize the reference's byte counts use
#: where they take it from the dtype rather than from the array
_NP_DTYPES = {"int32": np.int32, "int64": np.int64,
              "float": np.float32, "double": np.float64}


def arith_throughput(op: str, dtype: str, lanes: int = 16,
                     n: int = 1 << 20, reps: int = 5, *,
                     device=None) -> dict:
    """Streaming read-modify-write loop (paper Listing 1): x[i] op= scalar.

    ``lanes`` is the tasklet analogue: number of independent streams the
    backend may execute in parallel (shaped (lanes, n//lanes))."""
    dt = _DTYPES[dtype]
    x = torch.ones((lanes, max(n // lanes, 1)), dtype=dt,
                   device=_device(device))
    sec = _time(lambda v: _OPS[op](v, 3), x, reps=reps)
    return {"op": op, "dtype": dtype, "lanes": lanes,
            "mops": x.numel() / sec / 1e6, "seconds": sec}


# -- §3.1.3 WRAM STREAM (Fig. 5) ---------------------------------------------

def stream_wram(which: str, n: int = 1 << 20, reps: int = 5, *,
                device=None) -> dict:
    """STREAM COPY/ADD/SCALE/TRIAD on widest-available integer elements
    (int32: the reference's int64 ``arange`` is int32 with 64-bit types
    off, and the byte count follows the real itemsize)."""
    a = torch.arange(n, dtype=torch.int32, device=_device(device))
    b = a + 1
    item = a.element_size()
    fns = {
        "copy": (lambda: a + 0, 2 * item),      # ld + sd
        "add": (lambda: a + b, 3 * item),       # 2 ld + sd
        "scale": (lambda: a * 3, 2 * item),
        "triad": (lambda: a + b * 3, 3 * item),
    }
    fn, bytes_per = fns[which]
    sec = _time(fn, reps=reps)
    return {"stream": which, "mbps": n * bytes_per / sec / 1e6, "seconds": sec}


# -- §3.2.1 DMA latency model (Fig. 6) ---------------------------------------

def dma_latency_sweep(sizes=(8, 32, 128, 512, 2048, 8192, 65536),
                      reps: int = 20, *, device=None) -> list[dict]:
    """On-device block copy latency vs size; α/β fit per paper Eq. 3."""
    dev = _device(device)
    rows = []
    for size in sizes:
        x = torch.zeros(size, dtype=torch.uint8, device=dev)
        sec = _time(lambda v: v + 1, x, reps=reps)
        rows.append({"size": size, "seconds": sec,
                     "mbps": size / sec / 1e6})
    return rows


def fit_dma_model(rows: list[dict], freq_hz: float) -> tuple[float, float]:
    """Recover (alpha_cycles, beta_cycles_per_byte) from a latency sweep."""
    sizes = [r["size"] for r in rows]
    cycles = [r["seconds"] * freq_hz for r in rows]
    from .perfmodel import DpuModel
    return DpuModel.fit_dma(sizes, cycles)


# -- §3.2.2 streaming MRAM (Fig. 7): copy with explicit staging --------------

def stream_mram(which: str, n: int = 1 << 21, block: int = 1024,
                reps: int = 3, *, device=None) -> dict:
    """Streaming through blocked staging (MRAM→WRAM→MRAM analogue): the
    array is processed in ``block``-byte chunks.

    The reference's ``fori_loop`` over the ``n / elems`` blocks compiles to
    one loop; a Python loop of that many small launches would measure the
    launch rate instead.  So the blocks are walked in one operation on an
    ``(n_blocks, elems)`` view, each block's result folded into the one
    accumulator as there."""
    x = torch.arange(n, dtype=torch.int32, device=_device(device))
    elems = max(block // x.element_size(), 1)
    nblocks = n // elems
    blocks = x[:nblocks * elems].view(nblocks, elems)
    fns = {
        "copy-dma": lambda: (blocks[:, 0] * 0).sum(dtype=x.dtype),
        "copy": lambda: (blocks[:, -1] * 0 + blocks[:, 0] * 0).sum(
            dtype=x.dtype),
        "add": lambda: blocks.sum(dtype=x.dtype),
        "scale": lambda: (blocks * 3).sum(dtype=x.dtype),
        "triad": lambda: (blocks * 3 + blocks).sum(dtype=x.dtype),
    }
    if which not in fns:
        raise ValueError(which)
    sec = _time(fns[which], reps=reps)
    return {"stream": which, "block": block,
            "mbps": n * x.element_size() / sec / 1e6, "seconds": sec}


# -- §3.2.3 strided / random (Fig. 8) ----------------------------------------

def strided_bandwidth(stride: int, mode: str = "coarse", n: int = 1 << 20,
                      reps: int = 3, *, device=None) -> dict:
    """Coarse: contiguous fetch then stride in fast memory (CPU cache-line /
    DPU 1KB-DMA analogue). Fine: gather only the used elements."""
    dev = _device(device)
    x = torch.arange(n, dtype=torch.int32, device=dev)
    item = x.element_size()
    idx = torch.arange(0, n, stride, device=dev)
    if mode == "coarse":
        def f(v):
            if stride > 1:
                return v.reshape(-1, stride)[:, 0].sum(dtype=v.dtype)
            return v.sum(dtype=v.dtype)
        used_bytes = n * item         # full array is streamed
    elif mode == "fine":
        def f(v):
            return v[idx].sum(dtype=v.dtype)
        used_bytes = idx.numel() * item
    elif mode == "random":
        g = torch.Generator().manual_seed(0)
        ridx = torch.randperm(n, generator=g)[: n // stride].to(dev)

        def f(v):
            return v[ridx].sum(dtype=v.dtype)
        used_bytes = ridx.numel() * item
    else:
        raise ValueError(mode)
    sec = _time(f, x, reps=reps)
    return {"stride": stride, "mode": mode, "seconds": sec,
            "effective_mbps": (n // stride) * item / sec / 1e6,
            "raw_mbps": used_bytes / sec / 1e6}


# -- §3.3 throughput vs operational intensity (Fig. 9) -----------------------

def intensity_sweep(ops_per_elem: int, dtype: str = "float",
                    n: int = 1 << 20, reps: int = 3, *,
                    device=None) -> dict:
    """Variable compute per element fetched — the roofline transition probe."""
    dt = _DTYPES[dtype]
    x = torch.ones(n, dtype=dt, device=_device(device))

    def f(v):
        acc = v
        for _ in range(ops_per_elem):
            acc = acc + v
        return acc.sum(dtype=v.dtype)

    sec = _time(f, x, reps=reps)
    itemsize = np.dtype(_NP_DTYPES[dtype]).itemsize
    return {"op_per_byte": ops_per_elem / itemsize, "dtype": dtype,
            "mops": max(ops_per_elem, 1) * n / sec / 1e6, "seconds": sec}


# -- autotune calibration sweeps (DESIGN.md §8) ------------------------------
#
# The autotuner's measured analogues of the paper's Eqs. 1-4: each pipeline
# stage's time for b bytes is affine, t(b) = alpha + b / bw (Eq. 3's shape).
# These sweeps produce the (nbytes, seconds) points the affine fit consumes.

def push_pull_sweep(grid: BankGrid, nbytes=(1 << 18, 1 << 20, 1 << 22),
                    reps: int = 5) -> list[dict]:
    """CPU→bank scatter and bank→CPU retrieve latency vs payload size (the
    synchronous parallel modes: pageable copies on the card)."""
    rows = []
    for size in nbytes:
        buf = np.zeros((grid.n_banks, max(size // 8 // grid.n_banks, 1)),
                       np.int64)
        push_s = _time(lambda b: tx.push_parallel(grid, b)[0], buf, reps=reps)
        dev, _ = tx.push_parallel(grid, buf)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            grid.from_banks(dev)
            ts.append(time.perf_counter() - t0)
        rows.append({"nbytes": buf.nbytes, "push_s": push_s,
                     "pull_s": float(np.median(ts))})
    return rows


def op_throughput_sweep(grid: BankGrid, ops=("add", "sub", "mul", "div"),
                        dtypes=("int32", "float"),
                        nbytes=(1 << 16, 1 << 20),
                        reps: int = 5) -> list[dict]:
    """Per-(op, dtype) grid-level issue+execute cost points — §3.1 made
    fit-ready for the cost model (DESIGN.md §15).  One bank-local
    elementwise phase per pair, timed at each payload size; two sizes
    make the affine fit t(n) = issue_s + n * per_op_s exact.  Rows feed
    :meth:`repro_torch.core.costmodel.CostModel.fit`."""
    rows = []
    for dtype in dtypes:
        item = np.dtype(_NP_DTYPES[dtype]).itemsize
        for op in ops:
            local = grid.bank_local(lambda x, _fn=_OPS[op]: _fn(x, 3))
            for size in nbytes:
                per_bank = max(size // item // grid.n_banks, 1)
                buf = grid.to_banks(np.ones((grid.n_banks, per_bank),
                                            _NP_DTYPES[dtype]))
                sec = _time(local, buf, reps=reps)
                elements = per_bank * grid.n_banks
                rows.append({"op": op, "dtype": dtype,
                             "elements": elements,
                             "nbytes": elements * item,
                             "seconds": sec,
                             "mops": elements / sec / 1e6})
    return rows


def bank_compute_sweep(grid: BankGrid, nbytes=(1 << 18, 1 << 20, 1 << 22),
                       reps: int = 5) -> list[dict]:
    """Bank-local streaming-compute latency vs payload size (one elementwise
    phase per size — the dispatch cost is part of the alpha the fit
    recovers, exactly what the chunk planner must amortize)."""
    rows = []
    local = grid.bank_local(lambda x: x * 3 + 1)
    for size in nbytes:
        buf = grid.to_banks(np.zeros(
            (grid.n_banks, max(size // 8 // grid.n_banks, 1)), np.int64))
        sec = _time(local, buf, reps=reps)
        rows.append({"nbytes": tx.tree_nbytes(buf), "compute_s": sec})
    return rows


# -- rank-level transfer scaling (paper §5; DESIGN.md §10) -------------------

def rank_parallel_sweep(grid, rank_counts=None, nbytes: int = 1 << 22,
                        reps: int = 5) -> list[dict]:
    """CPU↔bank transfer time vs number of concurrently-addressed ranks at
    fixed total payload — the analogue of the paper's rank-level CPU-DPU
    bandwidth scaling.  ``grid`` must be a
    :class:`~repro_torch.core.banked.RankGrid`; ``rank_counts`` defaults to
    the divisors of its rank count.  Pushes are each rank view's
    ``to_banks``; pulls are :func:`~repro_torch.core.transfer.pull_ranks_async`
    on the ranks' own ``d2h`` streams.  On one card every rank's copies
    share its few copy engines, so the aggregate need not grow with ranks
    as the paper's does."""
    n_ranks = getattr(grid, "n_ranks", 1)
    ranked = hasattr(grid, "rank_view")
    if rank_counts is None:
        rank_counts = [r for r in range(1, n_ranks + 1) if n_ranks % r == 0]
    rows = []
    for r in rank_counts:
        banks = r * grid.n_banks // n_ranks
        per_rank = [np.zeros((grid.n_banks // n_ranks,
                              max(nbytes // 8 // banks, 1)), np.int64)
                    for _ in range(r)]
        views = ([grid.rank_view(i) for i in range(r)] if ranked
                 else [grid])
        if len(views) < r:
            raise ValueError(f"rank_parallel_sweep needs a RankGrid to "
                             f"address {r} ranks; got a flat grid")

        def push():
            return [v.to_banks(x) for v, x in zip(views, per_rank)]

        push_s = _time(push, reps=reps)
        devs = push()
        tx.block_until_ready(devs)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            resolve = tx.pull_ranks_async(devs, grid if ranked else None)
            resolve()
            ts.append(time.perf_counter() - t0)
        total = sum(x.nbytes for x in per_rank)
        pull_s = float(np.median(ts))
        rows.append({"ranks": r, "banks": banks, "nbytes": total,
                     "push_s": push_s, "pull_s": pull_s,
                     "push_gbps": total / push_s / 1e9,
                     "pull_gbps": total / pull_s / 1e9})
    return rows


# -- §3.4 CPU<->bank transfers (Fig. 10) -------------------------------------

def transfer_sweep(grid: BankGrid, mb_per_bank: int = 4) -> list[dict]:
    rows = []
    n = grid.n_banks
    buf = np.zeros((n, mb_per_bank << 20 >> 3), np.int64)
    for kind, fn in (
        ("cpu_dpu_parallel", lambda: tx.push_parallel(grid, buf)),
        ("cpu_dpu_serial", lambda: tx.push_serial(grid, list(buf))),
        ("cpu_dpu_broadcast", lambda: tx.push_broadcast(grid, buf[0])),
    ):
        _, rec = fn()
        rows.append({"kind": kind, "banks": n, "nbytes": rec.nbytes,
                     "gbps": rec.bandwidth / 1e9})
    dev, _ = tx.push_parallel(grid, buf)
    _, rec = tx.pull_parallel(grid, dev)
    rows.append({"kind": "dpu_cpu_parallel", "banks": n, "nbytes": rec.nbytes,
                 "gbps": rec.bandwidth / 1e9})
    return rows
