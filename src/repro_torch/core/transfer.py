"""Host <-> bank transfer engine (paper §2.1 / §3.4) — the PyTorch
counterpart of ``repro.core.transfer``.

The three CPU↔DPU transfer modes of the UPMEM SDK (serial, parallel,
broadcast) become H2D / D2H copies to the grid's device, plus the
"transposition library" (:func:`to_banked` / :func:`from_banked`) and the
chunk splitters of the pipelined runtime, which are host-side numpy and
byte-identical to the reference's.  Every transfer returns
(result, TransferRecord) with the reference's ``kind`` strings and byte
counts, so the paper's CPU-DPU / DPU-CPU bars read the same, and mirrors
each record to a span of the active tracer (``runtime/trace.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from .banked import BankGrid

_get_tracer = None


def _tracer():
    """The active span tracer, bound lazily: ``repro_torch.runtime``
    imports this module, so importing its tracer at the top here would be
    circular.  After the first call this is one global read."""
    global _get_tracer
    if _get_tracer is None:
        from repro_torch.runtime.trace import get_tracer
        _get_tracer = get_tracer
    return _get_tracer()


def _trace_xfer(rec: "TransferRecord", t0: float) -> "TransferRecord":
    """Emit a span mirroring a TransferRecord (a no-op when tracing is
    off); returns the record."""
    tr = _tracer()
    if tr.enabled:
        tr.emit(rec.kind, "transfer", t0, t0 + rec.seconds,
                bytes=rec.nbytes)
    return rec


@dataclasses.dataclass
class TransferRecord:
    kind: str
    nbytes: int
    seconds: float

    @property
    def bandwidth(self) -> float:
        return self.nbytes / self.seconds if self.seconds else float("inf")


def tree_leaves(tree, is_leaf=None) -> list:
    """Leaves of a nest of dicts / lists / tuples: dict values in key
    order and ``None`` left out, as ``jax.tree_util`` has them; a node for
    which ``is_leaf`` holds is one leaf."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t, is_leaf)]
    return [] if tree is None else [tree]


def tree_map(fn, tree):
    """The same nest with ``fn`` applied to every leaf (``None`` kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return None if tree is None else fn(tree)


def block_until_ready(tree):
    """Wait for the device work behind every CUDA tensor in ``tree``: a
    phase timed without it measures the enqueue, not the work."""
    devices = {leaf.device for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)
    return tree


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.prod(x.shape)) * x.dtype.itemsize if hasattr(x, "shape") else 0


def tree_nbytes(args) -> int:
    """Total payload bytes across a nest of arrays (MLP passes a *list* of
    layer matrices — a flat top-level scan undercounts it)."""
    return sum(_nbytes(leaf) for leaf in tree_leaves(args))


# -- layout conversion ("transposition library") ----------------------------

def to_banked(x: np.ndarray, n_banks: int, axis: int = 0):
    """Pad ``axis`` to a multiple of n_banks and reshape to bank-major:
    (..., d, ...) -> (banks, ..., d/banks, ...). Returns (array, orig_len)."""
    x = np.asarray(x)
    d = x.shape[axis]
    pad = (-d) % n_banks
    if pad:
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        x = np.pad(x, widths)
    new_shape = (x.shape[:axis] + (n_banks, x.shape[axis] // n_banks)
                 + x.shape[axis + 1:])
    moved = np.moveaxis(x.reshape(new_shape), axis, 0)
    return moved, d


def from_banked(x: np.ndarray, orig_len: int, axis: int = 0) -> np.ndarray:
    """Inverse of :func:`to_banked`."""
    x = np.asarray(x)
    x = np.moveaxis(x, 0, axis)
    flat = x.reshape(x.shape[:axis] + (-1,) + x.shape[axis + 2:])
    sl = [slice(None)] * flat.ndim
    sl[axis] = slice(0, orig_len)
    return flat[tuple(sl)]


# -- chunking (pipelined runtime) --------------------------------------------

def split_chunks(x: np.ndarray, n_chunks: int, axis: int = 0):
    """Split ``axis`` into ``n_chunks`` equal pieces for pipelined transfer,
    padding the tail so every chunk has an identical shape.
    Returns (chunks, orig_len)."""
    x = np.asarray(x)
    n = x.shape[axis]
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    per = -(-n // n_chunks)
    pad = per * n_chunks - n
    if pad:
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        x = np.pad(x, widths)
    sl = [slice(None)] * x.ndim
    chunks = []
    for i in range(n_chunks):
        sl[axis] = slice(i * per, (i + 1) * per)
        chunks.append(x[tuple(sl)])
    return chunks, n


def split_chunks_ranked(x: np.ndarray, n_ranks: int, n_chunks: int,
                        axis: int = 0):
    """Rank-granular :func:`split_chunks`: ``n_ranks`` contiguous groups of
    ``n_chunks`` equal chunks each, so concatenating the groups in rank
    order restores the flat split order.
    Returns (per_rank_chunk_lists, orig_len)."""
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    chunks, n = split_chunks(x, n_ranks * n_chunks, axis)
    return [chunks[r * n_chunks:(r + 1) * n_chunks]
            for r in range(n_ranks)], n


# -- transfer modes ----------------------------------------------------------

def push_parallel(grid: BankGrid, x):
    t0 = time.perf_counter()
    out = block_until_ready(grid.to_banks(x))
    return out, _trace_xfer(TransferRecord(
        "cpu_dpu_parallel", _nbytes(np.asarray(x)),
        time.perf_counter() - t0), t0)


def push_serial(grid: BankGrid, chunks: Sequence[np.ndarray]):
    t0 = time.perf_counter()
    out = block_until_ready(grid.serial_to_banks(chunks))
    nbytes = sum(_nbytes(c) for c in chunks)
    return out, _trace_xfer(TransferRecord(
        "cpu_dpu_serial", nbytes, time.perf_counter() - t0), t0)


def push_broadcast(grid: BankGrid, x):
    t0 = time.perf_counter()
    out = block_until_ready(grid.broadcast(x))
    return out, _trace_xfer(TransferRecord(
        "cpu_dpu_broadcast", _nbytes(np.asarray(x)),
        time.perf_counter() - t0), t0)


def pull_parallel(grid: BankGrid, x):
    t0 = time.perf_counter()
    host = grid.from_banks(x)
    return host, _trace_xfer(TransferRecord(
        "dpu_cpu_parallel", _nbytes(host), time.perf_counter() - t0), t0)


def pull_serial(grid: BankGrid, xs: Sequence):
    t0 = time.perf_counter()
    host = [grid.from_banks(x) for x in xs]
    nbytes = sum(_nbytes(h) for h in host)
    return host, _trace_xfer(TransferRecord(
        "dpu_cpu_serial", nbytes, time.perf_counter() - t0), t0)


# -- async variants (double-buffering building blocks) -----------------------
#
# The synchronous modes above block until the copy lands, as the UPMEM SDK
# does.  The async variants only *enqueue* the copy.  On the card a push is
# staged through the grid's pinned staging and copied on its ``h2d``
# stream, and a pull copies into pinned memory on its ``d2h`` stream
# (``core/streams.py``); ``resolve()`` waits on that copy's event, never on
# the whole device.  The caller's current stream is ordered after a push's
# copy, so later device work on it reads the landed data without the host
# waiting.  Their records account the enqueue cost of a push and the
# blocking tail of a pull.  On a CPU grid every call is synchronous.

def _pushed(view: BankGrid, x):
    """``view.to_banks(x)`` through the view's pinned staging on its
    ``h2d`` stream; the current stream waits for the copy on the device."""
    st = view.streams
    if st is None:
        return view.to_banks(x)
    with st.scattering():
        out = view.to_banks(x)
    current = torch.cuda.current_stream(view.device)
    current.wait_stream(st.h2d)
    out.record_stream(current)
    return out


def _pulling(xs: Sequence, streams: Sequence):
    """Begin each ``xs[i]``'s D2H copy into pinned memory on
    ``streams[i]``'s ``d2h`` stream, behind the work already enqueued on
    the current stream.  Returns the host tensors (or ``xs[i]`` itself when
    it needs no copy) and the events to wait on."""
    hosts, events = [], []
    for x, st in zip(xs, streams):
        if st is None or not (isinstance(x, torch.Tensor) and x.is_cuda):
            hosts.append(x)
            events.append(None)
            continue
        after = torch.cuda.Event()
        after.record(torch.cuda.current_stream(x.device))
        host, ev = st.prefetch(x, after)
        hosts.append(host)
        events.append(ev)
    return hosts, events


#: the stream set of pulls made without a grid, one per device: made once
#: and kept, so that no pull drops a stream set whose copy is in flight and
#: none draws three more streams from PyTorch's shared pool
_GRIDLESS: dict = {}


def _streams_of(x, grid: BankGrid | None):
    """The stream set a pull of ``x`` copies on: the grid's, or the
    device's gridless set for a CUDA tensor pulled without one."""
    if grid is not None:
        return grid.streams
    if isinstance(x, torch.Tensor) and x.is_cuda:
        from .streams import RankStreams
        st = _GRIDLESS.get(x.device)
        if st is None:
            st = _GRIDLESS.setdefault(x.device, RankStreams(x.device))
        return st
    return None


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def push_parallel_async(grid: BankGrid, x):
    """Parallel CPU→bank scatter without the completion barrier."""
    t0 = time.perf_counter()
    out = _pushed(grid, x)
    return out, _trace_xfer(TransferRecord(
        "cpu_dpu_async", _nbytes(np.asarray(x)),
        time.perf_counter() - t0), t0)


def pull_async(x, grid: BankGrid | None = None):
    """Begin an async bank→CPU copy of ``x`` (on ``grid``'s ``d2h`` stream
    when given); returns ``resolve()`` which blocks for completion and
    yields (host_array, TransferRecord).  The record's seconds measure only
    the blocking tail, i.e. whatever the overlap didn't hide."""
    (host,), (ev,) = _pulling([x], [_streams_of(x, grid)])

    def resolve():
        t0 = time.perf_counter()
        if ev is not None:
            ev.synchronize()
        out = _host_array(host)
        return out, _trace_xfer(TransferRecord(
            "dpu_cpu_async", _nbytes(out), time.perf_counter() - t0), t0)
    return resolve


# -- rank-parallel transfers (DESIGN.md §10) ---------------------------------
#
# On a real UPMEM system CPU↔DPU transfers to *different ranks* proceed in
# parallel.  On the card each rank view owns its streams, so one enqueue per
# rank puts every rank's copy in flight at once; how far that scales with
# the card's copy engines is what ``characterize.rank_parallel_sweep``
# measures.

def push_ranks_async(grid, per_rank: Sequence):
    """Rank-parallel CPU→bank scatter: issue ``per_rank[r]`` to rank ``r``'s
    banks, each on that rank's ``h2d`` stream (no completion barrier).
    Returns (per-rank device tensors, TransferRecord accounting enqueue
    cost)."""
    if len(per_rank) > grid.n_ranks:
        raise ValueError(f"{len(per_rank)} payloads for {grid.n_ranks} ranks")
    t0 = time.perf_counter()
    outs = [_pushed(grid.rank_view(r), x) for r, x in enumerate(per_rank)]
    nbytes = sum(_nbytes(np.asarray(x)) for x in per_rank)
    return outs, _trace_xfer(TransferRecord(
        "cpu_dpu_rank_async", nbytes, time.perf_counter() - t0), t0)


def pull_ranks_async(xs: Sequence, grid=None):
    """Begin async bank→CPU copies from every rank at once (``xs[r]`` on
    rank ``r``'s ``d2h`` stream of the :class:`RankGrid` ``grid`` when
    given); returns ``resolve()`` which blocks for all of them and yields
    (host_arrays, TransferRecord) — the rank-parallel :func:`pull_async`."""
    streams = ([grid.rank_view(r).streams for r in range(len(xs))]
               if grid is not None else [_streams_of(x, None) for x in xs])
    hosts, events = _pulling(xs, streams)

    def resolve():
        t0 = time.perf_counter()
        for ev in events:
            if ev is not None:
                ev.synchronize()
        host = [_host_array(h) for h in hosts]
        nbytes = sum(_nbytes(h) for h in host)
        return host, _trace_xfer(TransferRecord(
            "dpu_cpu_rank_async", nbytes, time.perf_counter() - t0), t0)
    return resolve
