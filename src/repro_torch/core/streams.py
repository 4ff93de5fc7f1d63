"""CUDA streams and pinned host staging of one pipeline on one GPU.

The JAX reference overlaps its three pipeline stages through asynchronous
dispatch and ``copy_to_host_async``.  On the card the same overlap needs
explicit streams.  A :class:`RankStreams` belongs to one grid object (a
flat grid, or one rank view of a :class:`~repro_torch.core.banked.RankGrid`:
a rank is its own stream set) and holds

* ``h2d`` — the scatter stage.  Inside :meth:`RankStreams.scattering` every
  bank put of the grid is staged through pinned host memory and copied
  with ``non_blocking=True``.  The staging is double-buffered per operand
  (:class:`PinnedStage`), and a buffer is reused only after the event
  recorded behind its last copy has completed.
* ``compute`` — the bank-local stage; it waits on the scatter's event.
* ``d2h`` — the retrieve stage; :meth:`RankStreams.prefetch` copies each
  output into fresh pinned memory behind the compute's event and returns
  an event that the retrieve waits on (never a device-wide synchronize).

A tensor used on a stream other than the one it was allocated on is
handed to ``record_stream``, so the caching allocator cannot reuse its
memory while that stream may still read it.  ``torch.cuda.stream`` is
thread-local, so each rank thread of the ranked pipeline enters its own
view's streams.  Nothing here runs on the CPU: a CPU grid has no streams
and the pipeline calls its stages directly.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .transfer import tree_leaves, tree_map


def _cuda_leaves(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.is_cuda]


class _Slot:
    __slots__ = ("buf", "event")

    def __init__(self):
        self.buf: torch.Tensor | None = None     # pinned uint8
        self.event: torch.cuda.Event | None = None


class PinnedStage:
    """Double-buffered pinned staging for the H2D copies of one stream.

    Lane ``i`` serves the ``i``-th bank put of a chunk's scatter (SpMV puts
    two operands, the other workloads one); each lane alternates between
    ``depth`` pinned buffers, grown on demand.  ``allocations`` counts
    buffers made, ``reuses`` puts served by an existing buffer."""

    def __init__(self, depth: int = 2):
        self.depth = depth
        self._lanes: list[list[_Slot]] = []
        self._turn: list[int] = []
        self._lane = 0
        self.allocations = 0
        self.reuses = 0

    def begin(self) -> None:
        """A new chunk's scatter starts at lane 0."""
        self._lane = 0

    def put(self, host: np.ndarray, device: torch.device,
            stream: torch.cuda.Stream) -> torch.Tensor:
        """Copy ``host`` into a pinned buffer and enqueue its H2D copy on
        ``stream``; returns the device tensor."""
        if self._lane == len(self._lanes):
            self._lanes.append([_Slot() for _ in range(self.depth)])
            self._turn.append(0)
        lane = self._lane
        self._lane += 1
        slot = self._lanes[lane][self._turn[lane]]
        self._turn[lane] = (self._turn[lane] + 1) % self.depth
        if slot.event is not None:
            slot.event.synchronize()        # its last copy has landed
        src = torch.from_numpy(host)
        nbytes = host.nbytes
        if slot.buf is None or slot.buf.numel() < nbytes:
            slot.buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                   pin_memory=True)
            self.allocations += 1
        else:
            self.reuses += 1
        staged = slot.buf[:nbytes].view(src.dtype).reshape(src.shape)
        staged.copy_(src)
        with torch.cuda.stream(stream):
            out = torch.empty(src.shape, dtype=src.dtype, device=device)
            out.copy_(staged, non_blocking=True)
            slot.event = torch.cuda.Event()
            slot.event.record(stream)
        return out


class RankStreams:
    """The three stages' streams of one pipeline, and its pinned staging."""

    def __init__(self, device: torch.device):
        self.device = device
        self.h2d = torch.cuda.Stream(device)
        self.compute = torch.cuda.Stream(device)
        self.d2h = torch.cuda.Stream(device)
        self.stage = PinnedStage()
        self._local = threading.local()

    def _event(self, stream: torch.cuda.Stream) -> torch.cuda.Event:
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    # -- scatter -------------------------------------------------------------
    def staging(self) -> bool:
        """True inside :meth:`scattering` on this thread."""
        return getattr(self._local, "on", False)

    def put(self, host: np.ndarray) -> torch.Tensor:
        return self.stage.put(host, self.device, self.h2d)

    @contextlib.contextmanager
    def scattering(self):
        """Stage 1: bank puts of the grid inside go through pinned staging
        on ``h2d``."""
        self.stage.begin()
        self._local.on = True
        try:
            with torch.cuda.stream(self.h2d):
                yield
        finally:
            self._local.on = False

    def scattered(self) -> torch.cuda.Event:
        """Event behind everything scattered so far."""
        return self._event(self.h2d)

    def after(self, event: torch.cuda.Event | None) -> None:
        """Order the scatter stream after ``event`` (another stream set's
        copy of buffers this one reads, e.g. a resident chunk stored by
        another rank); None: nothing to wait for."""
        if event is not None:
            self.h2d.wait_event(event)

    # -- compute -------------------------------------------------------------
    @contextlib.contextmanager
    def computing(self, after: torch.cuda.Event, *uses):
        """Stage 2: run on ``compute`` once ``after`` has completed on the
        device, and behind the work already enqueued on the caller's
        current stream (a split's broadcasts and any device op it made,
        which ``uses`` reach the compute through); every CUDA tensor in
        ``uses`` is recorded on it."""
        self.compute.wait_event(after)
        self.compute.wait_stream(torch.cuda.current_stream(self.device))
        for t in _cuda_leaves(uses):
            t.record_stream(self.compute)
        with torch.cuda.stream(self.compute):
            yield

    def computed(self) -> torch.cuda.Event:
        return self._event(self.compute)

    # -- retrieve ------------------------------------------------------------
    def prefetch(self, outs, after: torch.cuda.Event):
        """Stage 3 begins: copy every CUDA tensor of ``outs`` into fresh
        pinned memory on ``d2h`` once ``after`` has completed.  Returns
        (the same nest with host tensors, the event to wait on)."""
        self.d2h.wait_event(after)

        def pull(t):
            if not (isinstance(t, torch.Tensor) and t.is_cuda):
                return t
            t.record_stream(self.d2h)
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            return host

        with torch.cuda.stream(self.d2h):
            host = tree_map(pull, outs)
        return host, self._event(self.d2h)

    @staticmethod
    def wait(event: torch.cuda.Event) -> None:
        """Block the host until ``event`` has completed (one stage's copy,
        not the whole device)."""
        event.synchronize()


class _NoStreams:
    """The stage interface of :class:`RankStreams` for a CPU grid: each
    stage runs directly, in order, and there is nothing to wait on."""

    def scattering(self):
        return contextlib.nullcontext()

    def scattered(self):
        return None

    def after(self, event) -> None:
        pass

    def computing(self, after, *uses):
        return contextlib.nullcontext()

    def computed(self):
        return None

    def prefetch(self, outs, after):
        return outs, None

    @staticmethod
    def wait(event) -> None:
        pass


NO_STREAMS = _NoStreams()


def release_cublas_workspaces() -> None:
    """Free the cuBLAS workspaces PyTorch keeps: one for every (cuBLAS
    handle, stream) pair that has run a matmul, 32 MiB each on Hopper,
    held until the process ends.  The rank pipelines run their matmuls on
    each rank's compute stream from a thread a rank, so a session of many
    ranks leaves hundreds of pairs (9.19 GB on an H100 after
    chip_smoke.py's session and tune phases, all of it these
    workspaces).  A later matmul on a pair takes its workspace again.
    Nothing without CUDA.

    It frees the workspaces of every thread and handle of the process, not
    only a caller's: call it only while no other thread is running cuBLAS,
    since a matmul that has taken its workspace but not yet launched would
    then use memory the allocator may hand to a new tensor."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None and torch.cuda.is_initialized():
        clear()
