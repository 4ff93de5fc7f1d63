"""Shared machinery for the PrIM workload implementations — the PyTorch
counterpart of ``repro.prim.common``.

Every PrIM benchmark exposes:
  * ``ref(...)``            — gold semantics (numpy, host)
  * ``pim(grid, ...)``      — the paper's DPU decomposition on a BankGrid:
                              parallel CPU→DPU scatter, bank-local kernel
                              phase(s), explicit exchange phase(s), DPU→CPU
                              retrieve.  Returns (result, PhaseTimes).

``PhaseTimes`` reproduces the paper's stacked-bar breakdown:
CPU-DPU / DPU / Inter-DPU / DPU-CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.core.transfer import block_until_ready


@dataclasses.dataclass
class PhaseTimes:
    cpu_dpu: float = 0.0
    dpu: float = 0.0
    inter_dpu: float = 0.0
    dpu_cpu: float = 0.0

    @property
    def total(self) -> float:
        return self.cpu_dpu + self.dpu + self.inter_dpu + self.dpu_cpu

    def row(self, name: str, n_banks: int) -> dict:
        return {"benchmark": name, "banks": n_banks,
                "cpu_dpu_s": self.cpu_dpu, "dpu_s": self.dpu,
                "inter_dpu_s": self.inter_dpu, "dpu_cpu_s": self.dpu_cpu,
                "total_s": self.total}


class PhaseTimer:
    """Accumulates wall time per phase; each phase ends in :func:`sync`."""

    def __init__(self):
        self.times = PhaseTimes()

    class _Span:
        def __init__(self, outer, phase):
            self.outer, self.phase = outer, phase

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            setattr(self.outer.times, self.phase,
                    getattr(self.outer.times, self.phase) + dt)

    def phase(self, name: str) -> "_Span":
        return self._Span(self, name)


def pad_chunks(x: np.ndarray, n_banks: int, fill=0) -> tuple[np.ndarray, int]:
    """Split leading axis into n_banks equal chunks (paper: linear chunk
    assignment, chunk i → DPU i), padding the tail."""
    x = np.asarray(x)
    n = x.shape[0]
    per = -(-n // n_banks)
    pad = per * n_banks - n
    if pad:
        x = np.concatenate([x, np.full((pad,) + x.shape[1:], fill, x.dtype)])
    return x.reshape(n_banks, per, *x.shape[1:]), n


#: ``torch.cuda.synchronize`` on the device of every CUDA tensor in ``x``
#: (a no-op for CPU tensors); returns ``x``.
sync = block_until_ready


# ---------------------------------------------------------------------------
# chunked phase interface (for the pipelined runtime)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChunkedWorkload:
    """A PrIM workload factored into pipeline-composable phase callables.

    ``pim()`` stays the faithful serialized baseline.  ``chunked`` exposes
    the same decomposition as independent phases over input chunks:

      split(grid, n_chunks, *args) -> (meta, [chunk, ...])    host-side
      scatter(grid, meta, chunk)   -> device bufs             CPU→bank
      compute(grid, meta, bufs)    -> device outs             bank-local
      retrieve(grid, meta, outs)   -> host partial            bank→CPU
      merge(grid, meta, parts)     -> result                  host-side

    ``scatter``/``compute`` only enqueue device work; ``retrieve`` blocks.
    A workload whose dominant operand is a per-request constant declares
    it in ``resident_args`` and factors ``split`` into ``split_resident``
    and ``split_varying`` (DESIGN.md §12); ``split`` equals their
    composition.
    """
    name: str
    split: Callable
    scatter: Callable
    compute: Callable
    retrieve: Callable
    merge: Callable
    resident_args: tuple = ()
    split_resident: Callable | None = None
    split_varying: Callable | None = None
    #: True when the resident operand lives entirely in the resident meta
    #: rather than the chunk stream.
    meta_resident: bool = False

    @property
    def supports_residency(self) -> bool:
        return (bool(self.resident_args)
                and self.split_resident is not None
                and self.split_varying is not None)


#: name -> ChunkedWorkload, filled by workload modules at import time.
CHUNKED: dict[str, ChunkedWorkload] = {}


def register_chunked(w: ChunkedWorkload) -> ChunkedWorkload:
    CHUNKED[w.name] = w
    return w
