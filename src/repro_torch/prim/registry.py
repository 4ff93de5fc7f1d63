"""PrIM workload registry of the port — the counterpart of
``repro.prim.registry`` for the workloads ported so far.

One :class:`WorkloadEntry` per paper workload module (Table 2) with the
reference's ``section``, ``ref``, ``pim``, ``chunked``, ``make_args``,
``compare`` and ``variants``.  ``make_args`` is a copy of the reference's
generators: the same seed gives byte-identical arrays, which is how both
packages see the same inputs (there are no weights to carry across).

Ported: GEMV, SpMV, HST, RED, SCAN.  Still to come, in the reference's
order: VA, GEMV-B, GEMV-G, SEL, UNI, BS, TS, BFS, MLP, NW, TRNS.  The
``cost_profile`` method waits for the cost model.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Callable, Mapping

import numpy as np

from repro_torch.core.transfer import tree_nbytes
from . import gemv, hist, red, scan, spmv
from .common import CHUNKED, ChunkedWorkload


# -- output equivalence ------------------------------------------------------

def assert_exact(a, b) -> None:
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def assert_close(a, b) -> None:
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-4, atol=1e-4)


# -- entry -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkloadEntry:
    name: str
    section: str                       # paper § of the DPU decomposition
    module: types.ModuleType
    ref: Callable
    pim: Callable                      # default serialized variant
    chunked: ChunkedWorkload | None
    make_args: Callable                # (rng, scale=1) -> args tuple
    compare: Callable = assert_exact   # compare(out_a, out_b) raises on mismatch
    reason: str = ""                   # non-empty iff not pipelineable
    variants: Mapping[str, Callable] = dataclasses.field(default_factory=dict)

    @property
    def pipelineable(self) -> bool:
        return self.chunked is not None

    @property
    def resident_args(self) -> tuple:
        """Positional arg indices of the residency-candidate operands
        (DESIGN.md §12) — () for workloads with nothing worth caching."""
        return self.chunked.resident_args if self.chunked is not None else ()

    @property
    def resident(self) -> bool:
        return (self.chunked is not None
                and self.chunked.supports_residency)

    def run_variants(self) -> Mapping[str, Callable]:
        """label -> serialized pim callable (scaling-table sweep)."""
        return self.variants or {self.name: self.pim}

    def arg_nbytes(self, args) -> int:
        """Input payload bytes of one invocation."""
        return tree_nbytes(args)


# -- canonical argument generators (copies of the reference's) ---------------
# Sizes at scale=1 are test-sized; benchmarks pass larger scales.  Leading
# dimensions grow linearly with ``scale``.

def _args_gemv(rng, scale=1):
    return (rng.normal(size=(512 * scale, 256)).astype(np.float32),
            rng.normal(size=256).astype(np.float32))


def _args_spmv(rng, scale=1):
    rows = 512 * scale
    ip, ix, dv = spmv.random_csr(rows, 256, 8, seed=int(rng.integers(1 << 30)))
    vals, cols = spmv.csr_to_ell(ip, ix, dv, rows)
    return vals, cols, rng.normal(size=256).astype(np.float32)


def _args_hst(rng, scale=1):
    return rng.integers(0, 256, 65536 * scale).astype(np.int32), 256


def _args_red(rng, scale=1):
    return (rng.integers(0, 99, 65536 * scale).astype(np.int32),)


def _args_scan(rng, scale=1):
    return (rng.integers(0, 9, 65536 * scale).astype(np.int32),)


def _entries():
    e = WorkloadEntry
    return [
        e("GEMV", "§4.2", gemv, gemv.ref, gemv.pim, gemv.chunked,
          _args_gemv, assert_close),
        e("SpMV", "§4.3", spmv, spmv.ref, spmv.pim, spmv.chunked,
          _args_spmv, assert_close),
        e("HST", "§4.11", hist, hist.ref, hist.pim_short, hist.chunked,
          _args_hst,
          variants={"HST-S": hist.pim_short, "HST-L": hist.pim_long}),
        e("RED", "§4.12", red, red.ref, red.pim, red.chunked, _args_red),
        e("SCAN", "§4.13", scan, scan.ref, scan.pim_ssa, scan.chunked,
          _args_scan,
          variants={"SCAN-SSA": scan.pim_ssa, "SCAN-RSS": scan.pim_rss}),
    ]


#: name -> WorkloadEntry, paper Table 2 order.
REGISTRY: dict[str, WorkloadEntry] = {e.name: e for e in _entries()}

#: names with a chunked phase interface (consumed by the runtime pipeline).
PIPELINEABLE = tuple(n for n, e in REGISTRY.items() if e.pipelineable)

#: names that only run serialized, with the documented reason.
SERIALIZED_ONLY = {n: e.reason for n, e in REGISTRY.items()
                   if not e.pipelineable}

# every registered ChunkedWorkload must have a registry entry and vice versa
assert set(PIPELINEABLE) == set(CHUNKED), (sorted(PIPELINEABLE),
                                           sorted(CHUNKED))
