"""PrIM workload registry of the port — the counterpart of
``repro.prim.registry``, with all of its 16 entries in its order.

One :class:`WorkloadEntry` per paper workload module (Table 2) with the
reference's ``section``, ``ref``, ``pim``, ``chunked``, ``make_args``,
``compare``, ``reason`` and ``variants``.  ``make_args`` is a copy of the
reference's generators: the same seed gives byte-identical arrays, which is
how both packages see the same inputs (there are no weights to carry
across).  NW and BFS register as serialized-only with the reference's
reasons: their inter-DPU exchange feeds every bank's next step, so the
runtime falls back to ``pim()`` for them.  ``cost_profile`` builds the
cost model's op table (``core/costmodel.py``).
"""
from __future__ import annotations

import dataclasses
import types
from typing import Callable, Mapping

import numpy as np

from repro_torch.core.transfer import tree_nbytes
from . import bfs, bs, gemv, gemv_fused, hist, mlp, nw, red, scan, sel, spmv
from . import trns, ts, uni, va
from .common import CHUNKED, ChunkedWorkload


# -- output equivalence ------------------------------------------------------

def assert_exact(a, b) -> None:
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def assert_close(a, b) -> None:
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-4, atol=1e-4)


def assert_ts(a, b) -> None:
    """(min_dist, argmin) pairs: distances within 1e-3, indices equal."""
    assert abs(a[0] - b[0]) < 1e-3, (a, b)
    assert int(a[1]) == int(b[1]), (a, b)


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

    def cost_profile(self, grid, args):
        """Op-count table + payload bytes for the cost model (DESIGN.md
        §15): pipelineable workloads count the aten ops of the chunked
        ``compute`` phase — the callable the pipeline runs — on a CPU grid
        of the same banks, so the profile cannot drift from the phase;
        NW/BFS decompose through host loops and return an ``untraced``
        profile with an empty op table."""
        from repro_torch.core.costmodel import profile_entry
        return profile_entry(grid, self, args)


# -- canonical argument generators (copies of the reference's) ---------------
# Sizes at scale=1 are test-sized; benchmarks pass larger scales.  Leading
# dimensions grow linearly with ``scale``.

def _args_va(rng, scale=1):
    n = 65536 * scale
    return (rng.integers(0, 99, n).astype(np.int32),
            rng.integers(0, 99, n).astype(np.int32))


def _args_gemv(rng, scale=1):
    return (rng.normal(size=(512 * scale, 256)).astype(np.float32),
            rng.normal(size=256).astype(np.float32))


def _args_gemv_b(rng, scale=1):
    return ({"w": rng.normal(size=(512 * scale, 256)).astype(np.float32),
             "b": rng.normal(size=512 * scale).astype(np.float32)},
            rng.normal(size=256).astype(np.float32))


def _args_gemv_g(rng, scale=1):
    return ({"wg": rng.normal(size=(256 * scale, 256)).astype(np.float32),
             "wu": rng.normal(size=(256 * scale, 256)).astype(np.float32)},
            rng.normal(size=256).astype(np.float32))


def _args_spmv(rng, scale=1):
    rows = 512 * scale
    ip, ix, dv = spmv.random_csr(rows, 256, 8, seed=int(rng.integers(1 << 30)))
    vals, cols = spmv.csr_to_ell(ip, ix, dv, rows)
    return vals, cols, rng.normal(size=256).astype(np.float32)


def _args_sel(rng, scale=1):
    return (rng.integers(0, 999, 65536 * scale).astype(np.int32),)


def _args_uni(rng, scale=1):
    return (np.sort(rng.integers(0, 99, 65536 * scale)).astype(np.int32),)


def _args_bs(rng, scale=1):
    return (np.sort(rng.integers(0, 1 << 20, 1 << 15)).astype(np.int32),
            rng.integers(0, 1 << 20, 4096 * scale).astype(np.int32))


def _args_ts(rng, scale=1):
    return (rng.normal(size=8192 * scale).astype(np.float32),
            rng.normal(size=64).astype(np.float32))


def _args_bfs(rng, scale=1):
    return bfs.random_graph(512 * scale, 4,
                            seed=int(rng.integers(1 << 30))), 0


def _args_mlp(rng, scale=1):
    return ([rng.normal(size=(256 * scale, 512)).astype(np.float32),
             rng.normal(size=(128, 256 * scale)).astype(np.float32)],
            rng.normal(size=512).astype(np.float32))


def _args_nw(rng, scale=1):
    return (rng.integers(0, 4, 64 * scale).astype(np.int32),
            rng.integers(0, 4, 64 * scale).astype(np.int32))


def _args_hst(rng, scale=1):
    return rng.integers(0, 256, 65536 * scale).astype(np.int32), 256


def _args_red(rng, scale=1):
    return (rng.integers(0, 99, 65536 * scale).astype(np.int32),)


def _args_scan(rng, scale=1):
    return (rng.integers(0, 9, 65536 * scale).astype(np.int32),)


def _args_trns(rng, scale=1):
    # N=512 keeps N' = 64 divisible by any simulated bank count up to 64
    return (rng.normal(size=(64 * scale, 512)).astype(np.float32),)


_NO_CHUNKS_NW = ("block anti-diagonal wavefront: every diagonal's boundaries "
                 "feed the next via the host (paper §4.10, Key Obs. 16) — "
                 "chunks are never independent; falls back to serialized "
                 "pim()")
_NO_CHUNKS_BFS = ("iterative frontier expansion: each level's host-side "
                  "frontier union feeds every bank's next level (paper §4.8, "
                  "Key Obs. 16) — chunks are never independent; falls back "
                  "to serialized pim()")


def _entries():
    e = WorkloadEntry
    return [
        e("VA", "§4.1", va, va.ref, va.pim, va.chunked, _args_va),
        e("GEMV", "§4.2", gemv, gemv.ref, gemv.pim, gemv.chunked,
          _args_gemv, assert_close),
        e("GEMV-B", "§4.2", gemv_fused, gemv_fused.ref_b, gemv_fused.pim_b,
          gemv_fused.chunked_b, _args_gemv_b, assert_close),
        e("GEMV-G", "§4.2", gemv_fused, gemv_fused.ref_g, gemv_fused.pim_g,
          gemv_fused.chunked_g, _args_gemv_g, assert_close),
        e("SpMV", "§4.3", spmv, spmv.ref, spmv.pim, spmv.chunked,
          _args_spmv, assert_close),
        e("SEL", "§4.4", sel, sel.ref, sel.pim, sel.chunked, _args_sel),
        e("UNI", "§4.5", uni, uni.ref, uni.pim, uni.chunked, _args_uni),
        e("BS", "§4.6", bs, bs.ref, bs.pim, bs.chunked, _args_bs),
        e("TS", "§4.7", ts, ts.ref, ts.pim, ts.chunked, _args_ts, assert_ts),
        e("BFS", "§4.8", bfs, bfs.ref, bfs.pim, None, _args_bfs,
          reason=_NO_CHUNKS_BFS),
        e("MLP", "§4.9", mlp, mlp.ref, mlp.pim, mlp.chunked,
          _args_mlp, assert_close),
        e("NW", "§4.10", nw, nw.ref, nw.pim, None, _args_nw,
          reason=_NO_CHUNKS_NW),
        e("HST", "§4.11", hist, hist.ref, hist.pim_short, hist.chunked,
          _args_hst,
          variants={"HST-S": hist.pim_short, "HST-L": hist.pim_long}),
        e("RED", "§4.12", red, red.ref, red.pim, red.chunked, _args_red),
        e("SCAN", "§4.13", scan, scan.ref, scan.pim_ssa, scan.chunked,
          _args_scan,
          variants={"SCAN-SSA": scan.pim_ssa, "SCAN-RSS": scan.pim_rss}),
        e("TRNS", "§4.14", trns, trns.ref, trns.pim, trns.chunked,
          _args_trns),
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
