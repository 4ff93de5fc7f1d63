"""PrIM — the paper's benchmark suite in banked-execution form, on one CUDA
device.  All 16 workloads of the reference (paper Table 2 order):
  VA va | GEMV gemv | GEMV-B/GEMV-G gemv_fused | SpMV spmv | SEL sel |
  UNI uni | BS bs | TS ts | BFS bfs | MLP mlp | NW nw |
  HST-S/HST-L hist | RED red | SCAN-SSA/SCAN-RSS scan | TRNS trns

``repro_torch.prim.registry`` is the single source of truth, as in the
reference: per-workload ``WorkloadEntry`` with ref/pim/chunked callables,
canonical benchmark args and the equivalence comparator.
"""
from . import bfs, bs, gemv, gemv_fused, hist, mlp, nw, red, scan, sel, spmv
from . import trns, ts, uni, va
from . import common, registry
from .registry import PIPELINEABLE, REGISTRY, SERIALIZED_ONLY

ALL = {name: e.module for name, e in REGISTRY.items()}

__all__ = (["ALL", "REGISTRY", "PIPELINEABLE", "SERIALIZED_ONLY",
            "common", "registry"]
           + sorted({m.__name__.split(".")[-1] for m in ALL.values()}))
