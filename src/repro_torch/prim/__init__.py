"""PrIM — the paper's benchmark suite in banked-execution form, on one CUDA
device.  Ported so far (paper Table 2 order):
  GEMV gemv | SpMV spmv | HST-S/HST-L hist | RED red |
  SCAN-SSA/SCAN-RSS scan

``repro_torch.prim.registry`` is the single source of truth, as in the
reference: per-workload ``WorkloadEntry`` with ref/pim/chunked callables,
canonical benchmark args and the equivalence comparator.
"""
from . import gemv, hist, red, scan, spmv
from . import common, registry
from .registry import PIPELINEABLE, REGISTRY, SERIALIZED_ONLY

ALL = {name: e.module for name, e in REGISTRY.items()}

__all__ = (["ALL", "REGISTRY", "PIPELINEABLE", "SERIALIZED_ONLY",
            "common", "registry"]
           + sorted({m.__name__.split(".")[-1] for m in ALL.values()}))
