"""Hand-written Hopper kernels for the port's compute hot spots.

Layout mirrors ``repro.kernels``: one ``<name>.py`` per kernel (its CUDA
launch, launch counter and plain PyTorch version; the CUDA source is
``repro_torch/csrc/<name>.cu``), ``ops.py`` with the public wrappers
(padding, dtype policy, bank axis), ``ref.py`` with the plain oracles, and
``cuda_lib.py``, which builds the sources with ``nvcc`` at first use.

Ported so far: GEMV (PrIM §4.2), SpMV (§4.3), HST (§4.11), RED (§4.12),
SCAN (§4.13).
"""
from . import ops, ref

__all__ = ["ops", "ref"]
