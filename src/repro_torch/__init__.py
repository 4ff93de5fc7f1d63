"""repro_torch — the PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
layout and names and imports nothing of it (nor JAX).  Ported so far: the
banked execution model (``core``), the hand-written Hopper kernels behind
the PrIM suite's GEMV, HST, RED and SCAN (``kernels``), and those four
workloads with their serialized ``pim()`` and chunked phases (``prim``).

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``:
``make_bank_grid(n_banks)`` raises when there is no CUDA device.
"""
from . import core, kernels, prim
from .core import make_bank_grid, make_rank_grid

__all__ = ["core", "kernels", "prim", "make_bank_grid", "make_rank_grid"]
