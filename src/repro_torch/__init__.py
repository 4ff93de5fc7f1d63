"""repro_torch — the PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
layout and names and imports nothing of it (nor JAX).  Ported so far: the
banked execution model (``core``), the hand-written Hopper kernels behind
the PrIM suite's GEMV, SpMV, HST, RED and SCAN (``kernels``), those five
workloads with their serialized ``pim()`` and chunked phases (``prim``),
the pipelined runtime beneath the session (``runtime``), the session
façade itself (``pim``), the LM stack of every config family: the configs
(``configs``), the decoder with its hand-written flash attention, MoE and
SSM kernels (``models``), greedy decode (``launch.serve``) and the decode
engine on the session (``pim.DecodeEngine``), and its training path: the
optimizer (``optim``), the data pipeline (``data``), the checkpoint store
(``checkpoint``) and the train step and ``fit`` (``launch.train``):

    from repro_torch import pim
    with pim.session(ranks=32, banks_per_rank=64) as s:
        y = s.run("GEMV", A, x)

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``:
``make_bank_grid(n_banks)``, ``pim.session()`` and the model constructors
raise when there is no CUDA device.
"""
from . import (checkpoint, configs, core, data, kernels, launch, models,
               optim, pim, prim, runtime)
from .core import make_bank_grid, make_rank_grid

__all__ = ["checkpoint", "configs", "core", "data", "kernels", "launch",
           "models", "optim", "pim", "prim", "runtime", "make_bank_grid",
           "make_rank_grid"]
