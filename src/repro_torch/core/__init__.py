"""Core: banked (PIM-style) execution on one CUDA device, the host↔bank
transfer engine, the pipeline's streams, and the residency budget's MRAM
model — the ported part of ``repro.core``."""
from .banked import BankGrid, RankGrid, make_bank_grid, make_rank_grid
from . import perfmodel, streams, transfer

__all__ = ["BankGrid", "RankGrid", "make_bank_grid", "make_rank_grid",
           "perfmodel", "streams", "transfer"]
