"""Core: banked (PIM-style) execution on one CUDA device and the host↔bank
transfer engine — the ported part of ``repro.core``."""
from .banked import BankGrid, RankGrid, make_bank_grid, make_rank_grid
from . import transfer

__all__ = ["BankGrid", "RankGrid", "make_bank_grid", "make_rank_grid",
           "transfer"]
