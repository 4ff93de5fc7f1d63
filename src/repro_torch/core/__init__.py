"""Core: banked (PIM-style) execution on one CUDA device, the analytical
performance models, the characterization harness and cost model, the
host↔bank transfer engine and the pipeline's streams — the counterpart of
``repro.core``."""
from .banked import BankGrid, RankGrid, make_bank_grid, make_rank_grid
from .perfmodel import (DpuModel, DpuSystemModel, GpuModel, RooflineTerms,
                        model_flops_decode, model_flops_train)
from . import characterize, costmodel, perfmodel, streams, transfer

__all__ = ["BankGrid", "RankGrid", "make_bank_grid", "make_rank_grid",
           "DpuModel", "DpuSystemModel", "GpuModel", "RooflineTerms",
           "model_flops_train", "model_flops_decode",
           "characterize", "costmodel", "perfmodel", "streams", "transfer"]
