"""Assigned-architecture configs (``--arch <id>``) + shape registry, copied
from ``repro.configs`` as plain data.  ``input_specs`` is not ported (it
builds JAX dry-run stand-ins)."""
from .registry import (ARCHS, ARCH_IDS, SHAPES, Shape, get_config,
                       is_subquadratic, skip_reason)

__all__ = ["ARCHS", "ARCH_IDS", "SHAPES", "Shape", "get_config",
           "is_subquadratic", "skip_reason"]
