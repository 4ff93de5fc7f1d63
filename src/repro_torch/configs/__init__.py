"""Assigned-architecture configs (``--arch <id>``) + shape registry, copied
from ``repro.configs`` as plain data; ``input_specs`` gives meta-device
stand-ins for a cell's inputs (the dry-run's)."""
from .registry import (ARCHS, ARCH_IDS, SHAPES, Shape, get_config,
                       input_specs, is_subquadratic, skip_reason)

__all__ = ["ARCHS", "ARCH_IDS", "SHAPES", "Shape", "get_config",
           "input_specs", "is_subquadratic", "skip_reason"]
