"""Model stack of the port: the decoder of every config family
(``transformer`` over ``attention`` — self and cross — ``moe``, ``mamba``
and ``xlstm``) with its training loss (``transformer.loss_fn``), the
reference-weight carry both ways (``convert``) and the bridge to the
decode engine (``pim_bridge``).  Still missing: expert parallelism,
``runtime/elastic``'s mesh helpers, and the mesh and dry-run launchers
(ROADMAP queue 1, item 9)."""
from . import attention, transformer
from .layers import ModelConfig

__all__ = ["ModelConfig", "attention", "transformer"]
