"""Model stack of the port: the decoder of every config family
(``transformer`` over ``attention`` — self and cross — ``moe``, ``mamba``
and ``xlstm``), the reference-weight carry (``convert``) and the bridge to
the decode engine (``pim_bridge``).  Still missing: the training path,
``runtime/elastic``'s mesh helpers, the mesh and dry-run launchers, and
expert parallelism (ROADMAP queue 1, item 9)."""
from . import attention, transformer
from .layers import ModelConfig

__all__ = ["ModelConfig", "attention", "transformer"]
