"""Model stack of the port: the dense-attention decoder (``attention``,
``transformer``), the reference-weight carry (``convert``) and the bridge
to the decode engine (``pim_bridge``).  MoE, Mamba, xLSTM and cross
attention are not ported yet (ROADMAP queue 1, item 9)."""
from . import attention, transformer
from .layers import ModelConfig

__all__ = ["ModelConfig", "attention", "transformer"]
