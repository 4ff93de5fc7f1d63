"""The port's checkpoint store: the reference's layout (``repro.checkpoint``)."""
from .store import Checkpointer

__all__ = ["Checkpointer"]
