"""Launchers of the port: the one-GPU serve path (``serve``).  The mesh,
train and dry-run launchers are not ported yet (ROADMAP queue 1, item 9)."""
from . import serve

__all__ = ["serve"]
