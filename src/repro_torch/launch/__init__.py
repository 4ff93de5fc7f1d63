"""Launchers of the port: the one-GPU serve path (``serve``), for every
config family.  The train, mesh and dry-run launchers are not ported yet
(ROADMAP queue 1, item 9)."""
from . import serve

__all__ = ["serve"]
