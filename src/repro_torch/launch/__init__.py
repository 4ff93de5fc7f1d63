"""Launchers of the port: the one-GPU serve path (``serve``), for every
config family, and the one-GPU training path (``train``: train step and
``fit``).  The mesh and dry-run launchers are not ported yet (ROADMAP
queue 1, item 9)."""
from . import serve, train

__all__ = ["serve", "train"]
