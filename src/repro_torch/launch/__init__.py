"""Launchers of the port, on one GPU or on a mesh of ranks
(``torch.distributed``): the serve path (``serve``) for every config
family, the training path (``train``: train step and ``fit``, data, tensor and
expert parallel, FSDP, elastic restart) and the production mesh and the rank
launcher (``mesh``).  The dry-run is not ported yet (ROADMAP queue 1, item
9.8)."""
from . import mesh, serve, train

__all__ = ["mesh", "serve", "train"]
