"""Launchers of the port, on one GPU or on a mesh of ranks
(``torch.distributed``): the serve path (``serve``) for every config
family, the training path (``train``: train step and ``fit``, data, tensor and
expert parallel, FSDP, elastic restart), the production mesh and the rank
launcher (``mesh``), and the dry-run (``dryrun``: one rank of every
arch × shape × mesh cell traced on the meta device over a fake process
group; run as ``python -m repro_torch.launch.dryrun``, so not imported
here)."""
from . import mesh, serve, train

__all__ = ["mesh", "serve", "train"]
