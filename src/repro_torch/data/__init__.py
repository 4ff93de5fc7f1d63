"""The port's data pipeline: the reference's seekable synthetic batches
(``repro.data``)."""
from .pipeline import DataConfig, Loader, make_batch

__all__ = ["DataConfig", "Loader", "make_batch"]
