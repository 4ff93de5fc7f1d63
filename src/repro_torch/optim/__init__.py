"""The optimizer of the port's training path: AdamW as the reference has
it (``repro.optim``), with the int8-compressed gradient all-reduce over a
process group."""
from .adamw import (AdamWConfig, apply, compress_int8, decompress_int8,
                    global_norm, init, psum_compressed, schedule)

__all__ = ["AdamWConfig", "apply", "compress_int8", "decompress_int8",
           "global_norm", "init", "psum_compressed", "schedule"]
