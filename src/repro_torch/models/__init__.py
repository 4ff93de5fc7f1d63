"""Model stack of the port: the decoder of every config family
(``transformer`` over ``attention`` — self and cross — ``moe``, ``mamba``
and ``xlstm``) with its training loss (``transformer.loss_fn``), the
reference-weight carry both ways (``convert``) and the bridge to the
decode engine (``pim_bridge``), on one GPU or on a mesh of ranks: every
entry of the reference's parameter specs (``transformer.param_specs``)
a shard by ``layers.layout`` — tensor parallelism and the experts over
"model", FSDP over "data" — expert parallelism (``moe.apply_ep``) and
the decode cache of a replicated batch split along the sequence over
"data" (``attention.merge_partials``) and the splits inside a head (a
rank's columns of the attention's, the mLSTM's or Mamba's heads cut a
head: it computes every head they touch, ``layers.head_split``); a
``parallel_block`` layer adds any mixer's partial sum to its FFN's; the
reference dry-run's ``tp1`` placement, its specs without "model"
(``transformer.Transformer(tp1=True)``).  Every config builds on every
mesh the reference's ``jax.jit`` accepts: ``transformer.check_ported``
refuses only what the reference refuses."""
from . import attention, moe, transformer
from .layers import ModelConfig

__all__ = ["ModelConfig", "attention", "moe", "transformer"]
