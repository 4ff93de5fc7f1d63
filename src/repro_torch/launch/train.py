"""Train step + driver loop on one GPU — the counterpart of
``repro.launch.train``.

``make_train_step`` builds a (model, opt_state, batch) → (model,
opt_state, metrics) step that updates the model and the optimizer state
in place, with:
  * gradient-accumulation microbatching (``microbatches`` > 1): each
    microbatch's gradients from ``torch.autograd.grad``, summed into
    float32 and divided, as the reference's scan sums into float32 zeros
    (``.backward()`` would accumulate in the parameters' dtype); the loss
    is the microbatches' mean;
  * optional int8 gradient compression (``compress_grads``): the
    reference's compressed data-parallel reduction over a one-device
    group (``optim.psum_compressed``).

The reference's batch and parameter shardings have no one-GPU meaning:
``to_device`` is ``shard_batch``, and the model lives on one device.
No kernel lies on the gradient path: the reference has no backward for
its Pallas kernels and trains with ``use_kernel=False``, and
``use_kernel=True`` raises here (the CUDA wrappers refuse autograd
inputs, ``kernels/cuda_lib.require_cuda``).

The driver loop (``fit``) wires in the substrate: checkpointing (atomic +
async, the reference's tree layout through ``models.convert``, so a
checkpoint of either package resumes in the other), straggler monitoring
and deterministic seekable data.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.core.banked import _device
from repro_torch.models import convert, transformer
from repro_torch.models.layers import ModelConfig

#: what ``make_train_step(use_kernel=True)`` raises
_NO_KERNEL_GRAD = (
    "use_kernel=True: the reference has no backward for its Pallas kernels "
    "(no custom_vjp) and trains with use_kernel=False; the port's CUDA "
    "kernels have none either (ROADMAP queue 1, item 9.5)")


def init_state(seed: int, cfg: ModelConfig, device=None):
    """A seeded model with trainable parameters on ``device`` (default
    ``cuda:0``) and its optimizer state -> (model, opt_state)."""
    model = transformer.init(cfg, seed=seed, device=device)
    model.requires_grad_(True)
    return model, optim.init(dict(model.named_parameters()))


def to_device(batch: dict, cfg: ModelConfig, device=None) -> dict:
    """A batch of numpy arrays (``data.make_batch``'s keys for ``cfg``'s
    family) as tensors on ``device`` (default ``cuda:0``), dtypes kept:
    the reference's ``shard_batch``."""
    keys = {"labels", "embeds" if cfg.family == "audio" else "tokens"}
    keys |= {"frontend"} if cfg.family == "vlm" else set()
    if set(batch) != keys:
        raise ValueError(f"{cfg.name}: batch keys {sorted(batch)}, want "
                         f"{sorted(keys)}")
    dev = _device(device)
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _split(batch: dict, n: int) -> list[dict]:
    B = batch["labels"].shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    return [{k: v[i * B // n:(i + 1) * B // n] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(cfg: ModelConfig, ocfg: optim.AdamWConfig, *,
                    microbatches: int = 1, use_kernel: bool = False,
                    compress_grads: bool = False, loss_chunks: int = 0):
    """The step (model, opt_state, batch) -> (model, opt_state, {"loss",
    "grad_norm", "lr"}); the model's parameters and ``opt_state`` are
    updated in place.  ``use_kernel=True`` raises on every device, so
    that the CPU does not differentiate the plain versions where the
    card would refuse."""
    if use_kernel:
        raise NotImplementedError(_NO_KERNEL_GRAD)

    def grads_of(model, params: dict, batch: dict):
        """(loss, {name: grad or None}) of one batch."""
        leaves = list(params.values())
        if microbatches == 1:
            loss, _ = transformer.loss_fn(model, cfg, batch,
                                          loss_chunks=loss_chunks)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            return loss.detach(), dict(zip(params, g))
        gsum: dict = dict.fromkeys(params)
        lsum = torch.zeros((), dtype=torch.float32, device=model.device)
        for b in _split(batch, microbatches):
            loss, _ = transformer.loss_fn(model, cfg, b,
                                          loss_chunks=loss_chunks)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            for k, gk in zip(params, g):
                if gk is not None:
                    gk = gk.to(torch.float32)
                    gsum[k] = gk if gsum[k] is None else gsum[k] + gk
            lsum = lsum + loss.detach()
        return lsum / microbatches, {
            k: None if g is None else g / microbatches
            for k, g in gsum.items()}

    def step(model, opt_state: dict, batch: dict):
        params = dict(model.named_parameters())
        loss, grads = grads_of(model, params, batch)
        if compress_grads:
            grads = optim.psum_compressed(grads)
        _, opt_state, om = optim.apply(ocfg, grads, opt_state, params)
        return model, opt_state, {"loss": loss, **om}

    return step


def fit(cfg: ModelConfig, *, steps: int, data_loader,
        ocfg: optim.AdamWConfig | None = None, seed: int = 0,
        checkpointer=None, checkpoint_every: int = 0, monitor=None,
        microbatches: int = 1, use_kernel: bool = False, log_every: int = 10,
        log=print, device=None):
    """End-to-end training driver with restart support, on ``device``
    (default ``cuda:0``) -> (model, opt_state, loss history)."""
    ocfg = ocfg or optim.AdamWConfig(total_steps=steps)
    dev = _device(device)
    start = 0
    if checkpointer is not None and checkpointer.latest_step() is not None:
        tree, man = checkpointer.restore()
        model = convert.params_from_reference(tree["params"], cfg,
                                              device=dev)
        model.requires_grad_(True)
        opt_state = convert.opt_state_from_reference(tree["opt"], cfg,
                                                     device=dev)
        start = man["step"]
        log(f"[train] resumed from step {start}")
    else:
        model, opt_state = init_state(seed, cfg, dev)
    step_fn = make_train_step(cfg, ocfg, microbatches=microbatches,
                              use_kernel=use_kernel)
    data_loader.step = start
    history = []
    for i in range(start, steps):
        batch = to_device(next(data_loader), cfg, dev)
        if monitor:
            monitor.start_step()
        model, opt_state, m = step_fn(model, opt_state, batch)
        loss = float(m["loss"])         # waits for the step
        if monitor:
            monitor.end_step(i)
        history.append(loss)
        if log_every and (i % log_every == 0 or i == steps - 1):
            log(f"[train] step {i} loss {loss:.4f} "
                f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.3f}")
        if checkpointer is not None and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            # the reference's layout: the parameters as tensors (bfloat16
            # stays bfloat16), the optimizer state as float32 / int32 arrays
            checkpointer.save(i + 1, {
                "params": convert.reference_tree(
                    dict(model.named_parameters()), cfg),
                "opt": convert.opt_state_to_reference(opt_state, cfg)})
    if checkpointer is not None:
        checkpointer.wait()
    return model, opt_state, history
