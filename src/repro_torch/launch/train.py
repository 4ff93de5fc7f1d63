"""Train step + driver loop, on one GPU or on a mesh of ranks — the
counterpart of ``repro.launch.train``.

``make_train_step`` builds a (model, opt_state, batch) → (model,
opt_state, metrics) step that updates the model and the optimizer state
in place, with:
  * the batch split over the data axes ("pod", "data") of ``mesh``: each
    data rank takes its rows of the global batch (``shard_batch``, the
    reference's ``P(data_axes, None)``); the loss is the global mean, and
    each gradient the mean of the data ranks' (a leaf split over "model"
    — tensor parallelism's dense leaves, the experts — has the gradient
    of its part, the rank's own; a replicated leaf has the same whole
    gradient on every rank of the "model" axis, so nothing is summed
    over "model"; an FSDP leaf's gradient arrives summed over "data" by
    its gather's backward, a reduce-scatter, and is only divided, and
    summed over "pod" where the mesh has one); the gradient norm sums
    each split leaf's squares over the axes it is split over;
  * gradient-accumulation microbatching (``microbatches`` > 1): each
    microbatch's gradients from ``torch.autograd.grad``, summed into
    float32 and divided, as the reference's scan sums into float32 zeros
    (``.backward()`` would accumulate in the parameters' dtype); the loss
    is the microbatches' mean (on a mesh, of the rank's rows);
  * optional int8 gradient compression (``compress_grads``): the data
    ranks' gradients divided by their count and summed by
    ``optim.psum_compressed`` over each data axis in turn (pure
    data-parallel meshes only: a "model" axis larger than 1 raises, as the
    reference's does); an FSDP leaf enters whole, its mean gradient on
    every rank, as the reference's ``_compressed_dp_grads`` takes the
    whole gradient tree (``in_specs=P()``), and the rank keeps its block;
    with ``mesh=None``, over a one-device group.

Parameters follow the reference's spec tree (``transformer.param_specs``):
every entry is a shard — "model" (tensor parallelism and the experts)
and "data" (FSDP, ZeRO-3: each layer's leaves gathered just before use,
with remat gathered again in the backward's recompute, every rank in the
same order) — and the optimizer state of a rank is its parts'.
No kernel lies on the gradient path: the reference has no backward for
its Pallas kernels and trains with ``use_kernel=False``, and
``use_kernel=True`` raises here (the CUDA wrappers refuse autograd
inputs, ``kernels/cuda_lib.require_cuda``).

The driver loop (``fit``) wires in the substrate: checkpointing (atomic +
async, the reference's tree layout through ``models.convert``, written
by rank 0 with the sharded leaves gathered whole, so a checkpoint of
either package resumes in the other, on a mesh of any shape), straggler
monitoring, deterministic seekable data, and elastic restart (restore
onto whatever mesh is alive, through the whole checkpoint).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.core import sharding
from repro_torch.core.banked import _device
from repro_torch.core.sharding import P, axis_size, data_axes
from repro_torch.models import convert, transformer
from repro_torch.models.layers import ModelConfig

#: what ``make_train_step(use_kernel=True)`` raises
_NO_KERNEL_GRAD = (
    "use_kernel=True: the reference has no backward for its Pallas kernels "
    "(no custom_vjp) and trains with use_kernel=False; the port's CUDA "
    "kernels have none either (ROADMAP queue 1, item 9.5)")


def batch_specs(cfg: ModelConfig, mesh) -> dict:
    dp = data_axes(mesh)
    spec = {"labels": P(dp, None)}
    if cfg.family == "audio":
        spec["embeds"] = P(dp, None, None)
    else:
        spec["tokens"] = P(dp, None)
    if cfg.family == "vlm":
        spec["frontend"] = P(dp, None, None)
    return spec


def opt_state_specs(param_specs) -> dict:
    return {"master": param_specs, "mu": param_specs, "nu": param_specs,
            "step": P()}


def init_state(seed: int, cfg: ModelConfig, device=None, mesh=None):
    """A seeded model with trainable parameters on ``device`` (default
    ``cuda:0``), built on ``mesh`` (the rank's part of each sharded leaf),
    and its optimizer state -> (model, opt_state)."""
    model = transformer.init(cfg, seed=seed, device=device, mesh=mesh)
    model.requires_grad_(True)
    return model, optim.init(dict(model.named_parameters()))


def to_device(batch: dict, cfg: ModelConfig, device=None) -> dict:
    """A batch of numpy arrays (``data.make_batch``'s keys for ``cfg``'s
    family) as tensors on ``device`` (default ``cuda:0``), dtypes kept:
    the reference's ``shard_batch`` on one device."""
    keys = {"labels", "embeds" if cfg.family == "audio" else "tokens"}
    keys |= {"frontend"} if cfg.family == "vlm" else set()
    if set(batch) != keys:
        raise ValueError(f"{cfg.name}: batch keys {sorted(batch)}, want "
                         f"{sorted(keys)}")
    dev = _device(device)
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _dp(mesh) -> tuple[str, ...]:
    """The data axes ``mesh`` has."""
    dp = data_axes(mesh)
    dp = (dp,) if isinstance(dp, str) else dp
    return tuple(a for a in dp if a in sharding.mesh_shape(mesh))


def rows(n: int, mesh, axes=None) -> slice:
    """This rank's rows of ``n`` split over the data axes of ``mesh``, or
    over ``axes`` (the first major: the reference's ``P(axes, ...)``)."""
    dp = _dp(mesh) if axes is None else tuple(axes)
    D = axis_size(mesh, dp)
    if n % D:
        what = "data ranks" if axes is None else f"ranks of {dp}"
        raise ValueError(f"batch {n} does not split over {D} {what}")
    i = sharding.axis_index(mesh, dp)
    return slice(i * n // D, (i + 1) * n // D)


def shard_batch(batch: dict, cfg: ModelConfig, mesh=None, device=None) -> dict:
    """The global batch (numpy arrays) -> this rank's rows on ``device``
    (the reference's ``P(data_axes, None)``); without a mesh, the whole
    batch (``to_device``)."""
    if mesh is not None:
        batch = {k: v[rows(len(v), mesh)] for k, v in batch.items()}
    return to_device(batch, cfg, device)


def _split(batch: dict, n: int) -> list[dict]:
    B = batch["labels"].shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    return [{k: v[i * B // n:(i + 1) * B // n] for k, v in batch.items()}
            for i in range(n)]


def _fsdp(model) -> dict:
    """The model's FSDP leaves: name -> their ``Split`` over "data"."""
    return {k: lay.split("data")
            for k, lay in transformer.sharded_leaves(model).items()
            if lay.split("data")}


def make_grads(cfg: ModelConfig, mesh=None, *, microbatches: int = 1,
               loss_chunks: int = 0):
    """``grads(model, batch)`` -> (loss, {name: grad or None}): the loss of
    the global batch and each parameter's gradient of it, averaged over
    the data ranks of ``mesh`` (the rank's own for the leaves it holds a
    part of; identical on every model rank otherwise), before any
    compression.  An FSDP leaf's gradient is its block, summed over
    "data" by the gather's backward: it is divided by the data ranks'
    count and summed over the other data axes alone."""
    dp = _dp(mesh) if mesh is not None else ()
    D = axis_size(mesh, dp) if dp else 1
    rest = tuple(a for a in dp if a != "data")

    def local(model, params: dict, batch: dict):
        """(loss, {name: grad or None}) of this rank's rows."""
        leaves = list(params.values())
        if microbatches == 1:
            loss, _ = transformer.loss_fn(model, cfg, batch,
                                          loss_chunks=loss_chunks, mesh=mesh)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            return loss.detach(), dict(zip(params, g))
        gsum: dict = dict.fromkeys(params)
        lsum = torch.zeros((), dtype=torch.float32, device=model.device)
        for b in _split(batch, microbatches):
            loss, _ = transformer.loss_fn(model, cfg, b,
                                          loss_chunks=loss_chunks, mesh=mesh)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            for k, gk in zip(params, g):
                if gk is not None:
                    gk = gk.to(torch.float32)
                    gsum[k] = gk if gsum[k] is None else gsum[k] + gk
            lsum = lsum + loss.detach()
        return lsum / microbatches, {
            k: None if g is None else g / microbatches
            for k, g in gsum.items()}

    def grads(model, batch: dict, mean: bool = True):
        """``mean=False`` leaves each rank's own gradients (the compressed
        reduction sums them; an FSDP leaf's block is already summed over
        "data")."""
        loss, g = local(model, dict(model.named_parameters()), batch)
        if D > 1:
            loss = sharding.all_reduce(loss.clone(), mesh, dp) / D
            if mean:
                fsdp = _fsdp(model)
                g = {k: None if v is None else sharding.all_reduce(
                         v, mesh, rest if k in fsdp else dp).div_(D)
                     for k, v in g.items()}
        return loss, g

    return grads


def make_train_step(cfg: ModelConfig, ocfg: optim.AdamWConfig, mesh=None, *,
                    microbatches: int = 1, use_kernel: bool = False,
                    compress_grads: bool = False, loss_chunks: int = 0):
    """The step (model, opt_state, batch) -> (model, opt_state, {"loss",
    "grad_norm", "lr"}); the model's parameters and ``opt_state`` are
    updated in place.  On ``mesh`` the batch is this rank's rows
    (``shard_batch``).  ``use_kernel=True`` raises on every device, so
    that the CPU does not differentiate the plain versions where the
    card would refuse."""
    if use_kernel:
        raise NotImplementedError(_NO_KERNEL_GRAD)
    if compress_grads and mesh is not None and \
            sharding.mesh_shape(mesh).get("model", 1) != 1:
        raise ValueError("compress_grads requires model axis of size 1")
    grads_of = make_grads(cfg, mesh, microbatches=microbatches,
                          loss_chunks=loss_chunks)
    dp = _dp(mesh) if mesh is not None else ()
    D = axis_size(mesh, dp) if dp else 1

    def step(model, opt_state: dict, batch: dict):
        params = dict(model.named_parameters())
        loss, grads = grads_of(model, batch, mean=not compress_grads)
        if compress_grads:
            fsdp = _fsdp(model) if D > 1 else {}
            grads = {k: None if g is None else
                     (_whole_mean(g, fsdp[k], mesh, dp, D) if k in fsdp
                      else g) / D for k, g in grads.items()}
            for a in dp if D > 1 else (None,):
                grads = optim.psum_compressed(
                    grads, a and mesh.get_group(a))
            grads = {k: g if k not in fsdp else fsdp[k].take(
                         g, sharding.axis_index(mesh, "data"))
                     for k, g in grads.items()}
        sharded = {k: lay.axes for k, lay in
                   transformer.sharded_leaves(model).items()}
        kw = {"sharded": sharded, "mesh": mesh} if sharded else {}
        _, opt_state, om = optim.apply(ocfg, grads, opt_state, params, **kw)
        return model, opt_state, {"loss": loss, **om}

    return step


def _whole_mean(g: torch.Tensor, split, mesh, dp, D: int) -> torch.Tensor:
    """An FSDP leaf's mean gradient whole, the same on every rank: its
    block (summed over "data") summed over the other data axes, gathered
    over "data" and divided by the data ranks' count."""
    g = sharding.all_reduce(g, mesh, tuple(a for a in dp if a != "data"))
    return sharding.gather(g, mesh, "data", split.dim) / D


def _checkpoint_tree(model, opt_state: dict, cfg: ModelConfig) -> dict:
    """The reference's layout: the parameters as tensors (bfloat16 stays
    bfloat16), the optimizer state as float32 / int32 arrays, the sharded
    leaves whole (every rank of a model group takes part)."""
    return {"params": convert.reference_tree(
                convert.whole(dict(model.named_parameters()), model), cfg),
            "opt": convert.opt_state_to_reference(opt_state, cfg, model)}


def fit(cfg: ModelConfig, *, steps: int, data_loader,
        ocfg: optim.AdamWConfig | None = None, seed: int = 0,
        checkpointer=None, checkpoint_every: int = 0, monitor=None,
        microbatches: int = 1, use_kernel: bool = False, log_every: int = 10,
        log=print, device=None, mesh=None):
    """End-to-end training driver with restart support, on ``device``
    (default ``cuda:0``) -> (model, opt_state, loss history).  On ``mesh``
    every rank of it calls ``fit``: each takes its rows of the loader's
    global batches, rank 0 writes the checkpoints (whole), and a restart
    restores onto whatever mesh it is given, each rank taking its part
    (carve, restore, continue at step k)."""
    ocfg = ocfg or optim.AdamWConfig(total_steps=steps)
    dev = _device(device)
    rank0 = mesh is None or dist.get_rank() == int(mesh.mesh.flatten()[0])
    start = 0
    if checkpointer is not None and checkpointer.latest_step() is not None:
        tree, man = checkpointer.restore()
        model = convert.params_from_reference(tree["params"], cfg,
                                              device=dev, mesh=mesh)
        model.requires_grad_(True)
        opt_state = convert.opt_state_from_reference(tree["opt"], cfg,
                                                     device=dev, model=model)
        start = man["step"]
        log(f"[train] resumed from step {start}")
    else:
        model, opt_state = init_state(seed, cfg, dev, mesh)
    step_fn = make_train_step(cfg, ocfg, mesh, microbatches=microbatches,
                              use_kernel=use_kernel)
    data_loader.step = start
    history = []
    for i in range(start, steps):
        batch = shard_batch(next(data_loader), cfg, mesh, dev)
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
            tree = _checkpoint_tree(model, opt_state, cfg)
            if rank0:
                checkpointer.save(i + 1, tree)
    if checkpointer is not None:
        checkpointer.wait()
        if mesh is not None:            # the last save is on disk for all
            sharding.barrier(mesh)
    return model, opt_state, history
