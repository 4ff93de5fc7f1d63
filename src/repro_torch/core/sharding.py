"""Partition specs, meshes and the collectives of the model path — what the
reference takes from ``jax.sharding``, ``shard_map`` and ``jax.lax``'s
``psum`` / ``pmean``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dimension
names are the reference's axis names (``"pod"``, ``"data"``, ``"model"``);
a rank is one process.  The pure helpers (``mesh_shape``, ``data_axes``,
``axis_size``) also take a mapping ``{axis: size}`` in the mesh's
dimension order, so a spec is computed without a process group.

``P`` is the reference's ``PartitionSpec``: one entry per tensor
dimension, ``None`` (replicated), an axis name, or a tuple of names
(sharded over their product, the first major).  Its meaning is copied,
not imported.

The collectives reduce over one mesh axis after another (a sum or a max
over the product of axes is the same thing); each call adds to ``STATS``
its host seconds, which include waiting for the device work that made the
operand.  The autograd functions carry tensor and expert parallelism
(Megatron's conjugate pair and its kin): ``reduce_from`` sums forward and
passes the gradient through; ``copy_to`` passes the value through and
sums the gradient; ``reduce_both`` sums both ways (a sum that each rank
then uses for its own part); ``gather`` concatenates the ranks' blocks
and gives each rank its block of the gradient; ``fsdp_gather`` (ZeRO-3's
gather of a leaf FSDP splits over "data") concatenates the blocks and
reduce-scatters the gradient: the whole gradient summed over the axis,
each rank keeping its block.  ``Group`` holds one mesh
axis as a rank sees it (its size, the rank's index, those collectives),
and ``SOLO`` is the group of one, whose collectives return their input.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping

import torch
import torch.distributed as dist


class P(tuple):
    """The reference's ``PartitionSpec``: ``P("data", None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def mesh_device_type(device_type: str | None) -> str:
    """``device_type`` of a mesh; None means ``"cuda"`` and raises when
    there is no CUDA device (the CPU is only ever asked for)."""
    if device_type is not None:
        return device_type
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' for a mesh of CPU ranks")
    return "cuda"


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a DeviceMesh (or of such a mapping), in the
    mesh's dimension order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> tuple[str, ...] | str:
    """The batch-sharding axes: ('pod','data') on multi-pod, 'data'
    otherwise."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else "data"


def axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    shape = mesh_shape(mesh)
    n = 1
    for a in names:
        n *= shape[a]
    return n


def _names(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def other_axes(mesh, axis: str) -> tuple[str, ...]:
    """The mesh's axes but ``axis``, in order (the reference's ``dp`` of
    ``apply_ep``)."""
    return tuple(a for a in mesh_shape(mesh) if a != axis)


def axis_index(mesh, axes) -> int:
    """This rank's index along the product of ``axes`` (the first major):
    its block of a dimension sharded as ``P(axes)``."""
    shape, i = mesh_shape(mesh), 0
    for a in _names(axes):
        i = i * shape[a] + mesh.get_local_rank(a)
    return i


def block(n: int, mesh, axis: str = "model") -> slice:
    """This rank's block of ``n`` split evenly over ``axis`` (no
    communication); ``n`` must divide."""
    return Group(mesh, axis, axis_size(mesh, axis),
                 axis_index(mesh, axis)).block(n)


def member(mesh) -> bool:
    """Whether this rank is in ``mesh`` (``simulate_failure`` leaves the
    lost ranks outside)."""
    return mesh.get_coordinate() is not None


#: calls, host seconds and bytes of the collectives since ``reset_stats``;
#: the ``fsdp_`` keys count the FSDP gathers and their reduce-scatters
#: alone (``fsdp_gather``), the ``merge_`` keys the decode's merges of a
#: sequence-sharded cache's partial softmaxes, the ``heads_`` keys the
#: forward gathers of the heads a rank's columns do not hold whole
#: (``layers.gather_blocks``) (``counted_as``), which the first three
#: count too
STATS = {"calls": 0, "seconds": 0.0, "bytes": 0,
         "fsdp_calls": 0, "fsdp_seconds": 0.0, "fsdp_bytes": 0,
         "merge_calls": 0, "merge_seconds": 0.0, "merge_bytes": 0,
         "heads_calls": 0, "heads_seconds": 0.0, "heads_bytes": 0}


#: None, or a list to which every collective appends (kind, operand
#: bytes, ranks of its group): an "all-reduce" its operand, an
#: "all-gather" and a "reduce-scatter" their input (``launch.dryrun``'s
#: count, the rule of the reference's ``core/hlo.py``)
TAPE = None


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0.0 if k.endswith("seconds") else 0


def _nccl(group) -> bool:
    """Whether ``group`` takes NCCL's paths: NCCL's own, and PyTorch's
    ``fake`` backend, which stands for a mesh of cards in the dry-run."""
    return dist.get_backend(group) in ("nccl", "fake")


def _count(t0: float, nbytes: int, kind: str, operand: int, n: int) -> None:
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    STATS["bytes"] += nbytes
    if TAPE is not None:
        TAPE.append((kind, operand, n))


def all_reduce(t: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM):
    """``t`` reduced in place over the mesh axes ``axes`` (a name or a
    tuple; axes of size 1 cost nothing); returns ``t``."""
    shape = mesh_shape(mesh)
    for a in _names(axes):
        if shape.get(a, 1) > 1:
            t0 = time.perf_counter()
            dist.all_reduce(t, op=op, group=mesh.get_group(a))
            nbytes = t.numel() * t.element_size()
            _count(t0, nbytes, "all-reduce", nbytes, shape[a])
    return t


def barrier(mesh) -> None:
    """Every rank of ``mesh`` has arrived: a barrier over each axis in
    turn (after the last, each rank knows that every rank of every group
    it waited on has passed the one before)."""
    for a, n in mesh_shape(mesh).items():
        if n > 1:
            dist.barrier(group=mesh.get_group(a))


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0):
    """The blocks of ``t`` held along ``axis``, concatenated on ``dim`` in
    the axis's order, on the CPU.  Over gloo the gather runs on host
    copies (gloo gathers no CUDA tensor); over NCCL on the device."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t.detach().cpu()
    group = mesh.get_group(axis)
    src = t.detach().contiguous()
    if dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat([p.cpu() for p in parts], dim=dim)


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.mesh, ctx.axis), None, None


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of each rank's partial ``x`` (the combine);
    the gradient reaches each rank's part whole, once."""
    return _ReduceFrom.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x``, replicated over ``axis``, entering work that each rank does
    for its own part: the gradients of the parts are summed."""
    return _CopyTo.apply(x, mesh, axis)


class _ReduceBoth(torch.autograd.Function):
    """All-reduce forward and backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.mesh, ctx.axis), None, None


def reduce_both(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of each rank's partial ``x``, which each rank
    then uses for its own part: the gradients of those uses are summed
    too (``reduce_from``'s identity backward would give each rank its own
    use's share)."""
    return _ReduceBoth.apply(x, mesh, axis)


def _gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``x`` along ``axis`` concatenated on ``dim``, on
    ``x``'s device.  Over gloo a CUDA tensor is gathered as the all-reduce
    of a zero-filled whole (gloo gathers no CUDA tensor); over NCCL by
    ``all_gather_into_tensor``; otherwise by ``all_gather``."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    group = mesh.get_group(axis)
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        shape = list(x.shape)
        k, shape[dim] = shape[dim], shape[dim] * n
        whole = torch.zeros(shape, dtype=x.dtype, device=x.device)
        whole.narrow(dim, i * k, k).copy_(x)
        return all_reduce(whole, mesh, axis)
    t0 = time.perf_counter()
    if _nccl(group):
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, src, group=group)
        _count(t0, out.numel() * out.element_size(), "all-gather",
               src.numel() * src.element_size(), n)
        return out.movedim(0, dim)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    _count(t0, x.numel() * x.element_size() * n, "all-gather",
           x.numel() * x.element_size(), n)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(g: torch.Tensor, mesh, axis: str, dim: int):
    """The sum over ``axis`` of each rank's whole ``g``, this rank's block
    of ``dim``: ``reduce_scatter_tensor`` over NCCL, an all-reduce and a
    narrow otherwise (gloo has no reduce-scatter)."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    group = mesh.get_group(axis)
    k = g.shape[dim] // n
    if _nccl(group):
        t0 = time.perf_counter()
        src = g.movedim(dim, 0).contiguous()
        out = torch.empty((k, *src.shape[1:]), dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        nbytes = src.numel() * src.element_size()
        _count(t0, nbytes, "reduce-scatter", nbytes, n)
        return out.movedim(0, dim)
    whole = all_reduce(g.clone(memory_format=torch.contiguous_format), mesh,
                       axis)
    return whole.narrow(dim, i * k, k)


def counted_as(prefix: str, fn):
    """``fn()``, its collectives counted in the ``prefix`` keys of STATS
    too (``"fsdp_"``, ``"merge_"``, ``"heads_"``)."""
    before = {k: STATS[k] for k in ("calls", "seconds", "bytes")}
    out = fn()
    for k, v in before.items():
        STATS[prefix + k] += STATS[k] - v
    return out


class _FsdpGather(torch.autograd.Function):
    """Gather forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return counted_as("fsdp_", lambda: _gather(x, mesh, axis, dim))

    @staticmethod
    def backward(ctx, g):
        return counted_as("fsdp_", lambda: _reduce_scatter(
            g, ctx.mesh, ctx.axis, ctx.dim)), None, None, None


def fsdp_gather(x: torch.Tensor, mesh, axis: str = "data",
                dim: int = 0) -> torch.Tensor:
    """ZeRO-3's gather of a leaf that FSDP splits over ``axis``: the
    ranks' blocks of ``x`` concatenated on ``dim``, on ``x``'s device.
    Each rank uses the whole on its own rows, so each block's gradient is
    the sum over the axis of the ranks' gradients of the whole, of which
    the rank keeps its block (a reduce-scatter; ``gather``'s backward only
    narrows).  Counted in STATS's ``fsdp_`` keys."""
    return _FsdpGather.apply(x, mesh, axis, dim % x.dim())


class _Gather(torch.autograd.Function):
    """Gather forward, the rank's block of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.block = (dim, axis_index(mesh, axis) * x.shape[dim], x.shape[dim])
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(*ctx.block), None, None, None


def gather(x: torch.Tensor, mesh, axis: str, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``axis`` concatenated on ``dim``
    (in the axis's order), on ``x``'s device.  The gradient of each block
    is its block of the whole's gradient: right where every rank uses the
    whole alike (the logits of a replicated loss); where the ranks use it
    differently, sum first (``copy_to`` of the gathered whole)."""
    return _Gather.apply(x, mesh, axis, dim % x.dim())


@dataclasses.dataclass(frozen=True)
class Group:
    """One mesh axis as this rank sees it (or a tuple of axes, ``group``):
    its ``size``, the rank's index along it and the collectives over it.
    The default is the group of one (``SOLO``), whose collectives return
    their input and whose ``block`` is the whole."""
    mesh: Any = None
    axis: Any = "model"
    size: int = 1
    index: int = 0

    def block(self, n: int) -> slice:
        if n % self.size:
            raise ValueError(f"{n} does not split over {self.size} ranks "
                             f"of {self.axis!r}")
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else copy_to(x, self.mesh, self.axis)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else reduce_from(x, self.mesh, self.axis)

    def reduce_both(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else reduce_both(x, self.mesh, self.axis)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return x if self.size == 1 else gather(x, self.mesh, self.axis, dim)

    def fsdp_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x if self.size == 1 else fsdp_gather(x, self.mesh, self.axis,
                                                    dim)

    def part(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank's block of dimension ``dim`` of the replicated ``w``,
        through ``copy_to``: the ranks' gradients of their parts are
        summed, so each holds ``w``'s whole gradient."""
        if self.size == 1:
            return w
        sl = self.block(w.shape[dim])
        return self.copy_to(w).narrow(dim, sl.start, sl.stop - sl.start)


#: the group of one: no mesh, or an axis of size 1
SOLO = Group()


def group(mesh, axis="model") -> Group:
    """``axis`` of ``mesh`` as this rank sees it; ``SOLO`` without a mesh,
    without that axis, or where it has one rank.  A tuple of axes is one
    group of their product, the first major (``("pod", "data")``, as
    ``axis_index`` orders it); its collectives are ``all_reduce``'s, over
    one axis after another."""
    shape = {} if mesh is None else mesh_shape(mesh)
    if any(a not in shape for a in _names(axis)) or \
            axis_size(shape, axis) == 1:
        return SOLO
    return Group(mesh, axis, axis_size(mesh, axis), axis_index(mesh, axis))


def mean_value(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of the scalar ``x`` over the ranks of ``axes``, whose
    gradient reaches this rank's ``x`` whole: a rank's loss holds its own
    term, and the data-parallel mean of the gradients makes it the mean's
    (the reference's ``pmean`` under a data-parallel loss)."""
    n = axis_size(mesh, tuple(a for a in _names(axes)
                              if a in mesh_shape(mesh)))
    if n == 1:
        return x
    m = all_reduce(x.detach().clone(), mesh, axes) / n
    return m + (x - x.detach())
