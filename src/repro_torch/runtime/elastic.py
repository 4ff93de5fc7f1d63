"""Elastic resource management — the counterpart of
``repro.runtime.elastic``: serving-side rank reallocation plus the
train-side mesh re-carve / reshard utilities.

**Serving side (DESIGN.md §13):** :class:`RankAllocator` sizes the rank
slice each tenant's next batch runs on, from EWMA-smoothed per-tenant
backlog demand weighted by fair-share weights; a straggler signal
(``runtime/straggler.py``) caps the allocation and healthy batches relax
the cap back.  Pure Python, copied from the reference.

**Train side**, over ``torch.distributed`` (a rank is a process, a mesh a
``DeviceMesh``; ``core.sharding``):
  1. ``carve_mesh(ranks, model_parallel)`` builds the largest (data,
     model) mesh from the surviving ranks (dropping at most
     model_parallel-1 of them).  Every rank of the world calls it (a mesh
     over a subset creates its groups on every rank); a rank left out
     gets a mesh it is not in (``core.sharding.member``) and leaves.
  2. ``shardings_for(mesh, specs)`` turns a tree of ``P`` into a tree of
     DTensor placements, one per mesh dimension, dropping the spec axes
     the mesh lacks (the "pod" axis folds into "data" on re-carve);
     ``reshard(tree, mesh, specs)`` places each leaf with
     ``distribute_tensor``.  Every rank holds the whole leaf (seeded, or
     restored from a checkpoint), so a ``Shard`` is sliced locally and
     nothing is scattered (gloo scatters no CUDA tensor).  These are the
     reference's contiguous blocks, for any tree of leaves; a model's
     parameters are not placed here.  Only ``models.layers.layout`` places
     them (``transformer.init(mesh=)`` when it draws them,
     ``models.convert.params_from_reference(mesh=)`` when it loads whole
     leaves, restores included): a fused leaf's rank holds its block of
     each half, which no contiguous ``Shard`` gives (an FSDP leaf also
     its block over "data").  A restore onto a mesh of another shape goes
     through the whole leaves of the checkpoint.
  3. The data pipeline is stateless-seekable and the optimizer state lives
     in the checkpoint, so resume = carve + restore + continue at step k
     (``launch.train.fit``).
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.core.sharding import P, mesh_device_type, mesh_shape


class RankAllocator:
    """Elastic rank shares for the multi-tenant scheduler (DESIGN.md §13).

    The scheduler feeds :meth:`update` the current per-tenant backlog
    bytes at every dispatch; the allocator keeps an EWMA per tenant so a
    single bursty batch does not thrash the allocation.  :meth:`ranks_for`
    turns the smoothed, weight-scaled demand share into a rank count for
    the batch about to run — ``None`` means "no elastic opinion" (single
    effective tenant: the tuned plan / full grid keeps deciding, so
    single-tenant sessions behave exactly as before).

    Straggler coupling: :meth:`on_straggle` (wired as a
    :class:`~repro.runtime.straggler.StepMonitor` callback) halves the rank
    cap — a straggling host serves fewer parallel pipelines until
    :meth:`relax` (called per healthy batch) grows it back.

    Resident workloads are *not* routed through the allocator: the operand
    cache's fingerprint bakes in the placement ``(n_banks, n_ranks,
    total_chunks)`` (DESIGN.md §12), so varying the rank count per batch
    would miss the cache every time.  The scheduler enforces that gate.
    """

    def __init__(self, n_ranks: int, alpha: float = 0.5,
                 solo_share: float = 0.95):
        if n_ranks < 1:
            raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
        self.n_ranks = n_ranks
        self.alpha = alpha            # EWMA smoothing for backlog demand
        self.solo_share = solo_share  # above this share: not multi-tenant
        self.cap = n_ranks            # straggler-halved, relax()-restored
        self.demand: dict[str, float] = {}

    def update(self, backlog_bytes: Mapping[str, float]) -> None:
        """Fold the current per-tenant backlog (bytes queued + in the batch
        being dispatched) into the EWMAs; absent tenants decay toward 0."""
        for name in set(self.demand) | set(backlog_bytes):
            cur = float(backlog_bytes.get(name, 0.0))
            prev = self.demand.get(name, cur)
            self.demand[name] = (1 - self.alpha) * prev + self.alpha * cur

    def share(self, tenant: str, weights: Mapping[str, float]) -> float:
        """Weighted demand fraction for ``tenant`` (0 when idle)."""
        total = sum(weights.get(n, 1.0) * d
                    for n, d in self.demand.items() if d > 0)
        mine = weights.get(tenant, 1.0) * self.demand.get(tenant, 0.0)
        return mine / total if total > 0 else 0.0

    def ranks_for(self, tenant: str,
                  weights: Mapping[str, float]) -> int | None:
        """Rank count for ``tenant``'s next batch, or None for "no elastic
        opinion" (idle or effectively sole tenant, modulo a straggler cap
        that still must bind)."""
        share = self.share(tenant, weights)
        if share <= 0.0 or share >= self.solo_share:
            # sole tenant: the plan/grid default already uses everything —
            # only a straggler cap below the full grid needs enforcing
            return self.cap if self.cap < self.n_ranks else None
        return max(1, min(round(share * self.n_ranks), self.cap))

    def on_straggle(self, *_args) -> None:
        """StepMonitor callback: halve the cap (min 1)."""
        self.cap = max(1, self.cap // 2)

    def relax(self) -> None:
        """One healthy batch: grow the cap back toward the full grid."""
        self.cap = min(self.n_ranks, self.cap + 1)


def carve_mesh(ranks=None, model_parallel: int = 1,
               axis_names=("data", "model"),
               device_type: str | None = None) -> DeviceMesh:
    """Largest usable (data, model) mesh from the surviving ranks (default:
    the world), on ``device_type`` ranks (default ``"cuda"``)."""
    ranks = sorted(ranks if ranks is not None
                   else range(torch.distributed.get_world_size()))
    usable = (len(ranks) // model_parallel) * model_parallel
    if usable == 0:
        raise RuntimeError(f"{len(ranks)} ranks cannot host model_parallel="
                           f"{model_parallel}")
    grid = torch.tensor(ranks[:usable]).reshape(-1, model_parallel)
    return DeviceMesh(mesh_device_type(device_type), grid,
                      mesh_dim_names=tuple(axis_names))


def fold_spec(spec, names) -> P:
    """``spec`` without the axes not in ``names`` (the reference's
    ``shardings_for`` per leaf; a tuple left with one axis is that axis,
    as ``PartitionSpec`` writes it)."""
    parts = []
    for p in tuple(spec):
        if p is None:
            parts.append(None)
        elif isinstance(p, (tuple, list)):
            kept = tuple(a for a in p if a in names)
            parts.append(kept if len(kept) > 1 else
                         kept[0] if kept else None)
        else:
            parts.append(p if p in names else None)
    return P(*parts)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(dim)`` for the tensor dimension whose entry names it, else
    ``Replicate()``.  A tuple entry shards over its axes with the first
    major, as the mesh's order does; another order raises.  These are the
    reference's contiguous blocks, not a model's parameters' (module
    docstring, item 2)."""
    names = list(mesh_shape(mesh))
    spec = fold_spec(spec, set(names))
    out = []
    for a in names:
        dims = [i for i, p in enumerate(spec)
                if p == a or (isinstance(p, tuple) and a in p)]
        out.append(Shard(dims[0]) if dims else Replicate())
    for p in spec:
        if isinstance(p, tuple) and \
                list(p) != sorted(p, key=names.index):
            raise ValueError(f"{spec}: {p} is not in the mesh's order "
                             f"{tuple(names)}")
    return tuple(out)


def _map_specs(fn, specs):
    if isinstance(specs, P):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    raise TypeError(f"not a spec tree: {specs!r}")


def shardings_for(mesh, specs):
    """Congruent tree of placements from a tree of ``P`` (dicts and lists),
    dropping spec axes the mesh doesn't have (pod-axis fold-down)."""
    return _map_specs(lambda s: placements(mesh, s), specs)


def reshard(tree, mesh: DeviceMesh, specs):
    """Place every leaf (a tensor or an array, whole on every rank) with
    its spec on the (new) mesh -> a tree of DTensors, in the reference's
    contiguous blocks (not a model's parameters: module docstring,
    item 2)."""
    def place(a, spec):
        t = torch.as_tensor(a).to(mesh.device_type)
        return distribute_tensor(t, mesh, placements(mesh, spec),
                                 src_data_rank=None)

    def walk(t, s):
        if isinstance(s, P):
            return place(t, s)
        if isinstance(s, dict):
            return {k: walk(t[k], v) for k, v in s.items()}
        return [walk(a, v) for a, v in zip(t, s)]

    return walk(tree, specs)


def simulate_failure(mesh: DeviceMesh, n_lost: int,
                     model_parallel: int) -> DeviceMesh:
    """Test hook: drop the last n_lost ranks and re-carve (every rank of
    the world calls it; the lost ones get a mesh they are not in)."""
    ranks = mesh.mesh.flatten().tolist()
    ranks = ranks[:-n_lost] if n_lost else ranks
    return carve_mesh(ranks, model_parallel, mesh.mesh_dim_names[-2:],
                      device_type=mesh.device_type)
