"""Elastic rank reallocation for the serving tier (DESIGN.md §13) — the
ported part of ``repro.runtime.elastic``.

:class:`RankAllocator` sizes the rank slice each tenant's next batch runs
on, from EWMA-smoothed per-tenant backlog demand weighted by fair-share
weights; a straggler signal (``runtime/straggler.py``) caps the
allocation and healthy batches relax the cap back.  Pure Python, copied
from the reference.  The train-side mesh helpers (``carve_mesh``,
``reshard``, ``shardings_for``, ``simulate_failure``) build JAX meshes,
which one GPU does not have; they wait for the multi-GPU work (ROADMAP
queue 1, item 9.6).
"""
from __future__ import annotations

from typing import Mapping


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
