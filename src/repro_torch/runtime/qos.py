"""QoS request surface for the multi-tenant serving tier (DESIGN.md §13).

The paper's host-side bottleneck argument (and its follow-up
arXiv:2110.01709) is that PIM throughput is won or lost in how the host
orders and batches requests.  A serving tier therefore needs requests that
carry more than a bare priority int: **who** is asking (tenant), how urgent
it is (priority + deadline), and how much of the machine the tenant is
entitled to (weight).  :class:`RequestOptions` is that contract — one
frozen value object accepted by ``session.run()/submit()/map()`` and
consumed by the scheduler's weighted-fair / earliest-deadline-first
dispatch (``runtime/scheduler.py``).

The legacy ``priority=`` int keeps working everywhere via
:func:`resolve_options`, which wraps it in a :class:`RequestOptions` behind
a :class:`DeprecationWarning` — callers migrate at their own pace, the
scheduler only ever sees options.

:class:`TenantState` is the scheduler-internal per-tenant bookkeeping:
the request heap, the start-time-fair-queuing virtual time, and the
outcome counters (`submitted`/`shed`/`expired`) that back the per-tenant
``session.stats()`` rows.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Mapping

#: the tenant requests land on when none is named — single-tenant sessions
#: never need to know tenants exist
DEFAULT_TENANT = "default"


class QueueFull(RuntimeError):
    """Backpressure shed: the request was refused (``shed="reject"``) or
    evicted (``shed="drop"``) because the session's ``max_queue_depth`` was
    reached.  Carries the tenant and the depth at shed time."""

    def __init__(self, tenant: str, depth: int, max_depth: int):
        super().__init__(
            f"queue full: depth {depth} >= max_queue_depth {max_depth} "
            f"(tenant {tenant!r}) — request shed")
        self.tenant = tenant
        self.depth = depth
        self.max_depth = max_depth


class DeadlineExpired(RuntimeError):
    """The request's ``deadline_s`` passed before dispatch: it was dropped
    at pop time with a counted ``expired`` outcome instead of burning bank
    time on an answer nobody is waiting for."""

    def __init__(self, tenant: str, workload: str, late_s: float):
        super().__init__(
            f"deadline expired {late_s * 1e3:.1f} ms before dispatch "
            f"({workload}, tenant {tenant!r}) — request dropped")
        self.tenant = tenant
        self.workload = workload
        self.late_s = late_s


@dataclasses.dataclass(frozen=True)
class RequestOptions:
    """Per-request QoS contract (DESIGN.md §13 maps each field to its
    scheduler mechanism).

    * ``tenant`` — the queue the request joins; tenants share the banks
      under weighted-fair dispatch.
    * ``priority`` — higher runs first *within* the tenant (ties FIFO),
      exactly the old scheduler int.
    * ``deadline_s`` — seconds from submit after which the result is
      worthless; EDF orders equal-priority requests by deadline and the
      scheduler drops expired ones at dispatch (``DeadlineExpired``).
    * ``weight`` — overrides/creates the tenant's fair-share weight at
      submit (None keeps the session's configured weight).
    * ``tags`` — free-form key→value labels copied onto the request's
      telemetry record and its trace spans (no scheduler mechanism).  The
      decode engine tags every projection matvec ``layer=i, proj=q|k|v|o|
      up|down`` so phase accounting can be grouped per layer (DESIGN.md
      §14).
    """

    tenant: str = DEFAULT_TENANT
    priority: int = 0
    deadline_s: float | None = None
    weight: float | None = None
    tags: Mapping | None = None

    def __post_init__(self):
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        if self.weight is not None and self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")


def resolve_options(options: RequestOptions | None = None,
                    priority: int | None = None) -> RequestOptions:
    """Normalize the two request surfaces into one :class:`RequestOptions`.

    ``priority=`` is the pre-serving-tier scheduler int; passing it still
    works but warns — it is sugar for ``RequestOptions(priority=...)`` on
    the default tenant.  Passing both is ambiguous and rejected."""
    if priority is not None:
        if options is not None:
            raise ValueError("pass options= or the legacy priority= int, "
                             "not both")
        warnings.warn(
            "priority= is deprecated; pass "
            f"options=RequestOptions(priority={priority}) instead",
            DeprecationWarning, stacklevel=3)
        return RequestOptions(priority=int(priority))
    return options if options is not None else RequestOptions()


class TenantState:
    """Scheduler-internal per-tenant queue + fair-share accounting.

    ``vtime`` is start-time fair queuing's virtual time: every dispatched
    batch charges ``service_s / weight``, and the scheduler serves the
    backlogged tenant with the smallest ``vtime`` — so a weight-2 tenant
    accrues virtual time half as fast and gets twice the service share.
    On enqueue-to-empty the tenant catches up to the global virtual clock
    (``max(vtime, vclock)``) so an idle tenant cannot bank credit and
    starve the others when it returns."""

    __slots__ = ("name", "weight", "queue", "vtime",
                 "submitted", "shed", "expired")

    def __init__(self, name: str, weight: float = 1.0):
        self.name = name
        self.weight = float(weight)
        self.queue: list = []        # heap of (key, PimRequest)
        self.vtime = 0.0
        self.submitted = 0
        self.shed = 0
        self.expired = 0

    def charge(self, service_s: float) -> float:
        """Fold one dispatched batch's measured service into the virtual
        time; returns the new vtime (the scheduler's vclock candidate)."""
        self.vtime += service_s / self.weight
        return self.vtime

    def activate(self, vclock: float) -> None:
        """Enqueue-to-empty catch-up: no credit for having been idle."""
        if not self.queue:
            self.vtime = max(self.vtime, vclock)

    def snapshot(self) -> dict:
        """Live queue-side view merged into ``session.stats()`` tenants
        rows (completion-side counts come from telemetry, under its lock)."""
        return {"weight": self.weight, "queued": len(self.queue),
                "vtime": self.vtime, "submitted": self.submitted}


#: EDF sort key position for "no deadline": sorts after every real deadline
NO_DEADLINE = math.inf
