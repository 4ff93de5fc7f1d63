"""Multi-tenant request scheduler: multiplex concurrent PrIM workloads —
and concurrent *tenants* — onto one BankGrid (DESIGN.md §13).  The PyTorch
counterpart of ``repro.runtime.scheduler``: the same policy code, over the
port's registry and pipeline.

Callers ``submit()`` workload invocations as *requests* carrying a
:class:`~repro_torch.runtime.qos.RequestOptions` (tenant / priority / deadline /
weight); the scheduler owns the grid and decides execution order:

* **weighted-fair dispatch** — each tenant has its own queue and a
  start-time-fair-queuing virtual time; every dispatched batch charges
  ``service_s / weight`` and the backlogged tenant with the smallest
  virtual time serves next, so service share converges to the weight
  ratio under saturation (``policy="qos"``; ``policy="fifo"`` ignores
  tenants/priorities/deadlines and serves global submission order — the
  baseline the deadline-miss comparison in ``tests/test_serving.py`` and
  ``benchmarks/loadgen.py`` measures against);
* **priority + EDF within a tenant** — higher priority first, ties by
  earliest deadline, then FIFO; requests whose deadline passed before
  dispatch are dropped at pop time with a counted ``expired`` outcome
  (their futures raise :class:`~repro_torch.runtime.qos.DeadlineExpired`);
* **backpressure + load shedding** — beyond ``max_queue_depth`` a submit
  is rejected (``shed="reject"``, raises
  :class:`~repro_torch.runtime.qos.QueueFull`), displaces the least-urgent
  queued request (``shed="drop"``), or blocks until the queue drains
  (``shed=False``);
* **size-aware batching** — consecutive same-workload requests *of the
  chosen tenant* are coalesced (up to ``max_batch_requests`` /
  ``max_batch_bytes``) and streamed through a single chunk pipeline, so
  the banks never drain between them (``pipeline.run_pipelined_many``);
  coalescing never crosses tenants or jumps a higher-ranked request;
* **tuned plans** — per-workload chunk counts and batch sizes may come from
  the characterization-driven autotuner (``runtime.autotune``, DESIGN.md §8)
  via ``plans=`` or :meth:`PimScheduler.autotuned`;
* **elastic rank placement** — on a
  :class:`~repro_torch.core.banked.RankGrid`
  (DESIGN.md §10) every pipelineable batch is sharded across ranks
  (``pipeline.run_pipelined_ranked``).  Under multi-tenant load a
  :class:`~repro_torch.runtime.elastic.RankAllocator` sizes each batch's rank
  slice from EWMA backlog demand × weight, and a per-workload
  :class:`~repro_torch.runtime.straggler.StepMonitor` caps the slice when batch
  service straggles (halve on flag, relax per healthy batch).  Resident
  workloads bypass the allocator — their cache fingerprints bake in the
  placement (DESIGN.md §12).  With a single effective tenant the plan /
  grid default decides, exactly the pre-serving-tier behavior.

The workload set comes from :mod:`repro_torch.prim.registry`: every
registry entry is servable.  Pipelineable entries run through the chunk pipeline;
serialized-only entries (NW, BFS — their inter-DPU dependency structure
forbids independent chunks, see the registry reasons) fall back to the
faithful serialized ``pim()``, still queued/prioritized/recorded like any
other request.

Two execution modes:

* ``drain()`` — process the queue in the calling thread (deterministic;
  what the tests and benchmarks use);
* ``start()`` / ``stop()`` or ``with scheduler:`` — a worker thread serves
  requests as they arrive.  All device work stays on the single worker
  thread (and the rank threads it starts).

Every request carries a :class:`~repro_torch.runtime.telemetry.RequestRecord`;
completed records land in the scheduler's :class:`Telemetry` sink, and a
``serve`` span per completion lands on the request's ``tenant-<name>``
trace track, so Perfetto shows one lane per tenant (DESIGN.md §11).
"""
from __future__ import annotations

import heapq
import itertools
import threading
from typing import TYPE_CHECKING, Any, Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.banked import BankGrid
from repro_torch.core.transfer import tree_leaves, tree_nbytes as _nbytes

from .elastic import RankAllocator
from .pipeline import run_pipelined_ranked
from .qos import (DEFAULT_TENANT, NO_DEADLINE, DeadlineExpired, QueueFull,
                  RequestOptions, TenantState, resolve_options)
from .resident import unwrap_handles
from .straggler import StepMonitor, StragglerConfig
from .telemetry import RequestRecord, Telemetry, now
from .trace import get_tracer

if TYPE_CHECKING:  # annotation-only: importing repro_torch.prim pulls the suite
    from repro_torch.prim import common

    from .autotune import TunedPlan


def _span_tags(rec: RequestRecord) -> dict:
    """Caller tags (RequestOptions.tags) to fold into a request's ``serve``
    span — reserved span-arg names are dropped rather than collide."""
    reserved = ("name", "cat", "track", "workload", "req", "tenant")
    return {k: v for k, v in rec.tags.items() if k not in reserved}


def _nitems(args) -> int:
    """Leading dim of the first array leaf — the ``n_items`` a request's
    telemetry record reports (batching itself is byte-capped via
    ``tree_nbytes``).  Pytree-aware, mirroring ``tree_nbytes``: MLP passes
    a *list* of layer matrices first, so a flat top-level scan would skip
    it and report the bias vector's length instead."""
    for leaf in tree_leaves(args):
        if hasattr(leaf, "shape") and getattr(leaf, "ndim", 0) >= 1:
            return leaf.shape[0]
    return 0


class PimRequest:
    """Handle returned by ``submit()``; ``result()`` blocks for completion.
    A shed or expired request's ``result()`` raises the counted outcome
    (:class:`QueueFull` / :class:`DeadlineExpired`)."""

    def __init__(self, workload: str, args: tuple, options: RequestOptions,
                 record: RequestRecord):
        self.workload = workload
        self.args = args
        self.options = options
        self.record = record
        #: absolute perf_counter() deadline (None = no deadline)
        self.deadline_abs = (record.t_submit + options.deadline_s
                             if options.deadline_s else None)
        self._event = threading.Event()
        self._result: Any = None
        self._error: BaseException | None = None

    @property
    def priority(self) -> int:
        return self.options.priority

    def _fulfill(self, result=None, error=None) -> None:
        self._result, self._error = result, error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.record.request_id} "
                               f"({self.workload}) still queued")
        if self._error is not None:
            raise self._error
        return self._result


class PimScheduler:
    """Owns a BankGrid; queues, batches, and pipelines PrIM requests for
    any number of tenants."""

    def __init__(self, grid: BankGrid, *, n_chunks: int = 4,
                 max_batch_requests: int = 8,
                 max_batch_bytes: int = 256 << 20,
                 workloads: dict[str, common.ChunkedWorkload] | None = None,
                 plans: Mapping[str, TunedPlan] | None = None,
                 telemetry: Telemetry | None = None,
                 cache=None,
                 tenants: Mapping[str, float] | Iterable[str] | None = None,
                 max_queue_depth: int | None = None,
                 shed: str | bool = "reject",
                 policy: str = "qos"):
        if policy not in ("qos", "fifo"):
            raise ValueError(f"policy must be 'qos' or 'fifo', got "
                             f"{policy!r}")
        if shed not in ("reject", "drop") and shed:
            raise ValueError("shed must be 'reject', 'drop', or falsy "
                             f"(block), got {shed!r}")
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got "
                             f"{max_queue_depth}")
        self.grid = grid
        self.n_chunks = n_chunks
        self.max_batch_requests = max_batch_requests
        self.max_batch_bytes = max_batch_bytes
        #: resident-operand cache (runtime.resident, DESIGN.md §12); None
        #: keeps the pre-residency scatter-every-request behavior
        self.cache = cache
        #: per-workload TunedPlan overrides (chunk count + batch size) from
        #: runtime.autotune; workloads without a plan keep the constants
        #: above as the untuned fallback
        self.plans: dict[str, TunedPlan] = dict(plans or {})
        self.serialized: dict[str, Any] = {}
        if workloads is None:
            from repro_torch.prim import registry  # lazy: pulls the suite
            workloads = {name: e.chunked
                         for name, e in registry.REGISTRY.items()
                         if e.pipelineable}
            self.serialized = {name: e.pim
                               for name, e in registry.REGISTRY.items()
                               if not e.pipelineable}
        self.workloads = dict(workloads)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        # -- serving-tier policy state (DESIGN.md §13) ------------------------
        self.policy = policy
        self.max_queue_depth = max_queue_depth
        self.shed = shed
        self._tenants: dict[str, TenantState] = {
            DEFAULT_TENANT: TenantState(DEFAULT_TENANT)}
        if tenants is not None:
            weights = (dict(tenants) if isinstance(tenants, Mapping)
                       else {name: 1.0 for name in tenants})
            for name, w in weights.items():
                self._tenants[name] = TenantState(name, w)
        self._depth = 0                         # total queued, all tenants
        self._vclock = 0.0                      # last dispatched vtime
        # elastic rank allocation + straggler-aware capping: only live on a
        # rank hierarchy (a flat grid has nothing to reallocate)
        n_ranks = getattr(grid, "n_ranks", 1)
        self.allocator = RankAllocator(n_ranks) if n_ranks > 1 else None
        self._monitors: dict[str, StepMonitor] = {}
        self._step = itertools.count()
        self._seq = itertools.count()
        self._batch_seq = itertools.count()
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._stopping = False

    @classmethod
    def autotuned(cls, grid: BankGrid, *, scale: int = 1, probe: bool = True,
                  **kwargs) -> "PimScheduler":
        """Calibrate the grid's device and construct a scheduler whose
        per-workload chunk counts and batch sizes come from the fitted model
        (runtime.autotune, DESIGN.md §8) instead of the constants above."""
        from .autotune import autotune
        result = autotune(grid, scale=scale, probe=probe)
        return cls(grid, plans=result.plans, **kwargs)

    # -- submission -----------------------------------------------------------

    def make_record(self, workload: str, args: tuple,
                    options: RequestOptions | None = None) -> RequestRecord:
        """Stamp a new request's lifecycle record (id, sizing, QoS fields,
        submit time).  The single construction site for every path that
        feeds telemetry — ``submit()`` here and the session façade's
        streamed ``map()``."""
        opts = options if options is not None else RequestOptions()
        sized = unwrap_handles(args)      # size the arrays, not the tokens
        return RequestRecord(request_id=next(self._seq), workload=workload,
                             n_items=_nitems(sized), bytes_in=_nbytes(sized),
                             priority=opts.priority, tenant=opts.tenant,
                             deadline_s=opts.deadline_s or 0.0,
                             t_submit=now(), n_banks=self.grid.n_banks,
                             tags=dict(opts.tags or {}))

    def _key(self, req: PimRequest) -> tuple:
        """Heap order within a tenant: priority desc, earliest deadline,
        then FIFO — with no deadlines this is exactly the original
        priority+FIFO discipline.  ``policy="fifo"`` ranks by submission
        id alone (global order: tenant selection also picks the smallest
        head, see :meth:`_select_tenant`)."""
        if self.policy == "fifo":
            return (req.record.request_id,)
        deadline = (req.deadline_abs if req.deadline_abs is not None
                    else NO_DEADLINE)
        return (-req.options.priority, deadline, req.record.request_id)

    def _tenant(self, opts: RequestOptions) -> TenantState:
        """Get-or-create the tenant (caller holds ``_cv``); an explicit
        per-request ``weight`` updates the tenant's share."""
        t = self._tenants.get(opts.tenant)
        if t is None:
            t = self._tenants[opts.tenant] = TenantState(
                opts.tenant, opts.weight if opts.weight else 1.0)
        elif opts.weight:
            t.weight = float(opts.weight)
        return t

    def _shed_one(self, t: TenantState, req: PimRequest) -> None:
        """Count and refuse ``req`` (caller holds ``_cv``)."""
        t.shed += 1
        self.telemetry.count_outcome(t.name, "shed")
        err = QueueFull(t.name, self._depth, self.max_queue_depth)
        req._fulfill(error=err)
        raise err

    def _worst_queued(self) -> tuple[TenantState, int] | None:
        """The least-urgent queued entry across all tenants (largest sort
        key; a heap only orders its head, so this is a linear scan over the
        bounded queue).  Caller holds ``_cv``."""
        worst, where = None, None
        for t in self._tenants.values():
            for idx, (key, _req) in enumerate(t.queue):
                if worst is None or key > worst:
                    worst, where = key, (t, idx)
        return where

    def _admit(self, req: PimRequest) -> None:
        """Backpressure + enqueue (caller holds ``_cv``): beyond
        ``max_queue_depth`` the configured shed policy applies — reject the
        newcomer, displace the least-urgent queued request, or block the
        submitter until the worker drains the queue below the bound."""
        t = self._tenant(req.options)
        while (self.max_queue_depth is not None
               and self._depth >= self.max_queue_depth):
            if self.shed == "reject":
                self._shed_one(t, req)          # raises QueueFull
            elif self.shed == "drop":
                where = self._worst_queued()
                if where is None or where[0].queue[where[1]][0] \
                        <= self._key(req):
                    # the newcomer is itself the least urgent: reject it
                    self._shed_one(t, req)      # raises QueueFull
                vt, idx = where
                _, victim = vt.queue.pop(idx)
                heapq.heapify(vt.queue)
                self._depth -= 1
                vt.shed += 1
                self.telemetry.count_outcome(vt.name, "shed")
                victim._fulfill(error=QueueFull(
                    vt.name, self._depth + 1, self.max_queue_depth))
            else:                               # shed falsy: block submitter
                self._cv.wait()
        t.activate(self._vclock)                # no credit for idle time
        t.submitted += 1
        heapq.heappush(t.queue, (self._key(req), req))
        self._depth += 1

    def submit(self, workload: str, *args,
               options: RequestOptions | None = None,
               priority: int | None = None) -> PimRequest:
        """Enqueue one workload invocation; returns a waitable handle.
        QoS comes in via ``options=``; the legacy ``priority=`` int still
        works behind a DeprecationWarning (see ``runtime/qos.py``)."""
        opts = resolve_options(options, priority)
        if workload not in self.workloads and workload not in self.serialized:
            raise KeyError(f"unknown workload {workload!r}; have "
                           f"{sorted(self.workloads) + sorted(self.serialized)}")
        rec = self.make_record(workload, args, opts)
        req = PimRequest(workload, args, opts, rec)
        with self._cv:
            self._admit(req)                    # may raise QueueFull / block
            depth = self._depth
            self._cv.notify()
        m = self.telemetry.metrics            # live counters (DESIGN.md §11)
        m.inc("submitted")
        m.observe("queue_depth", depth, bounds=range(1, 257))
        return req

    def pending(self) -> int:
        with self._cv:
            return self._depth

    def tenants(self) -> dict[str, dict]:
        """Live queue-side tenant snapshot (weight / queued / vtime /
        submitted); the session façade merges this with telemetry's
        completion-side rows into ``stats()["tenants"]``."""
        with self._cv:
            return {name: t.snapshot() for name, t in self._tenants.items()}

    # -- scheduling policy ----------------------------------------------------

    def _expire_head(self, t: TenantState, t_now: float) -> bool:
        """Drop the tenant's head request if its deadline already passed
        (dispatch-pop expiry, DESIGN.md §13).  Returns True if one was
        dropped.  Caller holds ``_cv``."""
        if not t.queue:
            return False
        _, req = t.queue[0]
        if req.deadline_abs is None or req.deadline_abs >= t_now:
            return False
        heapq.heappop(t.queue)
        self._depth -= 1
        t.expired += 1
        self.telemetry.count_outcome(t.name, "expired")
        req._fulfill(error=DeadlineExpired(
            t.name, req.workload, t_now - req.deadline_abs))
        tr = get_tracer()
        if tr.enabled:
            tr.emit("expired", "queue", req.record.t_submit, t_now,
                    track=f"tenant-{t.name}", workload=req.workload,
                    req=req.record.request_id, tenant=t.name)
        return True

    def _select_tenant(self) -> TenantState | None:
        """Pick the tenant to serve next (caller holds ``_cv``): smallest
        virtual time among backlogged tenants (weighted-fair), or smallest
        head submission id under ``policy="fifo"``.  Expired heads are
        dropped on the way — a tenant whose whole backlog expired is
        skipped entirely."""
        t_now = now()
        while True:
            backlogged = [t for t in self._tenants.values() if t.queue]
            if not backlogged:
                return None
            if self.policy == "fifo":
                t = min(backlogged, key=lambda t: t.queue[0][0])
            else:
                t = min(backlogged, key=lambda t: (t.vtime, t.name))
            while self._expire_head(t, t_now):
                pass
            if t.queue:
                return t

    def _pop_batch(self) -> list[PimRequest]:
        """Pop the selected tenant's head request plus *consecutive*
        same-workload requests of that tenant that fit the batch limits.
        Coalescing stops at the first entry that doesn't match or fit —
        skipping past it would execute a lower-ranked request ahead of it,
        violating the priority/EDF/FIFO guarantee — and never crosses
        tenants, so fair-share accounting stays per-batch-exact.  Returns
        ``[]`` only when nothing dispatchable is queued.  Caller holds
        ``_cv``."""
        tr = get_tracer()
        t0 = now() if tr.enabled else 0.0
        tenant = self._select_tenant()
        if tenant is None:
            return []
        _, head = heapq.heappop(tenant.queue)
        self._depth -= 1
        plan = self.plans.get(head.workload)
        max_requests = (plan.max_batch_requests if plan is not None
                        else self.max_batch_requests)
        batch, nbytes = [head], head.record.bytes_in
        t_now = now()
        while tenant.queue:
            if self._expire_head(tenant, t_now):
                continue                 # dropping never reorders survivors
            _, req = tenant.queue[0]
            if (req.workload != head.workload
                    or len(batch) >= max_requests
                    or nbytes + req.record.bytes_in > self.max_batch_bytes):
                break
            heapq.heappop(tenant.queue)
            self._depth -= 1
            batch.append(req)
            nbytes += req.record.bytes_in
        if self.max_queue_depth is not None:
            self._cv.notify_all()        # wake submitters blocked on depth
        if tr.enabled:
            tr.emit("batch_form", "sched", t0, now(), track="scheduler",
                    workload=head.workload, tenant=tenant.name,
                    requests=len(batch), bytes=nbytes, queued=self._depth)
        return batch

    # -- elastic rank placement (DESIGN.md §13) -------------------------------

    def _elastic_ranks(self, batch: Sequence[PimRequest]) -> int | None:
        """Rank count for this batch from the demand-driven allocator, or
        None to keep the plan/grid default.  Resident workloads always
        return None: the operand cache fingerprints the placement
        (DESIGN.md §12), so a varying rank count would miss on every
        request."""
        if self.allocator is None:
            return None
        wl = self.workloads.get(batch[0].workload)
        if wl is None or (self.cache is not None
                          and getattr(wl, "supports_residency", False)):
            return None
        name = batch[0].options.tenant
        with self._cv:
            demand = {t.name: float(sum(r.record.bytes_in
                                        for _, r in t.queue))
                      for t in self._tenants.values()}
            weights = {t.name: t.weight for t in self._tenants.values()}
        demand[name] = demand.get(name, 0.0) + sum(
            r.record.bytes_in for r in batch)
        self.allocator.update(demand)
        return self.allocator.ranks_for(name, weights)

    def _monitor(self, workload: str) -> StepMonitor | None:
        """Per-workload batch-service straggler monitor (only on a rank
        grid, where a flagged batch can actually shrink its rank slice)."""
        if self.allocator is None:
            return None
        mon = self._monitors.get(workload)
        if mon is None:
            mon = self._monitors[workload] = StepMonitor(
                StragglerConfig(window=32, threshold=2.0),
                on_straggle=self.allocator.on_straggle)
        return mon

    # -- execution ------------------------------------------------------------

    def _run_serialized(self, batch: Sequence[PimRequest], bid: int) -> None:
        """Serialized-only fallback (NW/BFS): run each request's faithful
        ``pim()`` back-to-back — no chunk overlap exists to exploit — but
        keep the full request lifecycle (QoS, telemetry, batching)."""
        fn = self.serialized[batch[0].workload]
        tr = get_tracer()
        for req in batch:
            rec = req.record
            rec.batch_id = bid
            rec.t_start = now()
            try:
                result, times = fn(self.grid, *req.args)
            except BaseException as e:            # noqa: BLE001 — forwarded
                req._fulfill(error=e)
                continue
            rec.t_finish = now()
            if tr.enabled:
                tr.emit("serialized", "dpu", rec.t_start, rec.t_finish,
                        track="host", workload=rec.workload,
                        req=rec.request_id)
            rec.phases = times
            rec.bytes_out = (result.nbytes
                             if isinstance(result, np.ndarray) else 0)
            self.telemetry.record(rec)
            req._fulfill(result=result)
            if tr.enabled:
                tr.emit("serve", "session", rec.t_submit, rec.t_finish,
                        track=f"tenant-{rec.tenant}", workload=rec.workload,
                        req=rec.request_id, tenant=rec.tenant,
                        **_span_tags(rec))

    def _run_batch(self, batch: Sequence[PimRequest]) -> None:
        bid = next(self._batch_seq)
        tr = get_tracer()
        if tr.enabled:
            # queue wait became service: emit the wait interval per request
            # on the scheduler track (submit -> now, i.e. batch start)
            t_now = now()
            for req in batch:
                tr.emit("queue_wait", "queue", req.record.t_submit, t_now,
                        track="scheduler", req=req.record.request_id,
                        workload=req.workload, batch=bid,
                        tenant=req.record.tenant)
        if batch[0].workload in self.serialized:
            self._run_serialized(batch, bid)
            return
        records = [r.record for r in batch]
        for rec in records:
            rec.batch_id = bid
        try:
            # rank-aware placement (DESIGN.md §10): on a RankGrid the batch
            # is sharded across ranks, one chunk pipeline per rank; on a
            # flat grid this is exactly run_pipelined_many.  The elastic
            # allocator's pick (explicit n_ranks) wins over the plan's.
            results = run_pipelined_ranked(
                self.grid, self.workloads[batch[0].workload],
                [r.args for r in batch], n_chunks=self.n_chunks,
                n_ranks=self._elastic_ranks(batch),
                plan=self.plans.get(batch[0].workload),
                records=records, cache=self.cache)
        except BaseException as e:                # noqa: BLE001 — forwarded
            if len(batch) == 1:
                batch[0]._fulfill(error=e)
            else:
                # isolate the failure: a malformed request must not poison
                # the healthy requests coalesced into its batch
                for r in batch:
                    self._run_batch([r])
            return
        for req, rec, res in zip(batch, records, results):
            rec.bytes_out = res.nbytes if isinstance(res, np.ndarray) else 0
            self.telemetry.record(rec)
            req._fulfill(result=res)
            if tr.enabled:
                tr.emit("serve", "session", rec.t_submit, rec.t_finish,
                        track=f"tenant-{rec.tenant}", workload=rec.workload,
                        req=rec.request_id, tenant=rec.tenant,
                        **_span_tags(rec))

    def _dispatch(self, batch: Sequence[PimRequest]) -> None:
        """Run one popped batch and settle the fair-share bill: the
        tenant's virtual time is charged the *measured* wall service over
        its weight, and the batch's service feeds the straggler monitor
        (a flagged batch halves the elastic rank cap, a healthy one
        relaxes it)."""
        mon = self._monitor(batch[0].workload)
        flagged_before = len(mon.flagged) if mon is not None else 0
        if mon is not None:
            mon.start_step()
        t0 = now()
        self._run_batch(batch)
        service = now() - t0
        if mon is not None:
            mon.end_step(next(self._step))
            if self.allocator is not None \
                    and len(mon.flagged) == flagged_before:
                self.allocator.relax()
        with self._cv:
            t = self._tenants.get(batch[0].options.tenant)
            if t is not None:
                self._vclock = max(self._vclock, t.charge(service))

    def drain(self) -> int:
        """Process queued requests in the calling thread until empty.
        Returns the number of requests completed (expired requests are
        dropped, not run, and do not count)."""
        tr = get_tracer()
        t0 = now() if tr.enabled else 0.0
        done = 0
        while True:
            with self._cv:
                batch = self._pop_batch()
                if not batch:
                    if tr.enabled and done:
                        tr.emit("drain", "sched", t0, now(),
                                track="scheduler", requests=done)
                    return done
            self._dispatch(batch)
            done += len(batch)

    # -- serving mode ---------------------------------------------------------

    def start(self) -> "PimScheduler":
        """Serve requests from a worker thread until ``stop()``."""
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._stopping = False

        def loop():
            while True:
                with self._cv:
                    while not self._depth and not self._stopping:
                        self._cv.wait()
                    batch = self._pop_batch()
                    if not batch:
                        if self._stopping:
                            return
                        continue         # whole backlog expired: re-wait
                self._dispatch(batch)

        self._thread = threading.Thread(target=loop, name="pim-scheduler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Finish everything queued, then stop the worker thread."""
        if self._thread is None:
            return
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "PimScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
