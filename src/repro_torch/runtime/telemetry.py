"""Per-request and aggregate telemetry for the pipelined PIM runtime.

Extends the paper's ``PhaseTimes`` stacked-bar accounting (CPU-DPU / DPU /
Inter-DPU / DPU-CPU) with what a *runtime* needs on top of a benchmark:
queue wait, per-request latency, overlap speedup against the serialized
baseline, and achieved CPU↔bank bandwidth.  Benchmarks render both views —
the paper's serialized bars and the pipelined bars — from the same records.

Phase accounting under overlap is host-observed: ``cpu_dpu`` is time spent
issuing scatters, ``dpu`` time spent dispatching/awaiting bank-local compute,
``dpu_cpu`` time blocked in retrieves, ``inter_dpu`` host-side merge time.
The buckets sum to roughly the makespan; hidden (overlapped) device time by
construction does not appear — that is the point.

Serving-hardened (DESIGN.md §11): completed records land in a **bounded
ring buffer** (``max_records``, default 64k) so a long-running ``submit()``
server cannot leak, while **running counters** keep every aggregate exact
over the full lifetime — ``aggregate()`` never iterates the (possibly
truncated) record window.  A lock guards the scheduler worker thread's
``record()`` against concurrent ``stats()`` / ``rows()`` readers, and every
record feeds the :class:`~repro_torch.runtime.metrics.Metrics` registry
(latency / queue-wait / service histograms, per-stage second counters) so
``session.stats()`` can report p50/p90/p99 alongside the means.

Consistency contract for concurrent submitters (DESIGN.md §13): the
metrics registry is fed *inside* the telemetry lock, and ``stats()`` /
``aggregate()`` take their counter snapshot and percentiles under that
same lock — so a ``stats()`` racing ``record()`` can never observe a
request counted in the totals but missing from the per-workload /
per-tenant breakdowns (or vice versa).  Lock order is always telemetry →
metrics; nothing acquires them the other way around.

Multi-tenant outcomes (DESIGN.md §13): every record carries its tenant,
``aggregate()`` reports a per-tenant breakdown, and the scheduler's
non-completion outcomes — requests **shed** by backpressure and requests
whose deadline **expired** before dispatch — are folded in via
:meth:`Telemetry.count_outcome` so goodput, shed rate, and miss counts
come from one consistent surface.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time

from .metrics import Metrics

#: default ring-buffer capacity for completed request records; aggregates
#: stay exact past the cap via the running counters
DEFAULT_MAX_RECORDS = 1 << 16

_STAGE_KEYS = ("cpu_dpu", "dpu", "inter_dpu", "dpu_cpu")


def now() -> float:
    return time.perf_counter()


def _phases():
    # lazy: PhaseTimes lives in repro_torch.prim, and importing that package
    # pulls the whole suite and its kernels — only pay for it when a
    # record is actually made, not when repro_torch.runtime is imported for its
    # elastic/straggler utilities
    from repro_torch.prim.common import PhaseTimes
    return PhaseTimes()


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle of one scheduled request."""

    request_id: int
    workload: str
    n_items: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    priority: int = 0
    tenant: str = "default"     # QoS queue the request ran under (§13)
    deadline_s: float = 0.0     # 0 = none; relative to t_submit
    n_chunks: int = 1
    n_ranks: int = 1            # ranks the chunks were sharded across
    n_banks: int = 0            # grid size at submit time (row() uses it)
    batch_id: int = -1
    t_submit: float = 0.0
    t_start: float = 0.0
    t_finish: float = 0.0
    phases: "PhaseTimes" = dataclasses.field(default_factory=_phases)
    serialized_s: float = 0.0   # optional: measured pim() baseline time
    predicted_overlap: float = 0.0   # autotune plan's promise (0 = untuned)
    #: cost-model per-stage seconds (cpu_dpu/dpu/dpu_cpu) stamped from the
    #: plan's ``predicted_stage_s`` (DESIGN.md §15) — compared against
    #: ``phases`` so every bench artifact doubles as a model validation
    #: set; {} when the plan carries no model predictions
    predicted_stage_s: dict = dataclasses.field(default_factory=dict)
    tuned: bool = False              # served under a TunedPlan?
    cache_hit: bool = False          # resident operand served warm? (§12)
    #: caller labels from RequestOptions.tags (e.g. the decode engine's
    #: layer=i, proj=q|k|v|o|up|down) — carried verbatim, no aggregation
    tags: dict = dataclasses.field(default_factory=dict)

    @property
    def queue_wait(self) -> float:
        return max(0.0, self.t_start - self.t_submit)

    @property
    def service_s(self) -> float:
        return max(0.0, self.t_finish - self.t_start)

    @property
    def latency_s(self) -> float:
        return max(0.0, self.t_finish - self.t_submit)

    @property
    def overlap_speedup(self) -> float:
        """Serialized-baseline time over pipelined service time (>1 ⇒ the
        overlap recovered transfer time the SDK would have serialized)."""
        if self.serialized_s and self.service_s:
            return self.serialized_s / self.service_s
        return 0.0

    @property
    def overlap_misprediction(self) -> float:
        """predicted/achieved − 1: positive ⇒ the autotune model
        over-promised, negative ⇒ it under-promised; 0.0 when either side is
        missing.  Surfaced per request so a drifting fit is visible in every
        bench artifact instead of silently mis-tuning (DESIGN.md §8)."""
        if self.predicted_overlap and self.overlap_speedup:
            return self.predicted_overlap / self.overlap_speedup - 1.0
        return 0.0

    @property
    def achieved_gbps(self) -> float:
        moved = self.bytes_in + self.bytes_out
        return moved / self.service_s / 1e9 if self.service_s else 0.0

    def row(self, n_banks: int | None = None) -> dict:
        """One flat table row; ``n_banks`` defaults to the value stored at
        record time (callers no longer need to thread the grid size)."""
        return {"request": self.request_id, "workload": self.workload,
                "banks": self.n_banks if n_banks is None else n_banks,
                "items": self.n_items, "tenant": self.tenant,
                "priority": self.priority, "chunks": self.n_chunks,
                "ranks": self.n_ranks, "batch": self.batch_id,
                "queue_wait_s": self.queue_wait,
                "service_s": self.service_s, "latency_s": self.latency_s,
                "cpu_dpu_s": self.phases.cpu_dpu, "dpu_s": self.phases.dpu,
                "inter_dpu_s": self.phases.inter_dpu,
                "dpu_cpu_s": self.phases.dpu_cpu,
                "overlap_speedup": self.overlap_speedup,
                "tuned": self.tuned, "cache_hit": self.cache_hit,
                "predicted_overlap": self.predicted_overlap,
                "overlap_misprediction": self.overlap_misprediction,
                "achieved_gbps": self.achieved_gbps,
                **{f"predicted_{k}_s": v
                   for k, v in self.predicted_stage_s.items()},
                **{f"tag_{k}": v for k, v in self.tags.items()}}


class _WorkloadStats:
    """Running per-workload aggregate (one breakdown row each)."""

    __slots__ = ("n", "sum_latency", "min_latency", "max_latency",
                 "sum_service", "bytes_moved")

    def __init__(self):
        self.n = 0
        self.sum_latency = 0.0
        self.min_latency = float("inf")
        self.max_latency = 0.0
        self.sum_service = 0.0
        self.bytes_moved = 0

    def add(self, rec: RequestRecord) -> None:
        lat = rec.latency_s
        self.n += 1
        self.sum_latency += lat
        self.min_latency = min(self.min_latency, lat)
        self.max_latency = max(self.max_latency, lat)
        self.sum_service += rec.service_s
        self.bytes_moved += rec.bytes_in + rec.bytes_out

    def row(self) -> dict:
        return {"requests": self.n,
                "mean_latency_s": self.sum_latency / self.n,
                "min_latency_s": self.min_latency,
                "max_latency_s": self.max_latency,
                "mean_service_s": self.sum_service / self.n,
                "bytes_moved": self.bytes_moved}


class _TenantStats:
    """Running per-tenant aggregate (DESIGN.md §13): completions plus the
    scheduler's counted non-completion outcomes (shed / expired)."""

    __slots__ = ("completed", "shed", "expired", "sum_latency",
                 "sum_service", "bytes_moved")

    def __init__(self):
        self.completed = 0
        self.shed = 0
        self.expired = 0
        self.sum_latency = 0.0
        self.sum_service = 0.0
        self.bytes_moved = 0

    def add(self, rec: RequestRecord) -> None:
        self.completed += 1
        self.sum_latency += rec.latency_s
        self.sum_service += rec.service_s
        self.bytes_moved += rec.bytes_in + rec.bytes_out

    def row(self) -> dict:
        n = max(1, self.completed)
        return {"completed": self.completed, "shed": self.shed,
                "expired": self.expired,
                "mean_latency_s": self.sum_latency / n,
                "service_s": self.sum_service,
                "bytes_moved": self.bytes_moved}


class Telemetry:
    """Aggregate sink the scheduler writes completed records into.

    ``records`` is the bounded recent window (ring buffer) for per-request
    inspection; every aggregate comes from running counters updated under
    the lock at ``record()`` time, so nothing drifts when old records are
    evicted.  ``metrics`` is the live counters/histograms surface
    (DESIGN.md §11)."""

    def __init__(self, max_records: int = DEFAULT_MAX_RECORDS,
                 metrics: Metrics | None = None):
        self.max_records = max_records
        self.records: collections.deque[RequestRecord] = collections.deque(
            maxlen=max_records)
        self.metrics = metrics if metrics is not None else Metrics()
        self._lock = threading.Lock()
        self._reset_running()

    def _reset_running(self) -> None:
        self._n = 0
        self._tuned = 0
        self._cache_hits = 0
        self._bytes_moved = 0
        self._sum_queue_wait = 0.0
        self._sum_latency = 0.0
        self._min_latency = float("inf")
        self._max_latency = 0.0
        self._t_first_submit = float("inf")
        self._t_last_finish = 0.0
        self._sum_speedup = 0.0
        self._n_speedup = 0
        self._sum_mispred = 0.0
        self._n_mispred = 0
        self._stage_s = dict.fromkeys(_STAGE_KEYS, 0.0)
        self._by_workload: dict[str, _WorkloadStats] = {}
        self._by_tenant: dict[str, _TenantStats] = {}
        self._shed = 0
        self._expired = 0

    def record(self, rec: RequestRecord) -> None:
        """Fold one completed record in (scheduler worker thread calls this
        while readers snapshot — everything mutates under the lock).  The
        metrics feed happens *inside* the lock so a concurrent ``stats()``
        sees counters and breakdowns move together (lock order telemetry →
        metrics; the metrics lock is never held across a telemetry call)."""
        lat = rec.latency_s
        with self._lock:
            self.records.append(rec)
            self._n += 1
            self._tuned += rec.tuned
            self._cache_hits += rec.cache_hit
            self._bytes_moved += rec.bytes_in + rec.bytes_out
            self._sum_queue_wait += rec.queue_wait
            self._sum_latency += lat
            self._min_latency = min(self._min_latency, lat)
            self._max_latency = max(self._max_latency, lat)
            self._t_first_submit = min(self._t_first_submit, rec.t_submit)
            self._t_last_finish = max(self._t_last_finish, rec.t_finish)
            if rec.overlap_speedup > 0:
                self._sum_speedup += rec.overlap_speedup
                self._n_speedup += 1
            if rec.predicted_overlap and rec.overlap_speedup:
                self._sum_mispred += rec.overlap_misprediction
                self._n_mispred += 1
            for key in _STAGE_KEYS:
                self._stage_s[key] += getattr(rec.phases, key)
            self._by_workload.setdefault(
                rec.workload, _WorkloadStats()).add(rec)
            self._by_tenant.setdefault(
                rec.tenant, _TenantStats()).add(rec)
            m = self.metrics
            m.inc("requests")
            m.inc("bytes_moved", rec.bytes_in + rec.bytes_out)
            m.observe("latency_s", lat)
            m.observe("queue_wait_s", rec.queue_wait)
            m.observe("service_s", rec.service_s)
            for key in _STAGE_KEYS:
                m.inc(f"{key}_s", getattr(rec.phases, key))

    def count_outcome(self, tenant: str, outcome: str) -> None:
        """Count a non-completion outcome (DESIGN.md §13): ``"shed"`` —
        refused/evicted by backpressure — or ``"expired"`` — deadline
        passed before dispatch.  Folded under the same lock as the record
        counters so shed/expired totals never drift from the per-tenant
        rows a concurrent ``stats()`` reports."""
        if outcome not in ("shed", "expired"):
            raise ValueError(f"unknown outcome {outcome!r}")
        with self._lock:
            ts = self._by_tenant.setdefault(tenant, _TenantStats())
            setattr(ts, outcome, getattr(ts, outcome) + 1)
            if outcome == "shed":
                self._shed += 1
            else:
                self._expired += 1
            self.metrics.inc(outcome)

    def __len__(self) -> int:
        return self._n

    def reset(self) -> None:
        """Drop the record window AND the running aggregates/metrics —
        what benchmarks use between warmup and the measured run."""
        with self._lock:
            self.records.clear()
            self._reset_running()
            self.metrics.reset()

    def _aggregate_locked(self) -> dict:
        """The aggregate view, caller holds ``self._lock``.  Percentiles
        come from the metrics registry *inside* the telemetry lock so they
        cannot run ahead of the counters they are reported next to."""
        if not self._n and not self._shed and not self._expired:
            return {"requests": 0}
        n = self._n
        wall = max(self._t_last_finish - self._t_first_submit, 1e-12)
        out = {
            "requests": n,
            "wall_s": wall,
            "requests_per_s": n / wall,
            "mean_queue_wait_s": self._sum_queue_wait / max(1, n),
            "mean_latency_s": self._sum_latency / max(1, n),
            "min_latency_s": self._min_latency,
            "max_latency_s": self._max_latency,
            "bytes_moved": self._bytes_moved,
            "aggregate_gbps": self._bytes_moved / wall / 1e9,
            "mean_overlap_speedup": (self._sum_speedup / self._n_speedup
                                     if self._n_speedup else 0.0),
            "tuned_requests": self._tuned,
            "cache_hits": self._cache_hits,
            "shed": self._shed,
            "expired": self._expired,
            "mean_overlap_misprediction": (
                self._sum_mispred / self._n_mispred
                if self._n_mispred else 0.0),
            "stage_seconds": {f"{k}_s": v
                              for k, v in self._stage_s.items()},
            "workloads": {name: ws.row()
                          for name, ws in self._by_workload.items()},
            "tenants": {name: ts.row()
                        for name, ts in self._by_tenant.items()},
        }
        out["percentiles"] = {
            name: pcts for name in ("latency_s", "queue_wait_s", "service_s")
            if (pcts := self.metrics.percentiles(name))}
        return out

    def aggregate(self) -> dict:
        """Lifetime aggregates from the running counters (exact even after
        the ring buffer evicted old records), including latency extremes,
        p50/p90/p99 percentiles, per-stage second totals, and one breakdown
        row per workload and per tenant."""
        with self._lock:
            return self._aggregate_locked()

    def stats(self) -> dict:
        """The merged telemetry-plus-metrics view ``session.stats()``
        serves: lifetime aggregates with the live counter snapshot and the
        queue-depth histogram folded in.  One construction site — the
        session façade (and anything else wanting the combined view) calls
        this instead of re-implementing the merge.  The whole view is built
        under the telemetry lock, so a snapshot taken mid-``record()``
        cannot report counters that disagree with the breakdowns
        (DESIGN.md §13)."""
        with self._lock:
            out = self._aggregate_locked()
            snap = self.metrics.snapshot()
        out["counters"] = snap["counters"]
        if "queue_depth" in snap["histograms"]:
            out["queue_depth"] = snap["histograms"]["queue_depth"]
        return out

    def snapshot_records(self) -> list[RequestRecord]:
        """Consistent copy of the record window (readers iterate this, not
        the live deque the worker thread is appending to)."""
        with self._lock:
            return list(self.records)

    def rows(self, n_banks: int | None = None,
             table: str = "runtime_requests") -> list:
        return [{"table": table, **r.row(n_banks)}
                for r in self.snapshot_records()]
