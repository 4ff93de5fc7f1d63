"""`PimSession` — the UPMEM-host-API-shaped surface of the runtime
(DESIGN.md §9), the PyTorch counterpart of ``repro.pim.session``.

The paper's programmability story is the UPMEM host library: one handle
hides banks, transfers, and launch mechanics (`dpu_alloc` → `dpu_copy_to` →
`dpu_launch` → `dpu_copy_from` → `dpu_free`, §2.3).  This module is that
layer for the port: one object that owns the :class:`BankGrid`, the
workload registry view, the tuned plans, and a telemetry sink, so callers
never hand-assemble ``make_bank_grid()`` + ``REGISTRY[name]`` +
``PimScheduler`` + ``TunedPlan`` plumbing themselves.

    from repro_torch import pim

    with pim.session(ranks=32, banks_per_rank=64) as s:   # dpu_alloc
        req = s.submit("GEMV", A, x,                 # async launch -> future
                       options=pim.RequestOptions(priority=1))
        y1 = s.run("SpMV", vals, cols, v)            # sync launch
        ys = s.map("RED", [(x1,), (x2,), (x3,)])     # streamed batch
        y2 = req.result()
    # session closed: banks released, submit() now raises   # dpu_free

The banks live on ``cuda:0`` unless the caller passes ``device="cpu"``
(the parity tests do); without a CUDA device and without ``device=``,
opening a session raises.

Multi-tenant serving (DESIGN.md §13): ``pim.session(tenants={"gold": 2,
"free": 1}, max_queue_depth=64, shed="reject")`` opens the QoS tier —
requests carry a :class:`~repro_torch.runtime.qos.RequestOptions` (tenant /
priority / deadline_s / weight), tenants share the banks under
weighted-fair dispatch with EDF ordering inside each queue, and beyond
``max_queue_depth`` submits are shed (:class:`QueueFull`) or block.  The
legacy ``priority=`` int still works behind a DeprecationWarning.

The UPMEM verb mapping is tabulated in DESIGN.md §9.  Two execution modes,
mirroring the scheduler underneath:

* **deterministic** (default): ``run()`` / ``map()`` / ``drain()`` execute
  queued work in the calling thread — what benchmarks and tests use;
* **serving** (``with pim.session(...)`` or ``start()``): a worker thread
  owns all device work and serves ``submit()`` futures as they arrive.

``run()`` auto-picks execution per registry entry: pipelineable workloads go
through the chunk pipeline (tuned plan if one is installed, from
``autotune`` or ``plans=``), serialized-only workloads (NW, BFS) fall back
to the faithful ``pim()``.
``PimScheduler`` / ``run_pipelined*`` remain the documented internal layer
(DESIGN.md §5) — reachable via :attr:`PimSession.scheduler` when the façade
is too coarse.
"""
from __future__ import annotations

import os
from typing import TYPE_CHECKING, Any, Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.banked import BankGrid, make_bank_grid, make_rank_grid
from repro_torch.core.perfmodel import mram_capacity_bytes
from repro_torch.core.streams import release_cublas_workspaces
from repro_torch.runtime.autotune import DEFAULT_N_CHUNKS, TuningResult
from repro_torch.runtime.pipeline import (_effective_chunks, _resolve_ranks,
                                          run_pipelined_ranked)
from repro_torch.runtime.qos import RequestOptions
from repro_torch.runtime.resident import ResidentCache, unwrap_handles
from repro_torch.runtime.scheduler import PimRequest, PimScheduler
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.runtime.trace import NULL_SPAN, Tracer, set_tracer

if TYPE_CHECKING:  # annotation-only: importing repro_torch.prim pulls the suite
    from repro_torch.prim.registry import WorkloadEntry

    from repro_torch.runtime.autotune import TunedPlan


def session(banks: int | None = None, *, ranks: int | None = None,
            banks_per_rank: int | None = None,
            autotune: bool | Mapping = False, device=None,
            **kwargs) -> "PimSession":
    """``dpu_alloc`` analogue: allocate a grid of ``banks`` banks (default
    1) on ``device`` (default ``cuda:0``; raises without CUDA unless
    ``device="cpu"``) and return the session handle that owns it.

    ``ranks``/``banks_per_rank`` allocate the two-level rank × bank
    hierarchy instead (DESIGN.md §10) — ``pim.session(ranks=2,
    banks_per_rank=4)`` is 2 ranks of 4 banks, with requests sharded
    across the ranks and one chunk pipeline per rank.  The default
    (``ranks=1``-equivalent, or the ``REPRO_RANKS`` env var when set and
    divisible) keeps today's flat behavior.

    ``autotune=True`` calibrates the grid's device and installs
    per-workload tuned plans before the first request (DESIGN.md §8) —
    including the rank-count dimension on a ranked grid; pass a dict
    (e.g. ``autotune={"reps": 2, "probe": False}``) to forward options to
    :meth:`PimSession.autotune`.  Remaining ``kwargs`` go to
    :class:`PimSession`.
    """
    return PimSession(banks=banks, ranks=ranks,
                      banks_per_rank=banks_per_rank, autotune=autotune,
                      device=device, **kwargs)


def registry() -> Mapping[str, "WorkloadEntry"]:
    """The session-level workload registry view: name -> WorkloadEntry
    (lazy — importing the registry pulls the whole PrIM suite)."""
    from repro_torch.prim.registry import REGISTRY
    return REGISTRY


class PimSession:
    """One handle over grid + registry + plans + telemetry (DESIGN.md §9).

    Constructed via :func:`session` (allocates its own grid) or directly
    with ``grid=`` to wrap an existing :class:`BankGrid` (benchmarks reuse
    one grid — and its compiled phase cache — across many sessions).
    """

    def __init__(self, grid: BankGrid | None = None, *,
                 banks: int | None = None,
                 ranks: int | None = None,
                 banks_per_rank: int | None = None,
                 autotune: bool | Mapping = False,
                 plans: Mapping[str, "TunedPlan"] | TuningResult | None = None,
                 n_chunks: int = DEFAULT_N_CHUNKS,
                 max_batch_requests: int = 8,
                 max_batch_bytes: int = 256 << 20,
                 telemetry: Telemetry | None = None,
                 trace: bool | str | None = None,
                 resident: bool | int | ResidentCache = True,
                 tenants: Mapping[str, float] | Iterable[str] | None = None,
                 max_queue_depth: int | None = None,
                 shed: str | bool = "reject",
                 policy: str = "qos",
                 device=None):
        if grid is not None and (banks is not None or ranks is not None
                                 or banks_per_rank is not None
                                 or device is not None):
            raise ValueError("pass either grid= or a banks/ranks shape, "
                             "not both")
        if banks_per_rank is not None and ranks is None:
            raise ValueError("banks_per_rank= needs ranks=")
        if grid is not None:
            self._grid = grid
        elif ranks is not None:
            if banks is not None and banks_per_rank is not None \
                    and banks != ranks * banks_per_rank:
                raise ValueError(f"banks={banks} != ranks*banks_per_rank="
                                 f"{ranks * banks_per_rank}")
            if banks_per_rank is None and banks is not None:
                if banks % ranks:
                    raise ValueError(f"banks={banks} does not split into "
                                     f"{ranks} equal ranks")
                banks_per_rank = banks // ranks
            self._grid = make_rank_grid(ranks, banks_per_rank, device=device)
        else:
            self._grid = make_bank_grid(banks, device=device)
        self._tuning: TuningResult | None = None
        if isinstance(plans, TuningResult):
            self._tuning, plans = plans, plans.plans
        telemetry = telemetry if telemetry is not None else Telemetry()
        # resident-operand cache (DESIGN.md §12): on by default, budgeted
        # against the per-bank MRAM capacity model; an int is an explicit
        # byte budget (resident=False disables — every request re-scatters)
        if isinstance(resident, ResidentCache):
            cache = resident
        elif resident:
            budget = (resident if not isinstance(resident, bool)
                      else mram_capacity_bytes(self._grid.n_banks))
            cache = ResidentCache(budget, metrics=telemetry.metrics)
        else:
            cache = None
        self._sched = PimScheduler(
            self._grid, n_chunks=n_chunks,
            max_batch_requests=max_batch_requests,
            max_batch_bytes=max_batch_bytes, plans=plans,
            telemetry=telemetry, cache=cache, tenants=tenants,
            max_queue_depth=max_queue_depth, shed=shed, policy=policy)
        # tracing (DESIGN.md §11): off by default; ``trace=True`` records
        # spans for explicit trace_export(), a path (or the REPRO_TRACE env
        # var when trace is None) also auto-exports at close().  The session
        # tracer is installed as the process-wide active tracer and the
        # previous one restored at close() — last-opened session wins.
        if trace is None:
            trace = os.environ.get("REPRO_TRACE") or False
        self._trace_path = trace if isinstance(trace, str) else None
        self._tracer: Tracer | None = Tracer() if trace else None
        self._prev_tracer = (set_tracer(self._tracer)
                             if self._tracer is not None else None)
        self._closed = False
        self._serving = False
        # an empty options mapping still means "autotune with defaults"
        if autotune or isinstance(autotune, Mapping):
            self.autotune(**(dict(autotune) if isinstance(autotune, Mapping)
                             else {}))

    # -- handle state ---------------------------------------------------------

    @property
    def grid(self) -> BankGrid:
        """The owned :class:`BankGrid` (the ``dpu_set`` analogue)."""
        return self._grid

    @property
    def n_banks(self) -> int:
        return self._grid.n_banks

    @property
    def n_ranks(self) -> int:
        """Rank count of the owned grid (1 on a flat grid) — DESIGN.md §10."""
        return getattr(self._grid, "n_ranks", 1)

    @property
    def banks_per_rank(self) -> int:
        return self.n_banks // self.n_ranks

    @property
    def scheduler(self) -> PimScheduler:
        """Escape hatch to the documented internal layer (DESIGN.md §5)."""
        return self._sched

    @property
    def telemetry(self) -> Telemetry:
        """Completed-request records + aggregates for this session."""
        return self._sched.telemetry

    @property
    def plans(self) -> dict[str, "TunedPlan"]:
        """Installed per-workload tuned plans (empty = untuned constants)."""
        return self._sched.plans

    @property
    def tuning(self) -> TuningResult | None:
        """Full calibration result of the last :meth:`autotune` (or the
        TuningResult passed as ``plans=``); None when untuned."""
        return self._tuning

    @property
    def workloads(self) -> tuple[str, ...]:
        """Every servable workload name (registry order): pipelineable
        entries first-class, serialized-only entries via the fallback."""
        return tuple(self._sched.workloads) + tuple(self._sched.serialized)

    @property
    def cache(self) -> ResidentCache | None:
        """The resident-operand cache (DESIGN.md §12); None when the
        session was opened with ``resident=False``."""
        return self._sched.cache

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def serving(self) -> bool:
        """True between :meth:`start` and :meth:`close` — the worker thread
        owns dispatch and ``drain()`` is forbidden (results arrive via
        futures).  The decode engine branches on this to drive its step
        groups in either mode."""
        return self._serving

    @property
    def tracer(self) -> Tracer | None:
        """This session's span tracer (None when tracing is off) —
        DESIGN.md §11.  Enable with ``trace=True`` / ``trace="out.json"`` or
        the ``REPRO_TRACE=path`` env var."""
        return self._tracer

    def trace_export(self, path: str | None = None) -> str:
        """Write the recorded spans as a Chrome/Perfetto ``trace_event``
        JSON file (load it at ui.perfetto.dev or chrome://tracing).
        ``path`` defaults to the configured trace path (``trace="..."`` or
        ``REPRO_TRACE``); returns the path written."""
        if self._tracer is None:
            raise RuntimeError("trace_export() on an untraced session — "
                               "open it with trace=True / trace=path or set "
                               "REPRO_TRACE")
        path = path or self._trace_path
        if not path:
            raise ValueError("no export path: pass trace_export(path) or "
                             "open the session with trace='out.json'")
        self._tracer.export(path)
        return path

    def stats(self) -> dict:
        """Aggregate telemetry + live metrics (DESIGN.md §11): requests/sec,
        mean/min/max latency, p50/p90/p99 percentiles, per-stage seconds,
        per-workload breakdown, raw counters, residency-cache counters
        (``cache``), per-tenant rows (``tenants`` — completion-side
        counts from telemetry merged with the scheduler's live queue-side
        weight/queued/vtime, DESIGN.md §13), and — when tracing — span
        counts."""
        out = self.telemetry.stats()      # merged telemetry + metrics view
        tenants = dict(out.get("tenants") or {})
        for name, live in self._sched.tenants().items():
            row = dict(tenants.get(name) or {})
            row.update(live)
            tenants[name] = row
        if tenants:
            out["tenants"] = tenants
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        if self._tracer is not None:
            out["trace"] = {"spans": len(self._tracer.spans),
                            "dropped_spans": self._tracer.dropped}
        return out

    def pending(self) -> int:
        return self._sched.pending()

    def _check_open(self, verb: str) -> None:
        if self._closed:
            raise RuntimeError(f"{verb}() on a closed PimSession — the "
                               "banks were released at close()")

    # -- tuning ---------------------------------------------------------------

    def autotune(self, entries: Sequence | None = None, *, scale: int = 1,
                 reps: int = 3, probe: bool = True, **kwargs) -> TuningResult:
        """Calibrate the grid's device, fit per-workload stage models, and
        install the solved plans (chunk count + batch size) on this session
        — :meth:`PimScheduler.autotuned` behind the façade (DESIGN.md §8).

        ``entries`` restricts tuning to a subset (registry names or
        WorkloadEntry objects); the result also lands in :attr:`tuning`.
        Re-tuning updates plans in place.
        """
        from repro_torch.runtime.autotune import autotune as _autotune
        self._check_open("autotune")
        if entries is not None:
            reg = registry()
            entries = [reg[e] if isinstance(e, str) else e for e in entries]
        result = _autotune(self._grid, entries, scale=scale, reps=reps,
                           probe=probe, **kwargs)
        self._sched.plans.update(result.plans)
        self._tuning = result
        return result

    # -- launch verbs ---------------------------------------------------------

    def submit(self, workload: str, *args,
               options: RequestOptions | None = None,
               priority: int | None = None) -> PimRequest:
        """Asynchronous launch: enqueue one invocation, return its future.
        In serving mode the worker thread picks it up; in deterministic mode
        it waits for the next :meth:`drain` / :meth:`run`.  QoS (tenant /
        priority / deadline / weight, DESIGN.md §13) comes in via
        ``options=``; the legacy ``priority=`` int still works behind a
        DeprecationWarning."""
        self._check_open("submit")
        return self._sched.submit(workload, *args, options=options,
                                  priority=priority)

    def run(self, workload: str, *args,
            options: RequestOptions | None = None,
            priority: int | None = None,
            timeout: float | None = None) -> Any:
        """Synchronous launch (``dpu_launch`` + ``dpu_sync``): run one
        invocation to completion and return its result.  Pipelined vs
        serialized-only execution is picked per registry entry; a tuned plan
        overrides the chunk count when installed."""
        self._check_open("run")
        tr = self._tracer
        with (tr.span(f"run:{workload}", "session", track="session",
                      workload=workload) if tr is not None
              else NULL_SPAN):
            req = self._sched.submit(workload, *args, options=options,
                                     priority=priority)
            if self._serving:
                return req.result(timeout=timeout)
            self._sched.drain()
            return req.result(timeout=0)

    def map(self, workload: str, arg_stream: Iterable[tuple], *,
            options: RequestOptions | None = None) -> list:
        """Streamed batch: run many same-workload invocations back-to-back.

        In deterministic mode pipelineable workloads stream *all* their
        chunks through one pipeline (``run_pipelined_many`` — the banks
        never drain between requests, ignoring the scheduler's batch caps);
        serialized-only workloads fall back per item.  In serving mode the
        requests are submitted to the worker thread, whose size-aware
        batching coalesces them.  Results come back in stream order.
        """
        self._check_open("map")
        args_list = [tuple(a) for a in arg_stream]
        if not args_list:
            return []
        tr = self._tracer
        with (tr.span(f"map:{workload}", "session", track="session",
                      workload=workload, requests=len(args_list))
              if tr is not None else NULL_SPAN):
            return self._map(workload, args_list, options)

    def _map(self, workload: str, args_list: list,
             options: RequestOptions | None = None) -> list:
        if self._serving or workload not in self._sched.workloads:
            # serving (worker thread owns dispatch) or serialized-only /
            # unknown: the scheduler path handles all three
            reqs = [self.submit(workload, *a, options=options)
                    for a in args_list]
            if not self._serving:
                self._sched.drain()
            return [r.result() for r in reqs]
        records = [self._sched.make_record(workload, a, options)
                   for a in args_list]
        results = run_pipelined_ranked(
            self._grid, self._sched.workloads[workload], args_list,
            n_chunks=self._sched.n_chunks,
            plan=self._sched.plans.get(workload), records=records,
            cache=self._sched.cache)
        for rec, res in zip(records, results):
            rec.bytes_out = res.nbytes if isinstance(res, np.ndarray) else 0
            self.telemetry.record(rec)
        return results

    def drain(self) -> int:
        """Deterministic mode: process every queued request in the calling
        thread; returns the number completed."""
        self._check_open("drain")
        if self._serving:
            raise RuntimeError("drain() while serving — results arrive via "
                               "their futures; stop()/close() to drain out")
        return self._sched.drain()

    # -- explicit transfers (power users; run()/map() do this for you) --------

    def transfer_in(self, x, spec=None, *, broadcast: bool = False):
        """``dpu_copy_to`` / ``dpu_push_xfer`` escape hatch: place ``x`` on
        the banks — bank-major along its leading axis (default) or one
        buffer every bank reads (``broadcast=True``, ``dpu_broadcast_to``).
        On one device the leading axis is the bank axis, so the
        reference's sharding ``spec`` has no counterpart: only ``None`` is
        taken."""
        self._check_open("transfer_in")
        if spec is not None:
            raise ValueError("transfer_in(spec=...) has no counterpart on "
                             "one device: the leading axis is the bank axis")
        if broadcast:
            return self._grid.broadcast(x)
        return self._grid.to_banks(x)

    def transfer_out(self, x) -> np.ndarray:
        """``dpu_copy_from`` escape hatch: gather a banked array to host."""
        self._check_open("transfer_out")
        return self._grid.from_banks(x)

    # -- operand residency (DESIGN.md §12) -------------------------------------

    def pin(self, workload: str, *args) -> str:
        """Pre-place ``workload``'s resident operand on the banks and pin it
        against LRU eviction — the ``dpu_copy_to``-once escape hatch.

        ``args`` is the full positional argument tuple the later
        ``run()``/``submit()`` calls will pass (the non-resident positions
        only key the fingerprint through the resident ones, so any value of
        the varying args works).  The operand is split and scattered in
        exactly the placement the serving path will use (same chunk depth,
        same rank blocks), so the first real request is already warm.
        Returns the entry's fingerprint (pass it to :meth:`unpin`).

        Warm requests still rehash the operand's bytes to find the entry
        (content addressing); callers who guarantee immutability can skip
        that recurring cost by passing the operand wrapped in a
        :class:`~repro_torch.runtime.resident.ResidentHandle` — here and in
        ``run()``/``submit()``/``map()``.
        """
        self._check_open("pin")
        cache = self._sched.cache
        if cache is None:
            raise RuntimeError("pin() on a session opened with "
                               "resident=False")
        wl = self._sched.workloads.get(workload)
        if wl is None or not wl.supports_residency:
            raise ValueError(f"workload {workload!r} has no resident "
                             "operand (see the registry's resident column)")
        plan = self._sched.plans.get(workload)
        n_ranks = _resolve_ranks(self._grid, None, plan)
        n_chunks, _ = _effective_chunks(wl, self._sched.n_chunks, plan,
                                        cache)
        total = n_ranks * n_chunks if n_ranks > 1 else n_chunks
        ent, _ = cache.acquire(wl, args, (self.n_banks, n_ranks, total),
                               pin=True)
        if ent is None:
            raise RuntimeError(
                f"{workload} operand does not fit the residency budget "
                f"({cache.budget_bytes} bytes) even after eviction")
        try:
            if not ent.ready:
                res = tuple(unwrap_handles(args)[j]
                            for j in wl.resident_args)
                for r in range(n_ranks):
                    view = (self._grid.rank_view(r) if n_ranks > 1
                            else self._grid)
                    rm0, res_chunks = wl.split_resident(view, total, *res)
                    rm = ent.set_rank_meta(r, rm0,
                                           n_chunks=len(res_chunks or ()))
                    if res_chunks is not None:
                        per = -(-len(res_chunks) // n_ranks)
                        for g in range(r * per,
                                       min((r + 1) * per, len(res_chunks))):
                            with ent.lock:
                                if ent.get(g) is None:
                                    ent.store(g, wl.scatter(view, rm,
                                                            res_chunks[g]))
        finally:
            cache.release(ent)           # drop the acquire() lease; the
                                         # pin itself keeps it unevictable
        return ent.fingerprint

    def unpin(self, fingerprint: str) -> bool:
        """Release a :meth:`pin`: the entry stays resident but becomes
        evictable again.  Returns False when the fingerprint is unknown
        (already evicted, or the cache is disabled)."""
        self._check_open("unpin")
        cache = self._sched.cache
        return cache.unpin(fingerprint) if cache is not None else False

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "PimSession":
        """Enter serving mode: a worker thread owns all device work and
        serves submitted requests as they arrive."""
        self._check_open("start")
        if not self._serving:
            self._sched.start()
            self._serving = True
        return self

    def close(self) -> None:
        """``dpu_free`` analogue: finish everything queued, stop the worker
        thread, release the resident cache, and refuse further launches.
        Idempotent — a second close() is a no-op.

        On CUDA it also frees the cuBLAS workspaces that its pipelines'
        threads and streams took (``core.streams.release_cublas_workspaces``).
        PyTorch keeps those for the whole process and frees them only all
        at once, every thread's and handle's: close a CUDA session while no
        other thread of the process is running a matmul."""
        if self._closed:
            return
        if self._serving:
            self._sched.stop()
            self._serving = False
        elif self._sched.pending():
            self._sched.drain()      # no future may be left dangling
        if self._sched.cache is not None:
            self._sched.cache.clear()    # release resident device arrays
        if self._grid.device.type == "cuda":
            release_cublas_workspaces()  # its pipelines' matmuls took them
        if self._tracer is not None:
            if self._trace_path:
                self._tracer.export(self._trace_path)
            set_tracer(self._prev_tracer)   # restore whoever was active
        self._closed = True

    def __enter__(self) -> "PimSession":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        state = ("closed" if self._closed
                 else "serving" if self._serving else "open")
        shape = (f"{self.n_ranks}x{self.banks_per_rank} ranks x banks"
                 if self.n_ranks > 1 else f"{self.n_banks} banks")
        return (f"PimSession({shape}, {state}, "
                f"{len(self.plans)} tuned plans, "
                f"{len(self.telemetry)} records)")
