"""Double-buffered chunk pipeline over a BankGrid on one GPU — the PyTorch
counterpart of ``repro.runtime.pipeline``.

The UPMEM SDK (and the faithful ``prim.*.pim()`` baselines) serialize the
three phases of every workload invocation:

    scatter | compute | retrieve | scatter | compute | retrieve | ...

The reference overlaps them through JAX's asynchronous dispatch and
``copy_to_host_async``.  On the card each stage has a CUDA stream of its
own (``core/streams.py``): chunk k+1's scatter is staged through pinned
host memory and copied on the H2D stream while chunk k's bank-local phase
runs on the compute stream (which waits on its scatter's event), and
chunk k-1's outputs drain into pinned memory on the D2H stream; a
retrieve waits on its copy's event, never on the whole device.  The
steady state is the classic three-stage software pipeline:

    scatter k+1  ─┐
    compute k     ├─ concurrent
    retrieve k-1 ─┘

``run_pipelined_many`` generalizes to a *stream* of same-workload requests:
their chunks flow through one pipeline back-to-back, so the banks never
drain between requests — that is the scheduler's batching payoff.

``run_pipelined_ranked`` adds the second level of the hierarchy
(DESIGN.md §10): on a :class:`~repro_torch.core.banked.RankGrid` every
request's chunks are sharded across ranks in contiguous blocks and each
rank drives its own double-buffered pipeline on its own stream set (one
thread per rank; a rank view owns its streams, and
``torch.cuda.stream`` is thread-local, so the ranks' copies run
concurrently, the analogue of the paper's rank-parallel CPU↔DPU
transfers).  The host merges each request's parts in global chunk order,
so order-sensitive merges (SCAN's running offset) stay correct.

On the CPU a grid has no streams and every stage runs synchronously, in
the same order.  ``PhaseTimes`` stay host-clock buckets, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import TYPE_CHECKING, Any, Sequence

from repro_torch.core.banked import BankGrid
from repro_torch.core.streams import NO_STREAMS
from repro_torch.core.transfer import tree_nbytes

from .resident import unwrap_handles
from .telemetry import RequestRecord, _phases
from .trace import get_tracer

if TYPE_CHECKING:  # annotation-only: importing repro_torch.prim pulls the suite
    from repro_torch.prim.common import ChunkedWorkload, PhaseTimes

    from .autotune import TunedPlan


@dataclasses.dataclass
class PipelineResult:
    value: Any
    makespan: float
    phases: PhaseTimes      # host-observed buckets (see telemetry docstring)
    n_chunks: int


class _Buckets:
    """Accumulate host wall time into PhaseTimes buckets."""

    def __init__(self):
        self.times = _phases()

    def add(self, phase: str, t0: float) -> float:
        t1 = time.perf_counter()
        setattr(self.times, phase, getattr(self.times, phase) + (t1 - t0))
        return t1


def _effective_chunks(workload, n_chunks, plan, cache) -> tuple[int, bool]:
    """Resolve the pipeline depth and whether the resident cache is in play.

    A plan overrides ``n_chunks``; when the cache applies and the plan
    carries a warm solve, the *warm* depth wins for cold fills too — the
    fingerprint bakes in the chunk count (placement spec), so fill and hit
    must agree on one depth for the fill to ever be reused."""
    use_cache = cache is not None and workload.supports_residency
    if plan is not None:
        n_chunks = plan.n_chunks
        if use_cache and getattr(plan, "warm_n_chunks", 0):
            n_chunks = plan.warm_n_chunks
    return n_chunks, use_cache


def _refill_chunk(view, workload, args, total, gidx):
    """Recompute one resident chunk whose warm-hit ``None`` placeholder
    outlived its entry (the cache was cleared/released mid-flight — the
    in-flight lease makes eviction impossible, so this is a last-resort
    self-heal, not a hot path): re-run the resident split and hand back
    the real chunk so the request degrades to a plain scatter."""
    res = tuple(unwrap_handles(args)[j] for j in workload.resident_args)
    _, res_chunks = workload.split_resident(view, total, *res)
    return res_chunks[gidx]


def _split_with_cache(view, workload, args, total, ent, rank=0, hit=False):
    """Split one request against a resident entry (or plainly when
    ``ent`` is None).  Returns (meta, chunks) where chunks are ``None``
    placeholders only on a warm **hit** — their device buffers already live
    in the ready entry.  On a miss the real chunk list is always produced,
    even when another request already installed the rank meta (a second
    filler of the same fingerprint, or a retry after a failed fill, must be
    able to push the buffers the entry is still missing; already-stored
    chunks are deduplicated under the entry lock at scatter time)."""
    args = unwrap_handles(args)           # workloads never see the token
    if ent is None:
        return workload.split(view, total, *args)
    res = tuple(args[j] for j in workload.resident_args)
    rm = ent.rank_meta(rank)
    res_chunks = None
    if rm is None:
        rm0, res_chunks = workload.split_resident(view, total, *res)
        rm = ent.set_rank_meta(rank, rm0,
                               n_chunks=len(res_chunks or ()))
    meta, var_chunks = workload.split_varying(view, total, rm, *args)
    if ent.chunk_resident:
        if hit:
            chunks = [None] * ent.expected_chunks
        elif res_chunks is None:
            _, res_chunks = workload.split_resident(view, total, *res)
            chunks = res_chunks
        else:
            chunks = res_chunks
    else:
        chunks = var_chunks
    return meta, chunks


def run_pipelined(grid: BankGrid, workload: ChunkedWorkload, *args,
                  n_chunks: int = 4, plan: TunedPlan | None = None,
                  record: RequestRecord | None = None,
                  cache=None) -> PipelineResult:
    """Run one request through the chunk pipeline; returns PipelineResult.
    A :class:`~repro_torch.runtime.autotune.TunedPlan` overrides
    ``n_chunks``; a :class:`~repro_torch.runtime.resident.ResidentCache`
    serves warm scatters."""
    n_chunks, _ = _effective_chunks(workload, n_chunks, plan, cache)
    records = [record] if record is not None else None
    results, makespans, phases = run_pipelined_many(
        grid, workload, [args], n_chunks=n_chunks, plan=plan,
        records=records, cache=cache, _full=True)
    return PipelineResult(results[0], makespans[0], phases[0], n_chunks)


def run_pipelined_many(grid: BankGrid, workload: ChunkedWorkload,
                       requests: Sequence[tuple], n_chunks: int = 4,
                       plan: TunedPlan | None = None,
                       records: Sequence[RequestRecord] | None = None,
                       cache=None, _full: bool = False):
    """Stream every request's chunks through one double-buffered pipeline.

    ``requests`` is a sequence of argument tuples for ``workload``.  Returns
    the list of results (plus per-request makespans and phase buckets when
    ``_full``).  Requests complete in submission order; a request's result is
    merged as soon as its last chunk retires, while later requests' chunks
    are already in flight.  A :class:`~repro_torch.runtime.autotune.TunedPlan`
    overrides ``n_chunks`` and stamps its predicted overlap on the records;
    a :class:`~repro_torch.runtime.resident.ResidentCache` lets requests whose
    resident operand is already placed skip the scatter stage (DESIGN.md
    §12) — served chunks emit ``scatter:cached`` spans instead of pushes.
    """
    n_chunks, use_cache = _effective_chunks(workload, n_chunks, plan, cache)
    if plan is not None and records is not None:
        stage_pred = dict(getattr(plan, "predicted_stage_s", {}) or {})
        for rec in records:
            rec.tuned = True
            rec.predicted_overlap = plan.predicted_overlap
            if stage_pred:
                rec.predicted_stage_s = dict(stage_pred)
    n_req = len(requests)
    metas: list = [None] * n_req
    entries: list = [None] * n_req        # ResidentEntry per request
    flat: list = []                       # (req_idx, chunk_idx, chunk)
    bucket = [_Buckets() for _ in range(n_req)]
    t_start = [0.0] * n_req
    t_done = [0.0] * n_req
    parts: list = [[] for _ in range(n_req)]
    chunk_count = [0] * n_req
    results: list = [None] * n_req
    tr = get_tracer()                     # off-by-default span tracer
    chunk_bytes: dict = {}                # per-request span tag cache: chunks
                                          # are equal-shaped, size them once
    st = grid.streams or NO_STREAMS       # the three stages' CUDA streams

    def _rid(i):
        return records[i].request_id if records is not None else i

    t0 = time.perf_counter()

    def scatter(k):
        i, ci, chunk = flat[k]
        if not t_start[i]:
            t_start[i] = time.perf_counter()
        ts = time.perf_counter()
        ent = entries[i]
        served = False
        with st.scattering():
            if ent is not None and ent.chunk_resident:
                # exactly-once device push: the entry lock is held across
                # the scatter so a second filler of the same fingerprint
                # can only observe the stored buffers, never race the push
                with ent.lock:
                    bufs = ent.get(ci)
                    if bufs is None:
                        if chunk is None:  # placeholder outlived the entry
                            chunk = _refill_chunk(grid, workload,
                                                  requests[i], n_chunks, ci)
                        bufs = workload.scatter(grid, metas[i], chunk)
                        ent.store(ci, bufs, st.scattered())
                    else:
                        st.after(ent.landed(ci))
                        served = True
            else:
                bufs = workload.scatter(grid, metas[i], chunk)
        done = st.scattered()
        t1 = bucket[i].add("cpu_dpu", ts)
        if tr.enabled:
            if served:
                nb = ent.nbytes // max(1, ent.expected_chunks)
                tr.emit("scatter:cached", "cpu_dpu", ts, t1,
                        workload=workload.name, req=_rid(i), chunk=ci,
                        bytes=nb, fingerprint=ent.fingerprint)
            else:
                if (nb := chunk_bytes.get(i)) is None:
                    nb = chunk_bytes[i] = tree_nbytes(chunk)
                tr.emit("scatter", "cpu_dpu", ts, t1, workload=workload.name,
                        req=_rid(i), chunk=ci, bytes=nb)
        return bufs, done

    def retire(entry):
        """Block for one in-flight chunk and fold it into its request."""
        i, ci, outs, copied = entry
        ts = time.perf_counter()
        st.wait(copied)
        parts[i].append(workload.retrieve(grid, metas[i], outs))
        t1 = bucket[i].add("dpu_cpu", ts)
        if tr.enabled:
            tr.emit("retrieve", "dpu_cpu", ts, t1, workload=workload.name,
                    req=_rid(i), chunk=ci)
        if len(parts[i]) == chunk_count[i]:
            results[i] = workload.merge(grid, metas[i], parts[i])
            t_done[i] = bucket[i].add("inter_dpu", t1)
            if tr.enabled:
                tr.emit("merge", "inter_dpu", t1, t_done[i],
                        workload=workload.name, req=_rid(i),
                        chunks=chunk_count[i])

    try:
        for i, args in enumerate(requests):
            ts = time.perf_counter()
            ent, hit = (cache.acquire(workload, args,
                                      (grid.n_banks, 1, n_chunks))
                        if use_cache else (None, False))
            entries[i] = ent
            metas[i], chunks = _split_with_cache(grid, workload, args,
                                                 n_chunks, ent, hit=hit)
            if (ent is not None and hit and not ent.chunk_resident
                    and tr.enabled):
                # meta-resident hit (BS): the skipped broadcast happened at
                # split time, so the cached span lands here, not per chunk
                tr.emit("scatter:cached", "cpu_dpu", ts, time.perf_counter(),
                        workload=workload.name, req=_rid(i),
                        bytes=ent.nbytes, fingerprint=ent.fingerprint)
            chunk_count[i] = len(chunks)
            flat.extend((i, ci, c) for ci, c in enumerate(chunks))
            if records is not None:
                records[i].n_chunks = len(chunks)
                records[i].cache_hit = hit
                if (hit and plan is not None
                        and getattr(plan, "warm_predicted_overlap", 0.0)):
                    records[i].predicted_overlap = plan.warm_predicted_overlap

        in_flight: list = []
        bufs, scattered = scatter(0) if flat else (None, None)
        for k in range(len(flat)):
            i, ci, _ = flat[k]
            ts = time.perf_counter()
            with st.computing(scattered, metas[i], bufs):
                outs = workload.compute(grid, metas[i], bufs)
            computed = st.computed()
            t1 = bucket[i].add("dpu", ts)
            if tr.enabled:
                tr.emit("compute", "dpu", ts, t1, workload=workload.name,
                        req=_rid(i), chunk=ci)
            if k + 1 < len(flat):
                bufs, scattered = scatter(k + 1)  # overlaps compute of chunk k
            outs, copied = st.prefetch(outs, computed)  # drain chunk k early
            in_flight.append((i, ci, outs, copied))
            if len(in_flight) > 1:       # retire k-1 while k computes
                retire(in_flight.pop(0))
        while in_flight:
            retire(in_flight.pop(0))
    finally:
        # retire every acquire() lease — including on error paths, or the
        # entries would be unevictable forever
        if use_cache:
            for ent in entries:
                cache.release(ent)

    makespans = [t_done[i] - (t_start[i] or t0) for i in range(n_req)]
    if records is not None:
        for i, rec in enumerate(records):
            rec.t_start = t_start[i] or t0
            rec.t_finish = t_done[i]
            rec.phases = bucket[i].times
    if _full:
        return results, makespans, [b.times for b in bucket]
    return results


# ---------------------------------------------------------------------------
# rank-parallel pipelines (DESIGN.md §10)
# ---------------------------------------------------------------------------

def _req_id(records, i: int) -> int:
    """Span tag: the request's telemetry id when records ride along, else
    its batch-local index."""
    return records[i].request_id if records is not None else i

def _resolve_ranks(grid, n_ranks, plan) -> int:
    """Effective rank count.  An explicit caller ``n_ranks`` wins — that is
    how the scheduler's elastic allocator (DESIGN.md §13) and the
    autotuner's rank probes override placement per batch.  Otherwise the
    plan's measured pick applies (a probed plan is authoritative even when
    it adopted 1 — flat measured best), else every rank the grid has —
    always clamped to the hardware."""
    have = getattr(grid, "n_ranks", 1)
    want = n_ranks
    if want is None and plan is not None:
        probed = bool(getattr(plan, "rank_measured_s", None))
        if probed or getattr(plan, "n_ranks", 1) > 1:
            want = plan.n_ranks
    if want is None:
        want = have
    return max(1, min(want, have))


def _rank_worker(view, workload, metas, stream, bucket, t_start, t_retired,
                 entries=None, requests=None, split_total=0):
    """One rank's double-buffered pipeline over its assigned chunk stream,
    on the rank view's own CUDA streams.

    ``stream`` is an ordered list of (req_idx, global_chunk_idx, chunk);
    returns {req_idx: [(global_chunk_idx, part), ...]} and stamps
    ``t_retired[i]`` with the wall time this rank retired request i's last
    chunk.  Same three-stage loop as :func:`run_pipelined_many`, minus the
    merge — parts go back to the caller, which merges across ranks in
    global chunk order.  ``entries`` carries per-request resident-cache
    entries (DESIGN.md §12): chunks whose buffers already live in the
    entry are served instead of pushed, under the entry lock so disjoint
    rank blocks and repeated fills stay exactly-once.  Spans land on this
    rank's own track: the caller sets the tracer's thread-local track
    override to ``rank-r`` (DESIGN.md §11), so a traced run shows one
    pipeline lane per rank."""
    parts: dict[int, list] = {}
    if not stream:
        return parts
    tr = get_tracer()
    chunk_bytes: dict = {}                # per-request cache (equal-shaped)
    st = view.streams or NO_STREAMS       # this rank's own stream set

    def scatter(k):
        i, gidx, chunk = stream[k]
        if not t_start[i]:
            t_start[i] = time.perf_counter()
        ts = time.perf_counter()
        ent = entries[i] if entries is not None else None
        served = False
        with st.scattering():
            if ent is not None and ent.chunk_resident:
                with ent.lock:
                    bufs = ent.get(gidx)
                    if bufs is None:
                        if chunk is None and requests is not None:
                            # placeholder outlived the entry (_refill_chunk)
                            chunk = _refill_chunk(view, workload, requests[i],
                                                  split_total, gidx)
                        bufs = workload.scatter(view, metas[i], chunk)
                        ent.store(gidx, bufs, st.scattered())
                    else:
                        # stored by another rank's h2d stream, maybe still
                        # in flight: this rank's scatter event follows it
                        st.after(ent.landed(gidx))
                        served = True
            else:
                bufs = workload.scatter(view, metas[i], chunk)
        done = st.scattered()
        t1 = bucket[i].add("cpu_dpu", ts)
        if tr.enabled:
            if served:
                nb = ent.nbytes // max(1, ent.expected_chunks)
                tr.emit("scatter:cached", "cpu_dpu", ts, t1,
                        workload=workload.name, req=i, chunk=gidx,
                        bytes=nb, fingerprint=ent.fingerprint)
            else:
                if (nb := chunk_bytes.get(i)) is None:
                    nb = chunk_bytes[i] = tree_nbytes(chunk)
                tr.emit("scatter", "cpu_dpu", ts, t1, workload=workload.name,
                        req=i, chunk=gidx, bytes=nb)
        return bufs, done

    def retire(entry):
        i, gidx, outs, copied = entry
        ts = time.perf_counter()
        st.wait(copied)
        parts.setdefault(i, []).append(
            (gidx, workload.retrieve(view, metas[i], outs)))
        t_retired[i] = bucket[i].add("dpu_cpu", ts)
        if tr.enabled:
            tr.emit("retrieve", "dpu_cpu", ts, t_retired[i],
                    workload=workload.name, req=i, chunk=gidx)

    in_flight: list = []
    bufs, scattered = scatter(0)
    for k in range(len(stream)):
        i, gidx = stream[k][0], stream[k][1]
        ts = time.perf_counter()
        with st.computing(scattered, metas[i], bufs):
            outs = workload.compute(view, metas[i], bufs)
        computed = st.computed()
        t1 = bucket[i].add("dpu", ts)
        if tr.enabled:
            tr.emit("compute", "dpu", ts, t1, workload=workload.name,
                    req=i, chunk=gidx)
        if k + 1 < len(stream):
            bufs, scattered = scatter(k + 1)  # overlaps compute of chunk k
        outs, copied = st.prefetch(outs, computed)
        in_flight.append((i, gidx, outs, copied))
        if len(in_flight) > 1:
            retire(in_flight.pop(0))
    while in_flight:
        retire(in_flight.pop(0))
    return parts


def run_pipelined_ranked(grid, workload: ChunkedWorkload,
                         requests: Sequence[tuple], n_chunks: int = 4,
                         n_ranks: int | None = None,
                         plan: TunedPlan | None = None,
                         records: Sequence[RequestRecord] | None = None,
                         cache=None, _full: bool = False):
    """Rank-parallel chunk pipelines over a RankGrid (DESIGN.md §10).

    Every request is split into ``n_ranks * n_chunks`` equal chunks sized
    for one rank's banks; rank r owns the r-th contiguous block and streams
    it through its own double-buffered pipeline on its own streams (thread
    per rank).  Per-bank work matches the flat pipeline at the same
    ``n_chunks`` — a rank's chunk spans ``banks_per_rank`` banks instead of
    all of them — while transfers and compute for different ranks overlap,
    modeling the paper's ~×ranks rank-parallel CPU↔DPU bandwidth.

    Degenerates to :func:`run_pipelined_many` on the flat view when one
    rank is in play, so ``ranks=1`` sessions behave exactly as before.  A
    :class:`~repro_torch.runtime.autotune.TunedPlan` overrides both ``n_chunks``
    and (when tuned with a rank dimension) ``n_ranks``.
    """
    n_ranks = _resolve_ranks(grid, n_ranks, plan)
    n_chunks, use_cache = _effective_chunks(workload, n_chunks, plan, cache)
    if n_ranks <= 1:
        return run_pipelined_many(grid, workload, requests,
                                  n_chunks=n_chunks, plan=plan,
                                  records=records, cache=cache, _full=_full)
    if records is not None and plan is not None:
        stage_pred = dict(getattr(plan, "predicted_stage_s", {}) or {})
        for rec in records:
            rec.tuned = True
            rec.predicted_overlap = plan.predicted_overlap
            if stage_pred:
                rec.predicted_stage_s = dict(stage_pred)

    rep = grid.rank_view(0)          # all views share the per-rank geometry
    n_req = len(requests)
    # every rank splits with its *own* view: split is deterministic host
    # work (identical chunks), but several workloads broadcast per-request
    # constants to the banks at split time (GEMV's x, BS's array, ...) —
    # each rank needs those constants on its own banks
    metas = [[None] * n_req for _ in range(n_ranks)]
    entries: list = [None] * n_req
    streams: list[list] = [[] for _ in range(n_ranks)]
    bucket = [[_Buckets() for _ in range(n_req)] for _ in range(n_ranks)]
    t_first = [[0.0] * n_req for _ in range(n_ranks)]
    t_retired = [[0.0] * n_req for _ in range(n_ranks)]
    tr0 = get_tracer()

    t0 = time.perf_counter()
    total = n_ranks * n_chunks
    results: list = [None] * n_req
    rank_parts: list = [None] * n_ranks
    errors: list = [None] * n_ranks

    tr = get_tracer()

    def worker(r):
        try:
            # one trace track per rank pipeline (rank 0 runs on the caller's
            # thread, so the thread name alone cannot identify its track)
            with tr.track(f"rank-{r}"):
                rank_parts[r] = _rank_worker(grid.rank_view(r), workload,
                                             metas[r], streams[r], bucket[r],
                                             t_first[r], t_retired[r],
                                             entries=entries,
                                             requests=requests,
                                             split_total=total)
        except BaseException as e:           # noqa: BLE001 — re-raised below
            errors[r] = e

    try:
        for i, args in enumerate(requests):
            per = n_chunks
            ts = time.perf_counter()
            ent, hit = (cache.acquire(workload, args,
                                      (grid.n_banks, n_ranks, total))
                        if use_cache else (None, False))
            entries[i] = ent
            for r in range(n_ranks):
                metas[r][i], chunks = _split_with_cache(
                    grid.rank_view(r), workload, args, total, ent, rank=r,
                    hit=hit)
                per = -(-len(chunks) // n_ranks)  # contiguous rank blocks
                streams[r].extend(
                    (i, g, chunks[g])
                    for g in range(r * per,
                                   min((r + 1) * per, len(chunks))))
            if (ent is not None and hit and not ent.chunk_resident
                    and tr0.enabled):
                # meta-resident hit: the skipped per-rank broadcasts happened
                # at split time, so the cached span lands here (host track)
                tr0.emit("scatter:cached", "cpu_dpu", ts,
                         time.perf_counter(), track="host",
                         workload=workload.name, req=_req_id(records, i),
                         bytes=ent.nbytes, fingerprint=ent.fingerprint)
            if records is not None:
                # n_chunks is the per-pipeline depth (matches the flat path
                # and the plan's value); total chunks = n_chunks * n_ranks
                records[i].n_chunks = per
                records[i].n_ranks = n_ranks
                records[i].cache_hit = hit
                if (hit and plan is not None
                        and getattr(plan, "warm_predicted_overlap", 0.0)):
                    records[i].predicted_overlap = plan.warm_predicted_overlap

        threads = [threading.Thread(target=worker, args=(r,),
                                    name=f"pim-rank-{r}", daemon=True)
                   for r in range(1, n_ranks)]
        for t in threads:
            t.start()
        worker(0)                            # rank 0 runs on this thread
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
    finally:
        # retire every acquire() lease — including on error paths, or the
        # entries would be unevictable forever
        if use_cache:
            for ent in entries:
                cache.release(ent)

    makespans = [0.0] * n_req
    phases = []
    for i in range(n_req):
        parts = sorted(p for ps in rank_parts for p in ps.get(i, ()))
        ts = time.perf_counter()
        results[i] = workload.merge(rep, metas[0][i], [p for _, p in parts])
        t_merged = time.perf_counter()
        merge_dt = t_merged - ts
        if tr.enabled:
            tr.emit("merge", "inter_dpu", ts, t_merged, track="host",
                    workload=workload.name, req=_req_id(records, i),
                    ranks=n_ranks)
        times = _phases()
        for r in range(n_ranks):                 # host-observed, summed over
            for k in dataclasses.fields(times):  # the rank threads
                setattr(times, k.name, getattr(times, k.name)
                        + getattr(bucket[r][i].times, k.name))
        times.inter_dpu += merge_dt
        phases.append(times)
        started = [t_first[r][i] for r in range(n_ranks) if t_first[r][i]]
        t_start = min(started) if started else t0
        # a request completes when its last chunk retires on the slowest
        # rank, plus its merge; merges themselves are deferred to the join,
        # so stamping merge wall time here would bill early requests in a
        # batch for the whole stream's tail (the flat path merges eagerly)
        retired = max(t_retired[r][i] for r in range(n_ranks))
        t_done = (retired or time.perf_counter()) + merge_dt
        makespans[i] = t_done - t_start
        if records is not None:
            records[i].t_start = t_start
            records[i].t_finish = t_done
            records[i].phases = times
    if _full:
        return results, makespans, phases
    return results
