"""Characterization-driven autotuner (DESIGN.md §8) — the PyTorch
counterpart of ``repro.runtime.autotune``.

Closes the paper's loop: §3 microbenchmarks measure the machine, Eqs. 1-4
model it — and here the *measured* analogues of those model parameters pick
the pipeline chunk count and scheduler batch size instead of the hand-picked
constants the runtime ships with.

Model.  Each pipeline stage's time for a chunk of ``b`` payload bytes is
affine (the shape of the paper's Eq. 3, fitted with the same least squares):

    t_stage(b) = alpha_stage + b / bw_stage

with stages push (CPU→bank scatter), compute (bank-local phase), and pull
(bank→CPU retrieve).  ``alpha`` is the per-dispatch fixed cost, ``bw`` the
asymptotic bandwidth/throughput.  For ``C`` chunks of a ``B``-byte request
the three-stage software pipeline (runtime/pipeline.py) has makespan

    T(C) = t_push + t_comp + t_pull + (C - 1) * max(t_push, t_comp, t_pull)

evaluated at b = B/C: the endpoints fill/drain the pipeline once, and every
further chunk costs one bottleneck-stage slot.  Small C wastes overlap (the
serialized endpoints dominate, T(1) *is* the serialized baseline's shape);
large C pays C * alpha in dispatch overhead.  ``plan_for`` minimizes T over
a candidate set — no closed form needed, the set is tiny.

Batch size.  Batching same-workload requests streams their chunks through
one pipeline, paying the fill/drain cost once per *batch* instead of once
per request.  The planner picks the smallest batch that keeps that overhead
under ``FILL_OVERHEAD_TARGET`` of the steady-state time — bigger batches buy
nothing but queue latency.

Calibration is two layers, both on the grid's device:

* machine level — ``core.characterize.push_pull_sweep`` /
  ``bank_compute_sweep`` give (nbytes, seconds) points per stage;
  ``core.perfmodel.fit_affine`` recovers (alpha, bw).  These are the
  device's Fig. 4/10 analogues.
* workload level — each entry's *chunked* phase callables are timed at
  two chunk counts as the pipeline runs them: the scatter through the
  grid's pinned staging on its ``h2d`` stream, the compute on its
  ``compute`` stream, the retrieve after the outputs' copy into pinned
  memory on its ``d2h`` stream, each boundary waiting on its stage's
  event (on a CPU grid, the plain sequence).  That gives an exact
  per-stage affine fit in the warm regime the pipeline runs in; the
  serialized ``pim()`` total (second run — the first pays one-off costs)
  is kept as the measured baseline, so the plan's predicted overlap and
  telemetry's achieved ``overlap_speedup`` are the same quantity.

The model proposes; measurement disposes: ``probe_plan`` re-measures the top
model candidates (always including the untuned default) and adopts the
measured-best chunk count — the ATLAS/AutoTVM discipline, and what makes
"tuned beats or ties the fixed default" hold by construction.
``runtime/telemetry.py`` records predicted-vs-achieved overlap per request
so mispredictions stay visible.

Rank dimension (DESIGN.md §10).  On a :class:`~repro_torch.core.banked.RankGrid`
every plan additionally carries ``n_ranks`` — how many ranks the pipeline
shards each request across.  ``core.characterize.rank_parallel_sweep``
measures how far CPU↔bank transfers actually scale with concurrently-
addressed ranks (the paper's ~×ranks rank-parallel bandwidth); the
candidate rank counts (all divisors, 1 = flat pipeline included) are then
settled end-to-end by ``probe_ranks``, same discipline as the chunk count.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Callable, Mapping, Sequence

import numpy as np

from repro_torch.core import characterize as ch
from repro_torch.core.banked import BankGrid
from repro_torch.core.perfmodel import fit_affine
from repro_torch.core.streams import NO_STREAMS
from repro_torch.core.transfer import tree_nbytes

if TYPE_CHECKING:  # annotation-only: importing repro_torch.prim pulls the suite
    from repro_torch.prim.registry import WorkloadEntry

#: The hand-picked constant this module replaces (runtime default).
DEFAULT_N_CHUNKS = 4

#: Chunk counts the planner considers (1 must stay in: T(1) is the
#: serialized-shape baseline the predicted overlap is quoted against).
CHUNK_CANDIDATES = (1, 2, 3, 4, 6, 8, 12, 16)
MAX_BATCH_REQUESTS = 16
#: Max fraction of a batch's steady-state time the pipeline fill/drain may
#: cost before the planner grows the batch.
FILL_OVERHEAD_TARGET = 0.10

_EPS_S = 1e-9          # floor for measured stage seconds (clock granularity)
_MIN_BW = 1.0          # bytes/s floor so a degenerate fit never divides by 0

#: Probe-free pre-filter head-room (DESIGN.md §15): a probe candidate is
#: dropped when the instruction-level cost model predicts it more than this
#: fraction slower than the model's best candidate.  The untuned default
#: always survives — the tuned>=fixed invariant needs it measured.
PREFILTER_SLACK = 0.25


# -- fitted pieces -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageFit:
    """One pipeline stage's affine time model, t(b) = alpha_s + b/bytes_per_s."""

    alpha_s: float
    bytes_per_s: float

    def time(self, nbytes: float) -> float:
        return self.alpha_s + nbytes / self.bytes_per_s

    def as_dict(self) -> dict:
        return {"alpha_s": self.alpha_s, "bytes_per_s": self.bytes_per_s}

    @classmethod
    def from_dict(cls, d: Mapping) -> "StageFit":
        return cls(float(d["alpha_s"]), float(d["bytes_per_s"]))

    @classmethod
    def from_points(cls, nbytes: Sequence[float],
                    seconds: Sequence[float]) -> "StageFit":
        """Affine least squares with noise guards: alpha clamps to >= 0 and
        the slope to > 0 (a flat/negative slope means the sweep never left
        the fixed-cost regime — treat the bandwidth as effectively infinite
        rather than negative)."""
        alpha, beta = fit_affine(list(nbytes), list(seconds))
        if beta <= 0:
            return cls(max(alpha, min(seconds)), 1e18)
        return cls(max(alpha, 0.0), max(1.0 / beta, _MIN_BW))


STAGES = ("push", "compute", "pull")


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Per-workload effective stage models at the calibration point."""

    workload: str
    bytes_in: int          # scatter + compute payload
    bytes_out: int         # retrieve payload
    push: StageFit
    compute: StageFit
    pull: StageFit
    serialized_s: float = 0.0   # measured pim() baseline at this point

    def stage_times(self, n_chunks: int) -> tuple[float, float, float]:
        b_in = self.bytes_in / n_chunks
        b_out = self.bytes_out / n_chunks
        return (self.push.time(b_in), self.compute.time(b_in),
                self.pull.time(b_out))

    def pipeline_time(self, n_chunks: int) -> float:
        """Three-stage pipeline makespan for C equal chunks (module docstring)."""
        t_push, t_comp, t_pull = self.stage_times(n_chunks)
        return (t_push + t_comp + t_pull
                + (n_chunks - 1) * max(t_push, t_comp, t_pull))

    def warm_pipeline_time(self, n_chunks: int) -> float:
        """Makespan when the scatter stage is elided (DESIGN.md §12): a
        resident-cache hit serves every chunk's device buffers from the
        entry, so the pipeline degenerates to two stages —

            T_warm(C) = t_comp + t_pull + (C - 1) * max(t_comp, t_pull)

        The warm optimum can differ from the cold one (push was often the
        bottleneck stage), which is why a plan carries both solves."""
        _, t_comp, t_pull = self.stage_times(n_chunks)
        return t_comp + t_pull + (n_chunks - 1) * max(t_comp, t_pull)

    def as_dict(self) -> dict:
        return {"workload": self.workload, "bytes_in": self.bytes_in,
                "bytes_out": self.bytes_out,
                "serialized_s": self.serialized_s,
                **{s: getattr(self, s).as_dict() for s in STAGES}}

    @classmethod
    def from_dict(cls, d: Mapping) -> "WorkloadProfile":
        return cls(d["workload"], int(d["bytes_in"]), int(d["bytes_out"]),
                   *(StageFit.from_dict(d[s]) for s in STAGES),
                   serialized_s=float(d.get("serialized_s", 0.0)))


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """What the scheduler consumes: chunk count, batch size, and (on a
    RankGrid) rank count per workload, with the model's predictions kept
    alongside for telemetry comparison.

    ``n_ranks`` is the rank-count dimension (DESIGN.md §10): how many ranks
    the pipeline shards each request's chunks across.  1 = flat pipeline
    over all banks (the pre-rank behavior and the only option on a flat
    grid); ``rank_measured_s`` holds the per-candidate end-to-end
    measurements the adoption was based on.

    The ``warm_*`` fields are the second solve for resident-cache hit
    paths (DESIGN.md §12), where the scatter stage drops out of the
    makespan: ``warm_n_chunks`` is the two-stage optimum the pipeline
    adopts whenever the cache is in play (cold fills use it too, so the
    fingerprint's placement stays consistent between fill and hit);
    ``warm_n_chunks == 0`` means no warm solve (workload not
    chunk-resident, or plan predates residency)."""

    workload: str
    n_chunks: int
    max_batch_requests: int
    predicted_serialized_s: float
    predicted_pipelined_s: float
    predicted_overlap: float
    candidate_s: Mapping[int, float] = dataclasses.field(default_factory=dict)
    measured_s: Mapping[int, float] = dataclasses.field(default_factory=dict)
    n_ranks: int = 1
    rank_measured_s: Mapping[int, float] = dataclasses.field(
        default_factory=dict)
    warm_n_chunks: int = 0
    warm_predicted_pipelined_s: float = 0.0
    warm_predicted_overlap: float = 0.0
    warm_candidate_s: Mapping[int, float] = dataclasses.field(
        default_factory=dict)
    #: instruction-level cost-model predictions (DESIGN.md §15), stamped by
    #: ``autotune(cost_model=...)``: per-candidate makespan seconds (the
    #: pre-filter input) and per-stage seconds at the adopted chunk count
    #: (telemetry stamps these onto every request record for
    #: predicted-vs-measured validation).  Empty when no model was supplied.
    model_candidate_s: Mapping[int, float] = dataclasses.field(
        default_factory=dict)
    predicted_stage_s: Mapping[str, float] = dataclasses.field(
        default_factory=dict)

    def as_dict(self) -> dict:
        return {"workload": self.workload, "n_chunks": self.n_chunks,
                "max_batch_requests": self.max_batch_requests,
                "predicted_serialized_s": self.predicted_serialized_s,
                "predicted_pipelined_s": self.predicted_pipelined_s,
                "predicted_overlap": self.predicted_overlap,
                "candidate_s": {str(k): v for k, v in self.candidate_s.items()},
                "measured_s": {str(k): v for k, v in self.measured_s.items()},
                "n_ranks": self.n_ranks,
                "rank_measured_s": {str(k): v for k, v
                                    in self.rank_measured_s.items()},
                "warm_n_chunks": self.warm_n_chunks,
                "warm_predicted_pipelined_s": self.warm_predicted_pipelined_s,
                "warm_predicted_overlap": self.warm_predicted_overlap,
                "warm_candidate_s": {str(k): v for k, v
                                     in self.warm_candidate_s.items()},
                "model_candidate_s": {str(k): v for k, v
                                      in self.model_candidate_s.items()},
                "predicted_stage_s": {k: v for k, v
                                      in self.predicted_stage_s.items()}}

    @classmethod
    def from_dict(cls, d: Mapping) -> "TunedPlan":
        return cls(d["workload"], int(d["n_chunks"]),
                   int(d["max_batch_requests"]),
                   float(d["predicted_serialized_s"]),
                   float(d["predicted_pipelined_s"]),
                   float(d["predicted_overlap"]),
                   {int(k): float(v)
                    for k, v in d.get("candidate_s", {}).items()},
                   {int(k): float(v)
                    for k, v in d.get("measured_s", {}).items()},
                   int(d.get("n_ranks", 1)),
                   {int(k): float(v)
                    for k, v in d.get("rank_measured_s", {}).items()},
                   int(d.get("warm_n_chunks", 0)),
                   float(d.get("warm_predicted_pipelined_s", 0.0)),
                   float(d.get("warm_predicted_overlap", 0.0)),
                   {int(k): float(v)
                    for k, v in d.get("warm_candidate_s", {}).items()},
                   {int(k): float(v)
                    for k, v in d.get("model_candidate_s", {}).items()},
                   {str(k): float(v)
                    for k, v in d.get("predicted_stage_s", {}).items()})


@dataclasses.dataclass
class TuningResult:
    """Machine-level stage fits + per-workload profiles and plans, JSON
    round-trippable (embedded verbatim in BENCH_*.json artifacts).
    ``rank_sweep`` carries the per-rank transfer characterization rows
    (``core.characterize.rank_parallel_sweep``) on a RankGrid, [] on a
    flat grid."""

    stages: dict[str, StageFit]
    profiles: dict[str, WorkloadProfile]
    plans: dict[str, TunedPlan]
    rank_sweep: list = dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        return {"stages": {k: v.as_dict() for k, v in self.stages.items()},
                "profiles": {k: v.as_dict()
                             for k, v in self.profiles.items()},
                "plans": {k: v.as_dict() for k, v in self.plans.items()},
                "rank_sweep": list(self.rank_sweep)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "TuningResult":
        return cls({k: StageFit.from_dict(v)
                    for k, v in d.get("stages", {}).items()},
                   {k: WorkloadProfile.from_dict(v)
                    for k, v in d.get("profiles", {}).items()},
                   {k: TunedPlan.from_dict(v)
                    for k, v in d.get("plans", {}).items()},
                   list(d.get("rank_sweep", [])))


# -- calibration -------------------------------------------------------------

def calibrate(grid: BankGrid, nbytes=(1 << 18, 1 << 20, 1 << 22),
              reps: int = 5) -> dict[str, StageFit]:
    """Machine-level stage fits from the characterization sweeps."""
    xfer = ch.push_pull_sweep(grid, nbytes=nbytes, reps=reps)
    comp = ch.bank_compute_sweep(grid, nbytes=nbytes, reps=reps)
    sizes = [r["nbytes"] for r in xfer]
    return {
        "push": StageFit.from_points(sizes, [r["push_s"] for r in xfer]),
        "pull": StageFit.from_points(sizes, [r["pull_s"] for r in xfer]),
        "compute": StageFit.from_points([r["nbytes"] for r in comp],
                                        [r["compute_s"] for r in comp]),
    }


def profile_workload(grid: BankGrid, entry: "WorkloadEntry", args: tuple,
                     probe_chunks: Sequence[int] = (1, 4),
                     reps: int = 3) -> WorkloadProfile:
    """Fit this workload's per-stage affine models by timing its *chunked*
    phase callables at ``probe_chunks`` chunk counts, i.e. at two payload
    sizes per stage.  Two sizes make the affine fit exact.

    Each stage runs as the pipeline runs it (``runtime/pipeline.py``), on
    the grid's :class:`~repro_torch.core.streams.RankStreams`: the scatter
    inside ``scattering()`` (through pinned staging on the ``h2d``
    stream, not the pageable copy of a direct ``to_banks``), the compute
    inside ``computing()``, the outputs copied into pinned memory by
    ``prefetch`` before ``retrieve``; each boundary waits on its stage's
    event.  On a CPU grid (``NO_STREAMS``) that is the plain sequence.
    One warm-up pass per chunk count pays the first uses (kernel builds,
    the staging buffers' growth).  The serialized ``pim()`` total is
    measured alongside (second run; the first pays one-off costs) as the
    overlap baseline."""
    import time as _t

    w = entry.chunked
    st = grid.streams or NO_STREAMS
    entry.pim(grid, *args)
    t0 = _t.perf_counter()
    result, _ = entry.pim(grid, *args)
    serialized_s = _t.perf_counter() - t0
    bytes_in = tree_nbytes(args)
    bytes_out = tree_nbytes(result)

    def stages(meta, chunk):
        """One chunk through the three stages; the times of each."""
        t0 = _t.perf_counter()
        with st.scattering():
            bufs = w.scatter(grid, meta, chunk)
        scattered = st.scattered()
        st.wait(scattered)
        t1 = _t.perf_counter()
        with st.computing(scattered, meta, bufs):
            outs = w.compute(grid, meta, bufs)
        computed = st.computed()
        st.wait(computed)
        t2 = _t.perf_counter()
        host, copied = st.prefetch(outs, computed)
        st.wait(copied)
        w.retrieve(grid, meta, host)
        t3 = _t.perf_counter()
        return t1 - t0, t2 - t1, t3 - t2

    points: dict[str, list[tuple[float, float]]] = \
        {s: [] for s in STAGES}
    for c in sorted(set(probe_chunks)):
        meta, chunks = w.split(grid, c, *args)
        chunk = chunks[0]
        stages(meta, chunk)                      # warm-up: first uses
        push_ts, comp_ts, pull_ts = zip(*(stages(meta, chunk)
                                          for _ in range(reps)))
        points["push"].append((bytes_in / c, float(np.median(push_ts))))
        points["compute"].append((bytes_in / c, float(np.median(comp_ts))))
        points["pull"].append((bytes_out / c, float(np.median(pull_ts))))

    def fit(stage: str) -> StageFit:
        xs = [p[0] for p in points[stage]]
        ys = [p[1] for p in points[stage]]
        return StageFit.from_points(xs, ys)

    return WorkloadProfile(entry.name, bytes_in, bytes_out,
                           push=fit("push"), compute=fit("compute"),
                           pull=fit("pull"), serialized_s=serialized_s)


# -- planning ----------------------------------------------------------------

def plan_for(profile: WorkloadProfile,
             candidates: Sequence[int] = CHUNK_CANDIDATES,
             warm: bool = False) -> TunedPlan:
    """Overlap-maximizing chunk count + fill-amortizing batch size.

    ``warm=True`` additionally solves the two-stage warm model (scatter
    elided on resident-cache hits, DESIGN.md §12) over the same candidate
    set — only meaningful for chunk-resident workloads, where a hit
    actually removes the push stage from the pipeline."""
    cand = sorted(set(candidates) | {1})
    times = {c: profile.pipeline_time(c) for c in cand}
    best = min(cand, key=lambda c: (times[c], c))    # ties -> fewer chunks
    # measured pim() baseline when the profile has one; else the model's
    # serialized-shape T(1)
    serialized = profile.serialized_s or times[1]

    t_push, t_comp, t_pull = profile.stage_times(best)
    bottleneck = max(t_push, t_comp, t_pull)
    steady = best * bottleneck                       # per-request steady state
    fill = max(times[best] - steady, 0.0)            # paid once per batch
    batch = max(1, math.ceil(fill / (FILL_OVERHEAD_TARGET
                                     * max(steady, _EPS_S))))
    warm_fields: dict = {}
    if warm:
        wtimes = {c: profile.warm_pipeline_time(c) for c in cand}
        wbest = min(cand, key=lambda c: (wtimes[c], c))
        warm_fields = dict(
            warm_n_chunks=wbest,
            warm_predicted_pipelined_s=wtimes[wbest],
            warm_predicted_overlap=serialized / max(wtimes[wbest], _EPS_S),
            warm_candidate_s=wtimes)
    return TunedPlan(
        workload=profile.workload, n_chunks=best,
        max_batch_requests=min(batch, MAX_BATCH_REQUESTS),
        predicted_serialized_s=serialized,
        predicted_pipelined_s=times[best],
        predicted_overlap=serialized / max(times[best], _EPS_S),
        candidate_s=times, **warm_fields)


def probe_candidates(plan: TunedPlan, k: int = 2,
                     default: int = DEFAULT_N_CHUNKS) -> list[int]:
    """Chunk counts worth measuring: the untuned default (the baseline the
    tuned plan must beat or tie), the model's pick, and its next-best ``k-1``
    candidates — the model narrows the sweep, the probe settles it."""
    ranked = sorted(plan.candidate_s, key=lambda c: (plan.candidate_s[c], c))
    out = [default, plan.n_chunks]
    for c in ranked:
        if len(set(out)) >= k + 1:
            break
        out.append(c)
    return sorted(set(out))


def prefilter_candidates(plan: TunedPlan, k: int = 2,
                         default: int = DEFAULT_N_CHUNKS,
                         slack: float = PREFILTER_SLACK) -> list[int]:
    """Probe-free pre-filter (DESIGN.md §15): start from
    ``probe_candidates`` and drop every candidate whose cost-model
    predicted makespan (``plan.model_candidate_s``, stamped by
    ``autotune(cost_model=...)``) exceeds the model's best candidate by
    more than ``slack``.  The untuned default survives unconditionally —
    the tuned>=fixed invariant still holds by construction and the
    measured best among the survivors still wins.  With no model
    predictions on the plan this degenerates to ``probe_candidates``."""
    cand = probe_candidates(plan, k=k, default=default)
    model_s = plan.model_candidate_s
    scored = {c: model_s[c] for c in cand if c in model_s}
    if not scored:
        return cand
    best = min(scored.values())
    keep = [c for c in cand
            if c == default or model_s.get(c, best) <= best * (1.0 + slack)]
    return sorted(set(keep))


def rank_candidates(n_ranks: int) -> list[int]:
    """Rank counts worth measuring on an ``n_ranks``-rank grid: every
    divisor (1 stays in — the flat pipeline is the baseline the rank
    sharding must beat or tie)."""
    return [r for r in range(1, n_ranks + 1) if n_ranks % r == 0]


def probe_ranks(grid, entry: "WorkloadEntry", plan: TunedPlan,
                requests: Sequence[tuple],
                candidates: Sequence[int] | None = None,
                runner: Callable[[int], float] | None = None) -> TunedPlan:
    """Measure the rank-count candidates at the plan's chunk count and adopt
    the measured best (DESIGN.md §10).  ``rank_parallel_sweep`` is the model
    side — it shows how far transfers scale with ranks — but the ranks of
    one card share its SMs and copy engines, so the rank
    dimension is settled end-to-end like the chunk dimension: the flat
    pipeline (1 rank) is always in the candidate set, so the adopted plan
    beats or ties it by construction."""
    from .pipeline import run_pipelined_ranked

    n_ranks = getattr(grid, "n_ranks", 1)
    if n_ranks <= 1:
        return plan
    if runner is None:
        import time

        def runner(r: int) -> float:
            run_pipelined_ranked(grid, entry.chunked, requests,
                                 n_chunks=plan.n_chunks, n_ranks=r)
            t0 = time.perf_counter()
            run_pipelined_ranked(grid, entry.chunked, requests,
                                 n_chunks=plan.n_chunks, n_ranks=r)
            return time.perf_counter() - t0

    cand = list(candidates) if candidates is not None \
        else rank_candidates(n_ranks)
    measured = {r: runner(r) for r in cand}
    best = min(cand, key=lambda r: (measured[r], r))
    return dataclasses.replace(plan, n_ranks=best, rank_measured_s=measured)


def probe_plan(grid: BankGrid, entry: "WorkloadEntry", plan: TunedPlan,
               requests: Sequence[tuple],
               candidates: Sequence[int] | None = None,
               runner: Callable[[int], float] | None = None) -> TunedPlan:
    """Measure the candidate chunk counts and adopt the measured best.

    ``runner(n_chunks) -> seconds`` defaults to timing the chunk pipeline
    directly; benchmarks may pass a scheduler-level runner so the adopted
    plan reflects end-to-end service time.  The untuned default is always in
    the candidate set, so the adopted plan beats or ties it by construction.
    """
    from .pipeline import run_pipelined_many

    if runner is None:
        import time

        def runner(c: int) -> float:
            run_pipelined_many(grid, entry.chunked, requests, n_chunks=c)
            t0 = time.perf_counter()
            run_pipelined_many(grid, entry.chunked, requests, n_chunks=c)
            return time.perf_counter() - t0

    cand = list(candidates) if candidates is not None \
        else probe_candidates(plan)
    measured = {c: runner(c) for c in cand}
    best = min(cand, key=lambda c: (measured[c], c))
    return dataclasses.replace(plan, n_chunks=best, measured_s=measured)


# -- top level ---------------------------------------------------------------

def autotune(grid: BankGrid, entries: Sequence["WorkloadEntry"] | None = None,
             *, scale: int = 1, rng=None, reps: int = 3,
             candidates: Sequence[int] = CHUNK_CANDIDATES,
             calib_nbytes=(1 << 18, 1 << 20, 1 << 22),
             probe: bool = False, cost_model=None) -> TuningResult:
    """Calibrate the backend, profile each pipelineable workload, and solve
    for its chunk count and batch size.  ``probe=True`` additionally
    measures the top candidates and adopts the measured best.

    ``cost_model`` (a :class:`repro_torch.core.costmodel.CostModel`) turns on the
    probe-free pre-filter (DESIGN.md §15): every plan is stamped with the
    model's per-candidate makespan predictions (``model_candidate_s``) and
    the probe set shrinks to ``prefilter_candidates`` — fewer measured
    probes, the untuned default still measured, measured best still wins.
    The adopted plan also carries ``predicted_stage_s``, the model's
    per-stage seconds at the adopted chunk count, which the pipeline
    stamps onto every request record for predicted-vs-measured
    validation."""
    if entries is None:
        from repro_torch.prim.registry import REGISTRY
        entries = [e for e in REGISTRY.values() if e.pipelineable]
    rng = rng if rng is not None else np.random.default_rng(0)
    stages = calibrate(grid, nbytes=calib_nbytes, reps=reps)
    n_ranks = getattr(grid, "n_ranks", 1)
    rank_sweep = (ch.rank_parallel_sweep(grid, reps=reps)
                  if n_ranks > 1 else [])
    profiles: dict[str, WorkloadProfile] = {}
    plans: dict[str, TunedPlan] = {}
    for entry in entries:
        if not entry.pipelineable:
            continue
        args = entry.make_args(rng, scale)
        prof = profile_workload(grid, entry, args, reps=reps)
        w = entry.chunked
        # warm solve only where a hit truly elides the push stage: chunk-
        # resident workloads (meta-resident ones — BS — still scatter their
        # varying chunks; their warm win is the skipped split broadcast)
        plan = plan_for(prof, candidates,
                        warm=w.supports_residency and not w.meta_resident)
        cprof = None
        if cost_model is not None:
            cprof = entry.cost_profile(grid, args)
            model_s = cost_model.candidate_predictions(
                cprof, sorted(set(candidates) | {1}))
            plan = dataclasses.replace(plan, model_candidate_s=model_s)
        if probe:
            probe_cand = (prefilter_candidates(plan)
                          if cost_model is not None else None)
            plan = probe_plan(grid, entry, plan, [args],
                              candidates=probe_cand)
            if n_ranks > 1:
                # the rank dimension (DESIGN.md §10) is settled by
                # measurement — divisor sets are tiny and the flat
                # pipeline (1 rank) stays in as the must-beat baseline.
                # Without probing, plans stay rank-agnostic and execution
                # defers to the grid's rank count (_resolve_ranks).
                plan = probe_ranks(grid, entry, plan, [args])
        if cprof is not None:
            # per-stage predictions at the *adopted* chunk count (the probe
            # may have moved it) — telemetry stamps these on every record
            pred = cost_model.predict(cprof, n_chunks=plan.n_chunks)
            plan = dataclasses.replace(
                plan, predicted_stage_s=dict(pred.stage_s))
        profiles[entry.name] = prof
        plans[entry.name] = plan
    return TuningResult(stages=stages, profiles=profiles, plans=plans,
                        rank_sweep=rank_sweep)
