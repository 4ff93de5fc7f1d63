"""Autotuner plan types (DESIGN.md §8) — the ported part of
``repro.runtime.autotune``: the plain dataclasses a session's ``plans=``
takes (:class:`TunedPlan`, :class:`TuningResult` with its
:class:`StageFit` / :class:`WorkloadProfile` pieces) and the untuned
default chunk count.  Copied from the reference; every plan round-trips
through ``as_dict`` / ``from_dict`` as there.

The calibration itself (``autotune()``, ``calibrate``, ``profile_workload``,
the probes) needs ``core/characterize.py`` and is not ported yet (ROADMAP
queue 1, item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.core.perfmodel import fit_affine

#: The hand-picked constant the autotuner replaces (runtime default).
DEFAULT_N_CHUNKS = 4

_MIN_BW = 1.0          # bytes/s floor so a degenerate fit never divides by 0


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
