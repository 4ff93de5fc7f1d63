"""repro_torch.runtime — the pipelined PIM-serving runtime on one GPU
(internal layer), the PyTorch counterpart of ``repro.runtime``.

The chunk pipeline (its three stages on CUDA streams), the multi-tenant
scheduler and its QoS surface, the resident-operand cache, telemetry,
metrics and the span tracer, the characterization-driven autotuner,
``elastic`` (the serving side's rank allocator, and the train side's mesh
carve, specs to placements, reshard and failure hook over
``torch.distributed``), and ``straggler`` (whose monitor the training loop
takes too).  Prefer ``repro_torch.pim`` as the entry point.
"""
from .autotune import (DEFAULT_N_CHUNKS, StageFit, TunedPlan, TuningResult,
                       WorkloadProfile, autotune, calibrate, plan_for,
                       probe_plan, probe_ranks, rank_candidates)
from .elastic import (RankAllocator, carve_mesh, reshard, shardings_for,
                      simulate_failure)
from .metrics import Histogram, Metrics, merge_snapshots
from .pipeline import (PipelineResult, run_pipelined, run_pipelined_many,
                       run_pipelined_ranked)
from .qos import (DEFAULT_TENANT, DeadlineExpired, QueueFull, RequestOptions,
                  resolve_options)
from .resident import (ResidentCache, ResidentEntry, ResidentHandle,
                       content_digest, fingerprint, unwrap_handles)
from .scheduler import PimRequest, PimScheduler
from .straggler import StepMonitor, StragglerConfig, Watchdog
from .telemetry import RequestRecord, Telemetry
from .trace import NULL_TRACER, Span, Tracer, get_tracer, set_tracer

__all__ = ["PipelineResult", "run_pipelined", "run_pipelined_many",
           "run_pipelined_ranked",
           "PimRequest", "PimScheduler", "RequestRecord", "Telemetry",
           "DEFAULT_TENANT", "DeadlineExpired", "QueueFull",
           "RequestOptions", "resolve_options",
           "RankAllocator", "carve_mesh", "reshard", "shardings_for",
           "simulate_failure",
           "StepMonitor", "StragglerConfig", "Watchdog",
           "ResidentCache", "ResidentEntry", "ResidentHandle",
           "content_digest", "fingerprint", "unwrap_handles",
           "Histogram", "Metrics", "merge_snapshots",
           "NULL_TRACER", "Span", "Tracer", "get_tracer", "set_tracer",
           "DEFAULT_N_CHUNKS", "StageFit", "TunedPlan", "TuningResult",
           "WorkloadProfile", "autotune", "calibrate", "plan_for",
           "probe_plan", "probe_ranks", "rank_candidates"]
