"""Low-overhead span tracer for the pipelined PIM runtime (DESIGN.md §11).

The paper's core contribution is *measurement* — stacked CPU-DPU / DPU /
Inter-DPU / DPU-CPU phase bars — but host-observed per-request sums
(``runtime/telemetry.py``) cannot show *where inside* a pipelined,
rank-sharded request time goes.  This module records **spans**: named,
categorized ``[t0, t1)`` intervals tagged with request / workload / rank /
chunk / bytes, grouped onto **tracks** (one per rank pipeline, plus host /
scheduler / session), and exports them as Chrome ``trace_event`` JSON that
loads directly in `ui.perfetto.dev <https://ui.perfetto.dev>`_ or
``chrome://tracing``.

Design constraints (the follow-up tooling argument of arXiv:2110.01709 /
arXiv:2205.14647 — adoption hinges on profiling built *into* the runtime):

* **off by default, near-zero disabled overhead** — the module-level active
  tracer is a :data:`NULL_TRACER` whose ``span()`` returns one shared no-op
  context manager (no allocation) and whose ``emit()`` is a single
  attribute-check away from a no-op.  Hot paths guard with
  ``if tr.enabled:`` so tag dicts are never even built when tracing is off;
* **bounded memory** — spans land in a ring buffer (``max_spans``), so a
  long-serving session cannot leak; the drop count is reported in the
  export's metadata;
* **thread-correct** — rank pipelines run one thread per rank
  (``runtime/pipeline.py``); each appends spans tagged with its own track
  (``rank-0`` … ``rank-R-1``), and CPython's GIL makes the deque append
  safe.  A thread-local track override (:meth:`Tracer.track`) covers rank
  0, which runs on the caller's thread.

The session façade owns the lifecycle: ``pim.session(trace=True)`` (or the
``REPRO_TRACE=path`` env hook — zero code changes for examples/benchmarks)
installs a :class:`Tracer` as the active one, and
``session.trace_export(path)`` / close-time auto-export write the JSON.
``tools/trace_view.py`` renders top-N slowest spans and the per-stage
critical-path / overlap-efficiency summary from the same file.

Residency spans (DESIGN.md §12): a chunk served from the resident-operand
cache emits ``scatter:cached`` (category ``cpu_dpu``, tagged with the
entry's ``fingerprint`` and the bytes the skipped push would have moved)
in place of the ``scatter`` span, so warm traffic is visually distinct on
every pipeline track and ``tools/trace_view.py`` can report the cached-
scatter savings.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import threading
import time
from typing import Mapping

#: span categories, matching the paper's phase naming (telemetry docstring)
CATEGORIES = ("cpu_dpu", "dpu", "dpu_cpu", "inter_dpu",
              "transfer", "queue", "sched", "session")

#: default ring-buffer capacity (spans, not bytes); a span is ~200 B, so the
#: default bounds tracer memory at ~50 MB worst case
DEFAULT_MAX_SPANS = 1 << 18


@dataclasses.dataclass
class Span:
    """One named, categorized ``[t0, t1)`` interval on a track."""

    name: str
    cat: str
    t0: float           # time.perf_counter() seconds
    t1: float
    track: str
    args: Mapping | None = None

    @property
    def dur(self) -> float:
        return max(0.0, self.t1 - self.t0)


class _NullSpan:
    """The shared no-op context manager the disabled fast path returns —
    one module-level instance, so ``tracer.span(...)`` allocates nothing
    when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every operation is a no-op.  ``enabled`` is False so
    hot paths can skip building tag dicts entirely."""

    __slots__ = ()
    enabled = False

    def span(self, name, cat="", track=None, **args):
        return NULL_SPAN

    def emit(self, name, cat, t0, t1, track=None, **args) -> None:
        pass

    def track(self, name):
        return NULL_SPAN

    def __len__(self) -> int:
        return 0


NULL_TRACER = NullTracer()


class _SpanCtx:
    """Context manager recording one span on ``__exit__``."""

    __slots__ = ("_tracer", "_name", "_cat", "_track", "_args", "_t0")

    def __init__(self, tracer, name, cat, track, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.emit(self._name, self._cat, self._t0,
                          time.perf_counter(), track=self._track,
                          **(self._args or {}))
        return False


class Tracer:
    """Span collector with a bounded ring buffer and Perfetto JSON export.

    Tracks: an explicit ``track=`` on ``span()``/``emit()`` wins, else the
    thread-local override set by :meth:`track`, else the current thread's
    name mapped through :data:`_THREAD_TRACKS` (``MainThread`` → ``host``,
    the scheduler worker and rank threads keep their ``pim-*`` names minus
    the prefix).
    """

    _THREAD_TRACKS = {"MainThread": "host", "pim-scheduler": "scheduler"}

    enabled = True

    def __init__(self, max_spans: int = DEFAULT_MAX_SPANS):
        self.spans: collections.deque[Span] = collections.deque(
            maxlen=max_spans)
        self.dropped = 0            # spans evicted by the ring buffer
        self.t_origin = time.perf_counter()
        self._local = threading.local()

    # -- recording -----------------------------------------------------------

    def _resolve_track(self, track: str | None) -> str:
        if track is not None:
            return track
        override = getattr(self._local, "track", None)
        if override is not None:
            return override
        name = threading.current_thread().name
        mapped = self._THREAD_TRACKS.get(name)
        if mapped is not None:
            return mapped
        if name.startswith("pim-"):
            return name[4:]
        return name

    def span(self, name: str, cat: str = "", track: str | None = None,
             **args) -> _SpanCtx:
        """Context manager: ``with tracer.span("merge", cat="inter_dpu",
        workload="VA"): ...`` records the wrapped interval."""
        return _SpanCtx(self, name, cat, track, args or None)

    def emit(self, name: str, cat: str, t0: float, t1: float,
             track: str | None = None, **args) -> None:
        """Record an interval measured elsewhere — the hot-path form: the
        pipeline already takes the timestamps for its phase buckets, so
        tracing rides them instead of timing twice."""
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        self.spans.append(Span(name, cat, t0, t1,
                               self._resolve_track(track), args or None))

    def track(self, name: str):
        """Thread-local track override (rank 0's pipeline runs on the
        caller's thread, so the thread name alone cannot identify it)."""
        tracer = self

        class _TrackCtx:
            __slots__ = ("_prev",)

            def __enter__(self_inner):
                self_inner._prev = getattr(tracer._local, "track", None)
                tracer._local.track = name
                return self_inner

            def __exit__(self_inner, *exc):
                tracer._local.track = self_inner._prev
                return False

        return _TrackCtx()

    def __len__(self) -> int:
        return len(self.spans)

    # -- export --------------------------------------------------------------

    def _track_order(self) -> list[str]:
        """Deterministic track → tid layout: host, scheduler, session first,
        then rank-* numerically, then tenant-* lanes (one per tenant,
        DESIGN.md §13), then anything else alphabetically."""
        seen = {s.track for s in self.spans}
        head = [t for t in ("host", "scheduler", "session") if t in seen]
        ranks = sorted((t for t in seen if t.startswith("rank-")),
                       key=lambda t: (len(t), t))
        tenants = sorted(t for t in seen if t.startswith("tenant-"))
        rest = sorted(seen - set(head) - set(ranks) - set(tenants))
        return head + ranks + tenants + rest

    def to_events(self) -> list[dict]:
        """Chrome ``trace_event`` list: thread-name metadata per track plus
        one complete ("X") event per span, timestamps in µs relative to the
        tracer's origin."""
        tids = {t: i + 1 for i, t in enumerate(self._track_order())}
        events = [{"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                   "args": {"name": track}}
                  for track, tid in tids.items()]
        events.append({"ph": "M", "pid": 1, "tid": 0,
                       "name": "process_name",
                       "args": {"name": "repro_torch.pim session"}})
        for s in self.spans:
            ev = {"ph": "X", "pid": 1, "tid": tids[s.track],
                  "ts": (s.t0 - self.t_origin) * 1e6,
                  "dur": s.dur * 1e6,
                  "name": s.name, "cat": s.cat or "span"}
            if s.args:
                ev["args"] = dict(s.args)
            events.append(ev)
        return events

    def to_json(self) -> dict:
        return {"traceEvents": self.to_events(),
                "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.runtime.trace",
                              "spans": len(self.spans),
                              "dropped_spans": self.dropped}}

    def export(self, path) -> pathlib.Path:
        """Write the Perfetto-loadable trace JSON to ``path``."""
        path = pathlib.Path(path)
        path.write_text(json.dumps(self.to_json()) + "\n")
        return path


# -- module-level active tracer ----------------------------------------------
#
# The runtime's hot paths (core/transfer.py, runtime/pipeline.py,
# runtime/scheduler.py) fetch the active tracer through get_tracer() — a
# plain module global, read without locking (rebinding is atomic under the
# GIL).  The session façade installs/uninstalls it; one traced session at a
# time is the supported shape (last install wins, uninstall restores the
# previous tracer).

_ACTIVE: Tracer | NullTracer = NULL_TRACER


def get_tracer() -> Tracer | NullTracer:
    """The active tracer (the shared :data:`NULL_TRACER` when disabled)."""
    return _ACTIVE


def set_tracer(tracer: Tracer | NullTracer) -> Tracer | NullTracer:
    """Install ``tracer`` as the active one; returns the previous tracer so
    callers can restore it (the session façade does on close)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    return prev
