"""Straggler/health monitoring — shared by the training loop and the
serving tier.

The signal is the *step-time distribution*, not per-device timing: the
monitor keeps a rolling median and flags steps that exceed ``threshold ×``
median, with a policy callback to escalate.  Two consumers:

* **training** — SPMD steps are lockstep, so a straggling host slows every
  step; escalation is log → early checkpoint → request re-carve
  (``runtime/elastic.carve_mesh``).
* **serving (DESIGN.md §13)** — the multi-tenant scheduler wraps each
  dispatched batch in a per-workload :class:`StepMonitor`; a flagged batch
  trips :meth:`~repro_torch.runtime.elastic.RankAllocator.on_straggle`, shrinking
  the rank slice the next batches fan out over until healthy batches relax
  it back (straggler-aware re-dispatch).

Also includes a watchdog that detects a *hung* step (no completion within a
deadline) — the failure mode where one host loses its accelerator and the
collective never completes.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable


@dataclasses.dataclass
class StragglerConfig:
    window: int = 32
    threshold: float = 2.0          # × rolling median ⇒ straggler
    hang_deadline_s: float = 600.0  # no step completion ⇒ hung


class StepMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig(),
                 on_straggle: Callable[[int, float, float], None] | None = None):
        self.cfg = cfg
        self.times: deque[float] = deque(maxlen=cfg.window)
        self.on_straggle = on_straggle
        self.flagged: list[tuple[int, float]] = []
        self._t0: float | None = None

    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        med = self.median()
        if med is not None and dt > self.cfg.threshold * med:
            self.flagged.append((step, dt))
            if self.on_straggle:
                self.on_straggle(step, dt, med)
        self.times.append(dt)
        return dt

    def median(self) -> float | None:
        if len(self.times) < 4:
            return None
        s = sorted(self.times)
        return s[len(s) // 2]


class Watchdog:
    """Fires ``on_hang`` if no heartbeat arrives within the deadline."""

    def __init__(self, deadline_s: float, on_hang: Callable[[], None]):
        self.deadline = deadline_s
        self.on_hang = on_hang
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def beat(self) -> None:
        self._last = time.monotonic()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(min(self.deadline / 4, 5.0)):
            if time.monotonic() - self._last > self.deadline:
                self.on_hang()
                self._last = time.monotonic()
