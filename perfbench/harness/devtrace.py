"""The device's timeline over a slice of the window, from ``torch.profiler``.

The profiler's Chrome trace holds every kernel, copy and fill that ran on
the card (categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``), each
with its device start and length in microseconds on the profiler's clock.
Two marks, ``record_function`` spans opened at known ``perf_counter``
times, put that clock onto the host's, so the device's idle gaps can be
set beside the program's own host spans (``runtime/trace.py``)."""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "bench.mark."
#: the program's spans that cover other spans (a request's whole life, a
#: session call): an idle gap is named by the innermost work instead
ENVELOPES = ("serve", "queue_wait", "drain")


@dataclasses.dataclass
class Op:
    name: str
    cat: str
    t0: float            # host perf_counter seconds
    t1: float
    nbytes: int = 0


def union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


@dataclasses.dataclass
class DeviceTrace:
    lo: float
    hi: float
    ops: list

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        return length((o.t0, o.t1) for o in self.ops)

    def kernel_s(self) -> float:
        """Seconds in which a kernel ran (copies and fills left out)."""
        return length((o.t0, o.t1) for o in self.ops if o.cat == "kernel")

    def copies(self, kind: str) -> list:
        return [o for o in self.ops
                if o.cat == "gpu_memcpy" and kind in o.name]

    def gaps(self) -> list[tuple[float, float]]:
        out, t = [], self.lo
        for a, b in union((o.t0, o.t1) for o in self.ops):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.hi > t:
            out.append((t, self.hi))
        return out

    def top_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for o in self.ops:
            by[o.name[:160]] += o.t1 - o.t0
        return [[k, v] for k, v in by.most_common(n)]

    def idle_by_host(self, spans, n: int = 10) -> list:
        """Idle seconds of the device by what the host was doing: each gap
        goes to the program span (envelopes left out) that overlaps it
        most, or to "no program span"."""
        gaps = self.gaps()
        points = []
        for g, (a, b) in enumerate(gaps):
            points += [(a, 1, "gap", g), (b, 0, "gap", g)]
        for sp in spans:
            if sp.name in ENVELOPES or sp.t1 <= self.lo or sp.t0 >= self.hi:
                continue
            points += [(sp.t0, 1, "span", sp.name), (sp.t1, 0, "span",
                                                      sp.name)]
        points.sort(key=lambda p: (p[0], p[1]))
        active, gap, last = collections.Counter(), None, None
        overlap = [collections.Counter() for _ in gaps]
        for t, opening, kind, key in points:
            if gap is not None and last is not None and t > last:
                for name in active:
                    overlap[gap][name] += t - last
            last = t
            if kind == "gap":
                gap = key if opening else None
            elif opening:
                active[key] += 1
            else:
                active[key] -= 1
                if active[key] <= 0:
                    del active[key]
        by = collections.Counter()
        for (a, b), seen in zip(gaps, overlap):
            name = seen.most_common(1)[0][0] if seen else "no program span"
            by[name] += b - a
        return [[k, v] for k, v in by.most_common(n)]


def parse(events: list, marks: dict) -> DeviceTrace:
    """The device operations of a Chrome trace's ``events`` between the
    first and the last of ``marks`` (mark name -> perf_counter seconds)."""
    ts = {e["name"]: e["ts"] for e in events
          if e.get("ph") == "X" and e.get("name") in marks}
    if len(ts) != len(marks):
        raise RuntimeError(f"profiler trace lacks marks "
                           f"{sorted(set(marks) - set(ts))}")
    offsets = [ts[m] / 1e6 - marks[m] for m in marks]
    off = offsets[0]
    if max(offsets) - min(offsets) > 1e-2:
        raise RuntimeError(f"the profiler's clock drifts from the host's "
                           f"by {max(offsets) - min(offsets):.6f} s")
    lo, hi = min(marks.values()), max(marks.values())
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t0 = e["ts"] / 1e6 - off
        t1 = t0 + e.get("dur", 0) / 1e6
        if t1 <= lo or t0 >= hi:
            continue
        ops.append(Op(e["name"], e["cat"], max(t0, lo), min(t1, hi),
                      int((e.get("args") or {}).get("bytes", 0))))
    return DeviceTrace(lo, hi, ops)


class Slice:
    """``torch.profiler`` over [start(), stop()) of the window; opened
    and closed by one thread while the clients run on others."""

    def __init__(self, warm: bool = False):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        if warm:
            with profile(activities=acts):
                pass
        self._prof = profile(activities=acts)
        self._marks: dict[str, float] = {}

    def _mark(self) -> None:
        import torch
        name = f"{MARK}{len(self._marks)}"
        with torch.profiler.record_function(name):
            self._marks[name] = time.perf_counter()

    def start(self) -> float:
        """Open the slice; returns its first mark's time."""
        self._prof.__enter__()
        self._mark()
        return self._marks[f"{MARK}0"]

    def stop(self) -> DeviceTrace:
        self._mark()
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return parse(events, self._marks)
