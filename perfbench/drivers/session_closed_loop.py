"""Closed-loop clients on ``repro_torch.pim.session``.

Set-up opens one session in serving mode on the configuration's layout,
makes the traffic's seeded inputs, pins the operands the traffic names
and warms every request shape up.  In the window, ``clients`` threads each
``submit`` a request and wait on its ``result()`` before sending the next:
callers that wait for their reply.  Client ``c``'s ``k``-th request is
workload ``mix[(c + k) % len(mix)]`` over pool input ``j`` (``schedule``),
the same sequence for every seed; the seed changes only the data."""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time

import numpy as np
import torch

from harness import devtrace, spec

#: a request still unanswered this long after the window closed never comes
LATE_S = 60.0


@dataclasses.dataclass
class Answer:
    client: int
    workload: str
    j: int
    t_sub: float
    t_done: float
    work: int
    ok: bool
    error: str = ""
    # the program's record of the request (None where there is none)
    queue_wait: float | None = None
    cache_hit: bool | None = None
    t_start: float | None = None
    t_finish: float | None = None


class Session:
    """The program under test: one ``pim.session`` in serving mode."""

    def __init__(self, config: dict, trace: bool, device, pools: dict):
        from repro_torch import pim
        self.s = pim.session(**config["layout"], trace=trace, device=device)
        self.s.start()
        self.handles: dict[str, dict] = {}

    def pin(self, name: str, args: tuple, positions: tuple) -> None:
        """Pin ``name``'s operands at ``positions``.  They go in as
        ``ResidentHandle``s, digested once: every request then passes the
        same handles, as a caller who keeps the operand unchanged does."""
        from repro_torch.runtime.resident import ResidentHandle
        self.handles[name] = {p: ResidentHandle(args[p]) for p in positions}
        self.s.pin(name, *self._with_handles(name, args))

    def _with_handles(self, name: str, args: tuple) -> tuple:
        held = self.handles.get(name)
        if not held:
            return args
        return tuple(held.get(p, a) for p, a in enumerate(args))

    def call(self, name: str, j: int, args: tuple):
        return self.s.submit(name, *self._with_handles(name, args))

    def spans(self) -> list:
        tr = self.s.tracer
        return list(tr.spans) if tr is not None else []

    def close(self) -> None:
        self.s.close()


def schedule(mix: list, sizes: dict, clients: int, c: int,
             k: int) -> tuple[str, int]:
    name = mix[(c + k) % len(mix)]
    size = sizes[name]
    return name, (k // len(mix) + c * max(1, size // clients)) % size


@dataclasses.dataclass
class Window:
    t0: float
    t_end: float
    answers: list
    kept: dict               # workload -> [Kept]
    pools: dict
    spans: list              # the program's spans, of the traced slice
                             # where there is one
    device_trace: devtrace.DeviceTrace | None
    memory_peak_bytes: int
    cpu_s: float             # this process's CPU seconds in the window


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, open_program=Session) -> Window:
    """Set up, run the window, free the program; the pools stay for the
    comparison."""
    t_setup = time.perf_counter()
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    mix, clients = traffic["mix"], int(traffic["clients"])
    pools = {}
    for name in dict.fromkeys(mix):
        pools[name] = spec.workload_module(name).make(
            config[name], int(traffic["pool"][name]), gen, dev,
            rng, int(traffic["positions_per_answer"]))
    sizes = {n: p.size for n, p in pools.items()}
    t_data = time.perf_counter()
    program = open_program(config, trace, dev, pools)
    try:
        t_open = time.perf_counter()
        for name in traffic.get("pin", ()):
            program.pin(name, pools[name].args(0), pools[name].resident())
        t_pin = time.perf_counter()
        print(f"set-up: data {t_data - t_setup:.3f} s, session "
              f"{t_open - t_data:.3f} s, pin {t_pin - t_open:.3f} s",
              file=sys.stderr)
        return _window(program, pools, traffic, sizes, clients, seed,
                       seconds, trace, dev)
    finally:
        program.close()


def _window(program, pools, traffic, sizes, clients, seed, seconds, trace,
            dev) -> Window:
    mix = traffic["mix"]
    warm = int(traffic["warmup_per_client"])
    whole = int(traffic["full_checks_per_client"])
    answers, kept = [], {n: [] for n in pools}
    lock = threading.Lock()
    ready = threading.Barrier(clients + 1)
    go = threading.Event()
    clock = {}
    errors = []

    def client(c: int) -> None:
        pick = np.random.default_rng([seed, c])
        mine = []                          # this client's kept, whole ones
        try:
            for k in range(warm):
                name, j = schedule(mix, sizes, clients, c, k)
                program.call(name, j, pools[name].args(j)).result(
                    timeout=600)
        except BaseException as e:          # noqa: BLE001 - reported below
            errors.append(e)
        ready.wait()
        go.wait()
        t_end, k, n = clock["t_end"], warm, 0
        while time.perf_counter() < t_end:
            name, j = schedule(mix, sizes, clients, c, k)
            pool = pools[name]
            args = pool.args(j)
            t = time.perf_counter()
            ans = Answer(c, name, j, t, 0.0, pool.work_bytes(j), False)
            req = out = None
            try:
                req = program.call(name, j, args)
                out = req.result(timeout=max(1.0, t_end + LATE_S - t))
                ans.ok = True
            except Exception as e:          # noqa: BLE001 - counted
                ans.error = repr(e)[:200]
            ans.t_done = time.perf_counter()
            rec = getattr(req, "record", None)
            if rec is not None:
                ans.queue_wait, ans.cache_hit = rec.queue_wait, rec.cache_hit
                ans.t_start, ans.t_finish = rec.t_start, rec.t_finish
            if ans.ok:
                # a seeded reservoir of ``whole`` answers kept whole
                slot = n if n < whole else int(pick.integers(n + 1))
                keep = pool.keep(j, out, slot < whole)
                if slot < whole:
                    if n >= whole:
                        mine[slot].full = None
                        mine[slot] = keep
                    else:
                        mine.append(keep)
                n += 1
                with lock:
                    kept[name].append(keep)
            with lock:
                answers.append(ans)
            k += 1

    t_warm = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,), daemon=True,
                                name=f"bench-client-{c}")
               for c in range(clients)]
    for t in threads:
        t.start()
    # the profiler's first start initialises the device tracing, which takes
    # seconds: done here, in set-up, so that the traced slice opens at once
    prof = devtrace.Slice(warm=True) if trace and dev.type == "cuda" else None
    ready.wait()
    if errors:
        clock["t_end"] = 0.0
        go.set()
        raise RuntimeError(f"warm-up request failed: {errors[0]!r}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    cpu0 = time.process_time()
    clock["t0"] = t0 = time.perf_counter()
    clock["t_end"] = t_end = t0 + seconds
    go.set()
    print(f"set-up: warm-up {t0 - t_warm:.3f} s", file=sys.stderr)
    dtrace = spans = None
    if prof is not None:
        start = min(float(traffic["trace"]["start_s"]), seconds / 4)
        span = min(float(traffic["trace"]["slice_s"]), seconds - start)
        time.sleep(max(0.0, t0 + start - time.perf_counter()))
        t_on = prof.start()
        time.sleep(max(0.0, t_on + span - time.perf_counter()))
        dtrace = prof.stop()
        # the program's tracer keeps its newest spans only: take those of
        # the slice now, before later requests push them out
        spans = program.spans()
        print(f"trace: {len(dtrace.ops)} device operations in a slice of "
              f"{dtrace.window_s:.3f} s", file=sys.stderr)
    time.sleep(max(0.0, t_end - time.perf_counter()))
    # this process's CPU seconds (all its threads) over the window's: how
    # many of the host's cores the program and its clients kept busy
    cpu_s = time.process_time() - cpu0
    print(f"host: {cpu_s:.3f} CPU s of this process "
          f"in the {seconds:.3f} s window, {os.cpu_count()} CPUs",
          file=sys.stderr)
    for t in threads:
        t.join(timeout=seconds + 2 * LATE_S)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client did not finish after the window")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    return Window(t0, t_end, answers, kept, pools,
                  program.spans() if spans is None else spans, dtrace, peak,
                  cpu_s)
