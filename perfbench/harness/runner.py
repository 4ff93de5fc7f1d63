"""One run of a cell: the driver's window, the metrics read from it, the
comparison with the reference once the program is freed, and the result
line."""
from __future__ import annotations

import gc
import json
import subprocess
import sys

import numpy as np

from harness import spec

#: top-level module names that may not be loaded by the end of a run: JAX
#: and the JAX package the program was ported from (``repro_torch`` is
#: another name)
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


class Reading:
    """What a metric's reader is given: the window, the set-up time and
    the device's peaks."""

    def __init__(self, window, setup_s: float, kind: str):
        self.window = window
        self.setup_s = setup_s
        self.kind = kind
        self._peaks = spec.load_json(spec.BENCH / "peaks.json")

    def latencies_s(self) -> np.ndarray:
        return np.array([a.t_done - a.t_sub for a in self.window.answers
                         if a.ok])

    def peak(self, key: str) -> float | None:
        return self._peaks.get(self.kind, {}).get(key)


def _smi(fields: str) -> list[str] | None:
    """The first card's ``nvidia-smi`` readings of ``fields``."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return None
    return [v.strip() for v in lines[0].split(",")]


def power_limit() -> str:
    got = _smi("power.limit")
    return got[0] if got else "not read"


#: the card's state beside a run's host facts: a card held below its
#: clocks reads slow for a reason of its own
CARD = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu",
        "clocks_event_reasons.active")


def host_facts(w) -> dict:
    """What tells a fast process from a slow one: this process's CPU
    seconds over the window and a request's share of them, and the card's
    clocks, power and temperature at the close."""
    n = sum(a.ok for a in w.answers)
    facts = {"process_cpu_s": w.cpu_s,
             "cpu_ms_per_answer": 1e3 * w.cpu_s / n if n else None}
    got = _smi(",".join(CARD))
    if got and len(got) == len(CARD):
        facts["card"] = dict(zip(CARD, got))
    return facts


def devices_used() -> int:
    """The cards this process allocated memory on."""
    import torch
    return sum(torch.cuda.max_memory_allocated(d) > 0
               for d in range(torch.cuda.device_count()))


def compare(window, config: dict, device) -> dict:
    """Each number compared, with its limit from the configuration's
    dataset; ``unanswered`` counts requests that raised or never came."""
    checks = {}
    for name, pool in window.pools.items():
        limits = config[name]["limits"]
        for key, value in pool.check(window.kept[name], device).items():
            checks[key] = {"value": value, "limit": limits[key]}
    checks["unanswered"] = {"value": sum(not a.ok for a in window.answers),
                            "limit": 0}
    return checks


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device, t_process: float, open_program=None) -> dict:
    import torch

    driver = spec.driver_module(cell.traffic["driver"])
    kw = {} if open_program is None else {"open_program": open_program}
    w = driver.run(cell.config, cell.traffic, seed, seconds, trace, device,
                   **kw)
    dev = torch.device(device)
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        info = {"platform": "gpu", "kind": kind, "count": devices_used(),
                "memory_peak_bytes": w.memory_peak_bytes,
                "power_limit": power_limit()}
    else:
        kind = "cpu"
        info = {"platform": "cpu", "kind": kind, "count": 0,
                "memory_peak_bytes": 0}
    reading = Reading(w, w.t0 - t_process, kind)
    lat = reading.latencies_s()
    if len(lat):
        print(f"window: {len(lat)} requests answered, latency p50 "
              f"{np.percentile(lat, 50) * 1e3:.3f} ms, p95 "
              f"{np.percentile(lat, 95) * 1e3:.3f} ms, max "
              f"{lat.max() * 1e3:.3f} ms", file=sys.stderr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_module(m["name"]).read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(w, cell.config, dev)
    out = {"correct": bool(w.answers) and all(
               c["value"] <= c["limit"] for c in checks.values()),
           "attempted": len(w.answers),
           "failed": sum(not a.ok for a in w.answers),
           "metrics": metrics, "device": info}
    dt = w.device_trace
    if trace and dt is not None:
        info["busy_s"] = dt.busy_s()
        info["window_s"] = dt.window_s
        out["breakdown"] = {"device_ops": dt.top_ops(),
                            "idle_gaps": dt.idle_by_host(w.spans)}
    out["host"] = host_facts(w) if dev.type == "cuda" else {
        "process_cpu_s": w.cpu_s}
    print(f"host facts: {json.dumps(out['host'])}", file=sys.stderr)
    out["checks"] = checks
    return out
