"""Whole runs of each cell on the CPU at a small size (``conftest.tiny``):
the program's answers come out correct, the control's and those of a
program broken underneath do not, and ``run.py`` refuses to run without
its cards or its program."""
import dataclasses
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import BENCH, tiny
from harness import runner, spec

import control
import run

CELLS = [w["name"] for w in
         spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]
SESSION = spec.driver_module("session_closed_loop").Session


def execute(cell, open_program=None, trace=False, seconds=1.0):
    return runner.execute(cell, 2**33 + 11, seconds, trace, "cpu",
                          time.perf_counter(), open_program=open_program)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_program_runs_correct_on_the_cpu(name, trace):
    cell = tiny(name)
    out = execute(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    # the device's readings need the card's trace: none on the CPU
    device = {m["name"] for m in cell.per_layer
              if m["source"] == "device_trace"}
    assert set(out["metrics"]) == want - device
    if "resident_hit_share" in out["metrics"]:
        assert out["metrics"]["resident_hit_share"]["value"] == 100.0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    out = execute(tiny(name), open_program=control.Control)
    assert not out["correct"], out["checks"]
    over = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert over and "unanswered" not in over


def _broken(change):
    """The program with every workload's merge replaced by
    ``change(merge)``: the timed path broken underneath."""

    class Broken(SESSION):
        def __init__(self, *args):
            super().__init__(*args)
            wls = self.s.scheduler.workloads
            for name, wl in wls.items():
                wls[name] = dataclasses.replace(wl, merge=change(wl.merge))

    return Broken


def _altered(merge):
    def altered(grid, meta, parts):
        out = merge(grid, meta, parts)
        if np.ndim(out) == 0:
            return out + 1
        out = np.array(out)
        out[len(out) // 2] += 1
        return out
    return altered


def _chunk_left_out(merge):
    def short(grid, meta, parts):
        return merge(grid, meta, parts[:-1])
    return short


@pytest.mark.parametrize("fault", [_altered, _chunk_left_out])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_program_is_not_correct(name, fault):
    out = execute(tiny(name), open_program=_broken(fault))
    assert not out["correct"], out["checks"]


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == ""
    assert "CUDA" in captured.err


def test_run_refuses_without_its_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's own
    files exits non-zero and prints no result."""
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_a_run_loads_no_jax():
    """A whole run in a process of its own leaves no module whose top-level
    name is jax, jaxlib, flax or repro (``repro_torch`` is another name)."""
    code = (
        "import sys, time, json; sys.path[:0] = [%r, %r]\n"
        "from conftest import tiny\n"
        "from harness import runner\n"
        "import run\n"
        "for name in %r:\n"
        "    runner.execute(tiny(name), 5, 0.5, True, 'cpu', "
        "time.perf_counter())\n"
        "print(json.dumps(runner.banned_modules()))\n"
        % (str(BENCH / "tests"), str(BENCH), CELLS))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=spec.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_every_seed_sends_the_same_requests():
    sched = spec.driver_module("session_closed_loop").schedule
    mix = ["SEL", "UNI", "RED", "SCAN"]
    sizes = {"SEL": 1, "UNI": 1, "RED": 2, "SCAN": 2}
    seq = [sched(mix, sizes, 4, c, k) for c in range(4) for k in range(10)]
    assert {n for n, _ in seq} == set(mix)
    assert {j for n, j in seq if n == "RED"} == {0, 1}
    assert {j for n, j in seq if n == "SEL"} == {0}
    gemv = [sched(["GEMV"], {"GEMV": 8192}, 8, c, k)[1]
            for c in range(8) for k in range(1024)]
    assert len(set(gemv)) == 8192          # every client its own vectors
