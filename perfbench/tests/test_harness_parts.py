"""The harness's parts against hand counts and hand cases."""
import json
import re
import sys
import types

import numpy as np
import pytest
import torch

from harness import answers, devtrace, runner, spec

NAMES = ("SEL", "UNI", "RED", "SCAN", "GEMV")
W = {n: spec.workload_module(n) for n in NAMES}
R = {n: spec.reference_module(n) for n in NAMES}


def test_output_bytes_by_hand():
    x = torch.tensor([1, 2, 2, 3, 3, 3, 8], dtype=torch.int32)
    assert W["SEL"].out_bytes(x) == 4 * 4          # 1, 3, 3, 3
    assert W["UNI"].out_bytes(x) == 4 * 4          # 1, 2, 3, 8
    assert W["RED"].out_bytes(x) == 8              # one int64
    assert W["SCAN"].out_bytes(x) == 7 * 4
    x64 = x.to(torch.int64)
    assert W["SEL"].out_bytes(x64) == 4 * 8
    assert W["UNI"].out_bytes(x64) == 4 * 8
    assert W["SCAN"].out_bytes(x64) == 7 * 8


def test_work_bytes_by_hand():
    g = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(3)
    data = {"elements": 10, "dtype": "int64"}
    sel = W["SEL"].make(data, 2, g, "cpu", rng, 4)
    for j in range(2):
        # 1 .. 10 in, the five odd ones out
        assert sel.args(j)[0].tolist() == list(range(1, 11))
        assert sel.work_bytes(j) == 10 * 8 + 5 * 8
    uni = W["UNI"].make(data, 1, g, "cpu", rng, 4)
    # 0 2 2 4 4 6 6 8 8 10 in, 0 2 4 6 8 10 out
    assert uni.work_bytes(0) == 10 * 8 + 6 * 8
    scan = W["SCAN"].make(data, 1, g, "cpu", rng, 4)
    assert scan.work_bytes(0) == 10 * 8 + 10 * 8
    red = W["RED"].make(data, 1, g, "cpu", rng, 4)
    assert red.work_bytes(0) == 10 * 8 + 8
    gemv = W["GEMV"].make({"rows": 3, "cols": 2, "dtype": "float32"}, 5, g,
                          "cpu", rng, 4)
    # A once, x once, y once: (3*2 + 2 + 3) float32
    assert gemv.work_bytes(4) == (6 + 2 + 3) * 4
    assert gemv.resident() == (0,) and sel.resident() == ()


def test_sorted_input_and_seeds():
    """The suite's generators: UNI's sorted runs of two and SEL's 1 .. n
    take no seed; RED's and SCAN's ``rand()`` values are the seed's."""
    data = {"elements": 1000, "dtype": "int64"}

    def draw(name, seed):
        return W[name].make(data, 2, torch.Generator().manual_seed(seed),
                            "cpu", np.random.default_rng(seed), 8)

    u = draw("UNI", 7).args(0)[0]
    assert u.dtype == np.int64 and np.all(np.diff(u) >= 0)
    assert u[:7].tolist() == [0, 2, 2, 4, 4, 6, 6]
    assert np.array_equal(u, draw("UNI", 8).args(1)[0])
    for name in ("RED", "SCAN"):
        a, b, c = draw(name, 7), draw(name, 7), draw(name, 8)
        x = a.args(0)[0]
        assert x.dtype == np.int64 and 0 <= x.min() and x.max() < 2**31
        assert x.max() > 2**30                     # the whole of rand()
        assert np.array_equal(a.args(1)[0], b.args(1)[0])
        assert not np.array_equal(x, c.args(0)[0])
        assert not np.array_equal(x, a.args(1)[0])
        assert np.array_equal(a.pos, b.pos)


def test_references_by_hand():
    x = np.array([1, 2, 2, 3, 3, 3, 8], dtype=np.int32)
    assert R["SEL"].ref(x).tolist() == [1, 3, 3, 3]
    assert R["UNI"].ref(x).tolist() == [1, 2, 3, 8]
    assert R["RED"].ref(np.full(3, 2**31 - 1, np.int32)) == 3 * (2**31 - 1)
    assert R["SCAN"].ref(np.array([1, 2, 3], np.int32)).tolist() == [0, 1, 3]
    a = np.array([[1.0, 2.0], [-3.0, 4.0]], np.float32)
    xs = np.array([[1.0, 1.0], [0.5, -1.0]], np.float32)
    y, s = R["GEMV"].product(a, xs, "cpu")
    assert y.tolist() == [[3.0, -1.5], [1.0, -5.5]]
    assert s.tolist() == [[3.0, 2.5], [7.0, 5.5]]
    y, _ = R["GEMV"].product(a, xs, "cpu", rows=[1], block=1)
    assert y.tolist() == [[1.0, -5.5]]


def test_controls_lose_what_the_configuration_keeps():
    x = np.full(4, 2**31 - 1, np.int64)                   # rand()'s largest
    assert R["RED"].control(x) != R["RED"].ref(x)          # wraps
    assert not np.array_equal(R["SCAN"].control(x), R["SCAN"].ref(x))
    # SEL and UNI have no arithmetic to lower: their control is exact on
    # the suite's inputs, below 2**31
    y = np.arange(1, 10, dtype=np.int64)
    assert np.array_equal(R["SEL"].control(y), R["SEL"].ref(y))
    assert np.array_equal(R["UNI"].control(y), R["UNI"].ref(y))
    t = torch.tensor([1 + 2**-12, 1 + 2**-10, 3.0], dtype=torch.float32)
    assert R["GEMV"].tf32(t).tolist() == [1.0, 1 + 2**-10, 3.0]


def test_kept_answers_compare_exactly():
    rng = np.random.default_rng(0)
    ref = np.arange(100, dtype=np.int64)
    pos = answers.positions(100, 10, rng)
    assert len(pos) == 10 and pos[0] < 10
    good = answers.keep(0, ref.astype(np.int32), pos, True)
    short = answers.keep(0, ref[:50], pos, False)
    off = ref.copy()
    off[pos[3]] += 1
    moved = answers.keep(0, off, pos, False)
    hidden = ref.copy()
    hidden[(pos[0] + 1) % 100] = -1               # between the positions
    whole = answers.keep(0, hidden, pos, True)
    sampled = answers.keep(0, hidden, pos, False)
    refs = {0: ref}
    assert answers.mismatches([good, sampled], refs, pos) == 0
    assert answers.mismatches([short], refs, pos) == 1
    assert answers.mismatches([moved], refs, pos) == 1
    assert answers.mismatches([whole], refs, pos) == 1
    scalar = answers.keep(1, np.int64(7), pos, True)
    assert answers.mismatches([scalar], {1: np.int64(7)}, pos) == 0
    assert answers.mismatches([scalar], {1: np.int64(8)}, pos) == 1


def test_gemv_check_reads_errors_and_malformed_answers():
    g = torch.Generator().manual_seed(1)
    pool = W["GEMV"].make({"rows": 64, "cols": 32, "dtype": "float32"}, 4,
                          g, "cpu", np.random.default_rng(1), 8)
    exact = [(pool.a.astype(np.float64) @ pool.xs[j].astype(np.float64))
             for j in range(4)]
    kept = [pool.keep(j, exact[j].astype(np.float32), j % 2 == 0)
            for j in range(4)]
    got = pool.check(kept, "cpu")
    assert got["gemv_malformed"] == 0 and got["gemv_scaled_err"] < 1e-7
    bad = exact[1].copy()
    bad[pool.pos[0]] = np.nan
    kept.append(pool.keep(1, bad, False))
    kept.append(pool.keep(2, exact[2][:10], False))
    assert pool.check(kept, "cpu")["gemv_malformed"] == 2


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", types.ModuleType("x"))
    assert runner.banned_modules() == []
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jnp"))
    assert runner.banned_modules() == ["jax", "repro"]


class _Span:
    def __init__(self, name, t0, t1):
        self.name, self.t0, self.t1 = name, t0, t1


def test_device_trace_by_hand():
    marks = {"bench.mark.0": 10.0, "bench.mark.1": 11.0}
    base = 5_000_000.0                   # the profiler's clock: +5 s

    def ev(name, cat, t, dur, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": (t + 5) * 1e6,
                "dur": dur * 1e6, "args": args}

    events = [
        {"ph": "X", "name": "bench.mark.0", "cat": "user_annotation",
         "ts": 10.0 * 1e6 + base, "dur": 1},
        {"ph": "X", "name": "bench.mark.1", "cat": "user_annotation",
         "ts": 11.0 * 1e6 + base, "dur": 1},
        ev("gemv", "kernel", 10.1, 0.2),
        ev("gemv", "kernel", 10.2, 0.2),          # overlaps the first
        ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 10.5, 0.1,
           bytes=4_000_000),
        ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 10.55, 0.1,
           bytes=2_000_000),
        ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 10.9, 0.2,
           bytes=1),                               # runs past the slice
        ev("early", "kernel", 9.0, 0.5),           # before the slice
        ev("cudaLaunchKernel", "cuda_runtime", 10.1, 0.01),
    ]
    dt = devtrace.parse(events, marks)
    assert [o.name for o in dt.ops].count("gemv") == 2
    assert dt.window_s == pytest.approx(1.0)
    assert dt.kernel_s() == pytest.approx(0.3)
    assert dt.busy_s() == pytest.approx(0.3 + 0.15 + 0.1)
    h2d = devtrace.length((o.t0, o.t1) for o in dt.copies("HtoD"))
    assert h2d == pytest.approx(0.15)
    assert sum(o.nbytes for o in dt.copies("HtoD")) == 6_000_000
    assert [t for g in dt.gaps() for t in g] == pytest.approx(
        [10.0, 10.1, 10.4, 10.5, 10.65, 10.9])
    spans = [_Span("serve", 9.0, 12.0), _Span("merge", 10.0, 10.45),
             _Span("scatter", 10.6, 10.95)]
    idle = dict(dt.idle_by_host(spans))
    assert idle["merge"] == pytest.approx(0.2)
    assert idle["scatter"] == pytest.approx(0.25)
    top = dict(dt.top_ops())
    assert top["gemv"] == pytest.approx(0.4)
    with pytest.raises(RuntimeError):
        devtrace.parse(events[1:], marks)


def test_roofline_and_idle_readers_by_hand():
    dt = devtrace.DeviceTrace(0.0, 2.0, [
        devtrace.Op("k", "kernel", 0.0, 0.5),
        devtrace.Op("Memcpy HtoD", "gpu_memcpy", 0.5, 1.0, 10**9)])

    class A:
        ok, t_start, t_finish, work = True, 1.0, 3.0, 6_700_000_000

    class Win:
        device_trace, answers = dt, [A()]

    class Rd:
        window = Win()

        def peak(self, key):
            return {"hbm_bytes_per_s": 3.35e12}[key]

    roof = spec.metric_module("compute_roofline").read(Rd())
    # half the request's work lies in the slice: 3.35e9 B over 0.5 s
    assert roof == pytest.approx(100 * 3.35e9 / (0.5 * 3.35e12))
    idle = spec.metric_module("device_idle_share").read(Rd())
    assert idle == pytest.approx(50.0)
    assert spec.metric_module("h2d_GBps").read(Rd()) == pytest.approx(2.0)
    Win.device_trace = None
    assert spec.metric_module("compute_roofline").read(Rd()) is None


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    b = spec.load_json(spec.ROOT / "BENCHMARK.json")
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"][1] == "perfbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert (spec.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (spec.BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert all(0 < len(c[k]) <= 200 and "\n" not in c[k]
                   and "\t" not in c[k] for k in ("source", "why"))
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
    pairs = set()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = spec.load_cell(w["name"])
        assert cell.per_layer and len(cell.end_to_end) >= 2
        assert spec.driver_module(cell.traffic["driver"])
        for name in cell.traffic["mix"]:
            assert spec.workload_module(name) and name in cell.config
    assert {c for _, c in [(w["traffic"], w["config"])
                           for w in b["workloads"]]} == configs
