"""chip_smoke.py's kernel timing, rehearsed on the CPU with scripted clocks,
and its suite plan and suite / session phases, rehearsed on the CPU at a
small size.

``device_ms`` takes a profile again when it lost records (a count that is
no multiple of the calls) or recorded no device time, up to 3 attempts, and
gives None when no attempt is whole.  ``timed`` keeps each median over the
repeats that have that time and counts them (``device_ms_n``).
``gemv_verdict`` decides on device times when VERDICT_MIN repeats of both
rows have them, else on the event times.  The profiler, the CUDA events
and the device clock are replaced here, so no card is needed.  Every
registry workload has a (banks, scale) in each leg of the suite, with NW
at its own scale and TRNS on banks that divide its N' = 64.
"""
import contextlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ITERS = 4

# the whole suite runs in 6 pytest workers on 8 cores: two intra-op threads
# a worker keep these modules from starving the reference's timing-gated tests
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


WHOLE = [(0.8, ITERS, "gemv_rows_k"), (0.4, 2 * ITERS, "Memset")]
LOST = [(0.76, ITERS - 1, "gemv_rows_k"), (0.4, 2 * ITERS, "Memset")]
EMPTY: list = []


@pytest.mark.parametrize("profiles,want,attempts", [
    ([WHOLE], 0.3, 1),
    ([EMPTY, WHOLE], 0.3, 2),
    ([LOST, EMPTY, WHOLE], 0.3, 3),
    ([LOST, LOST, LOST], None, 3),
    ([EMPTY, EMPTY, EMPTY], None, 3),
    ([LOST, EMPTY, LOST], None, 3),
])
def test_device_ms_takes_lost_profiles_again(cs, monkeypatch, profiles, want,
                                             attempts):
    script = iter(profiles)
    taken = []

    def device_ops(prof):
        taken.append(1)
        return next(script)

    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(cs, "device_ops", device_ops)
    seen = [("earlier", 1, "kept")]
    got = cs.device_ms(lambda: None, ITERS, seen)
    assert len(taken) == attempts
    if want is None:
        assert got is None
        assert seen == [("earlier", 1, "kept")]   # a lossy profile is not used
    else:
        assert got == pytest.approx(want)
        assert seen == WHOLE


def gemv_case(kernel_dev, lib_dev, kernel_ms=0.20, lib_ms=0.21):
    """A small gemv case on the CPU whose device_ms / cuda_ms answers are
    scripted per repeat: ``kernel_dev`` and ``lib_dev`` list the kernel's and
    the library's device times (None: no whole profile)."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn((2, 8, 16), generator=g)
    v = torch.randn(16, generator=g)
    kernel = lambda: torch.mv(a.view(-1, 16), v)          # noqa: E731
    library = lambda: torch.mv(a.view(-1, 16), v)         # noqa: E731
    dev = {kernel: iter(kernel_dev), library: iter(lib_dev)}
    ms = {kernel: kernel_ms, library: lib_ms}
    case = dict(name="gemv", source="src/repro_torch/csrc/gemv.cu",
                replaces="src/repro/kernels/gemv.py:46", kernel=kernel,
                plain=lambda: torch.mv(a.view(-1, 16), v), library=library,
                nbytes=a.nbytes + v.nbytes + 64, nops=2 * a.numel(),
                tol=1e-4, repeats=len(kernel_dev))
    return case, (lambda fn, iters=None, seen=None: next(dev[fn])), (
        lambda fn, iters=None: ms.get(fn, 0.5))


@pytest.mark.parametrize("kernel_dev,lib_dev", [
    ([0.173, 0.174, 0.172, 0.173, 0.175], [0.174] * 5),
    ([0.173, None, 0.172, 0.173, 0.175], [0.174, 0.175, None, None, 0.174]),
    ([None] * 5, [0.174, None, 0.175, 0.176, 0.174]),
])
def test_timed_medians_over_repeats_with_device_time(cs, monkeypatch,
                                                     kernel_dev, lib_dev):
    case, dev, ms = gemv_case(kernel_dev, lib_dev)
    monkeypatch.setattr(cs, "device_ms", dev)
    monkeypatch.setattr(cs, "cuda_ms", ms)
    row = cs.timed(case)
    for key, runs in (("device_ms", kernel_dev),
                      ("library_device_ms", lib_dev)):
        have = [t for t in runs if t is not None]
        assert row[key + "_n"] == len(have)
        if have:
            assert row[key] == pytest.approx(float(np.median(have)))
            assert row["spread"][key] == pytest.approx(
                [min(have), float(np.median(have)), max(have)])
        else:
            assert row[key] is None and key not in row["spread"]
    assert row["ms"] == pytest.approx(0.20)
    assert row["plain_ms"] == pytest.approx(0.5)
    assert row["spread"]["ms"] == pytest.approx([0.20] * 3)


def verdict_row(dev_n, lib_n, dev, lib, ms=(0.20, 0.21, 0.22),
                lib_ms=(0.185, 0.19, 0.195)):
    return {"device_ms_n": dev_n, "library_device_ms_n": lib_n,
            "spread": {"device_ms": list(dev), "library_device_ms": list(lib),
                       "ms": list(ms), "library_ms": list(lib_ms)}}


@pytest.mark.parametrize("row,on,slower", [
    # device times from every repeat: a gap under the summed spreads
    (verdict_row(5, 5, (0.1730, 0.1733, 0.1736), (0.1740, 0.1742, 0.1744)),
     "device_ms (5 of 5 repeats), library_device_ms (5 of 5)", False),
    # VERDICT_MIN repeats of both suffice; this gap is past the spread
    (verdict_row(3, 4, (0.1790, 0.1795, 0.1797), (0.1740, 0.1742, 0.1744)),
     "device_ms (3 of 5 repeats), library_device_ms (4 of 5)", True),
    # too few device times on one side: the event times decide (their gap,
    # 0.02 ms, within their spread, 0.03 ms)
    (verdict_row(2, 5, (0.1790, 0.1795, 0.1797), (0.1740, 0.1742, 0.1744)),
     "ms (5 of 5 repeats), library_ms (5 of 5)", False),
    # ... and their gap beyond their spread
    (verdict_row(5, 2, (0.1730, 0.1733, 0.1736), (0.1740, 0.1742, 0.1744),
                 ms=(0.2000, 0.2010, 0.2020), lib_ms=(0.1900, 0.1905, 0.1910)),
     "ms (5 of 5 repeats), library_ms (5 of 5)", True),
])
def test_gemv_verdict_on_device_times_from_enough_repeats(cs, row, on,
                                                          slower):
    cs.gemv_verdict(row)
    assert row["verdict_on"] == on
    assert row["verdict"].startswith("slower") == slower


def test_timed_then_verdict_skips_a_repeat_without_device_time(cs,
                                                                monkeypatch):
    """One repeat of five without a whole profile leaves four device times
    on the kernel's side: still enough for the verdict to use them."""
    case, dev, ms = gemv_case([0.1733, 0.1734, None, 0.1732, 0.1735],
                              [0.1742] * 5, kernel_ms=0.30, lib_ms=0.17)
    monkeypatch.setattr(cs, "device_ms", dev)
    monkeypatch.setattr(cs, "cuda_ms", ms)
    row = cs.timed(case)
    cs.gemv_verdict(row)
    assert row["device_ms_n"] == 4
    assert row["verdict_on"].startswith("device_ms (4 of 5")
    assert row["verdict"].startswith("no slower")


# -- the suite's plan and phases --------------------------------------------------

def test_suite_plan_covers_every_workload(cs):
    """Both legs give every workload the leg's banks and scale, BFS too;
    NW runs at NW_SCALE = 32 and TRNS on banks that divide N' = 64, which
    the flat 2,048-bank session's do not."""
    from repro_torch.prim.registry import REGISTRY
    assert cs.SUITE == ((2048, 1024), (1, 64)) and cs.NW_SCALE == 32
    (x,) = REGISTRY["TRNS"].make_args(np.random.default_rng(0), scale=1)
    assert cs.TRNS_NP == x.shape[1] // 8 == 64
    assert cs.TRNS_NP % cs.BANKS and cs.BANKS == 2048
    for banks, scale in cs.SUITE:
        plan = cs.suite_plan(banks, scale, REGISTRY)
        assert list(plan) == list(REGISTRY)
        for name, (b, sc) in plan.items():
            if name == "NW":
                assert (b, sc) == (banks, 32)
            elif name == "TRNS":
                assert cs.TRNS_NP % b == 0 and (b, sc) == (
                    min(banks, 64), scale)
            else:
                assert (b, sc) == (banks, scale), name


def test_suite_and_session_phases_rehearse_on_the_cpu(cs, monkeypatch,
                                                      tmp_path, capsys):
    """The suite's two legs, the ranked session and the flat session at
    128 banks (2 ranks of 64) on the CPU: every result is checked, the warm
    hits scatter as asserted, and TRNS on 128 banks raises the reference's
    assertion."""
    import functools

    import repro_torch
    from repro_torch import pim
    monkeypatch.setattr(repro_torch, "make_bank_grid", functools.partial(
        repro_torch.make_bank_grid, device="cpu"))
    monkeypatch.setattr(pim, "session", functools.partial(pim.session,
                                                          device="cpu"))
    for name, value in (("SUITE", ((128, 1), (1, 1))), ("BANKS", 128),
                        ("RANKS", 2), ("BANKS_PER_RANK", 64),
                        ("NW_SCALE", 2), ("TRACE", str(tmp_path / "t.json"))):
        monkeypatch.setattr(cs, name, value)
    args: dict = {}
    counts, serialized = cs.suite_phase(args)
    assert set(args) == set(serialized) == set(pim.registry())
    assert not any(counts.values())          # CPU tensors launch no kernel
    cs.session_phase(args, serialized)
    cs.flat_session_phase(args)
    out = capsys.readouterr().out
    assert "TRNS on 128 banks: AssertionError(N' must divide across banks)" \
        in out
    for name in ("GEMV", "SpMV", "MLP"):
        assert f"{name} warm: 0 chunk scatters, 16 cached spans" in out
    assert "BS warm: 16 chunk scatters, 2 cached spans" in out
    assert "NW fallback" in out and "BFS fallback" in out


# -- the tune phase ------------------------------------------------------------------

def tuned_cpu_session(names, banks=4):
    from repro_torch import pim
    from repro_torch.prim.registry import REGISTRY
    rng = np.random.default_rng(0)
    args = {}
    for name in names:
        a = REGISTRY[name].make_args(rng, 1)
        args[name] = (a, REGISTRY[name].ref(*a))
    s = pim.session(banks=banks, device="cpu")
    result = s.autotune(names, scale=1, reps=1, probe=True,
                        calib_nbytes=(1 << 12, 1 << 14))
    return s, result, args


def test_check_tuned_formats_and_checks_on_the_cpu(cs, capsys):
    """check_tuned prints each plan with its probed times and serves each
    workload against ref() on a CPU 4-bank session at scale 1."""
    names = ["VA", "GEMV", "RED", "SpMV"]
    s, result, args = tuned_cpu_session(names)
    try:
        assert cs.check_tuned(s, result, args) == []     # no cost model
    finally:
        s.close()
    out = capsys.readouterr().out
    for name in names:
        plan = result.plans[name]
        assert f"  {name:7s} n_chunks {plan.n_chunks} " in out
        assert f"  {name:7s} served ok: predicted overlap " in out
        assert 4 in plan.measured_s


def test_check_tuned_fails_a_plan_slower_than_the_default(cs):
    import dataclasses

    from repro_torch.runtime.autotune import TuningResult
    s, result, args = tuned_cpu_session(["RED"])
    bad = dataclasses.replace(result.plans["RED"], n_chunks=2,
                              measured_s={2: 0.002, 4: 0.001})
    try:
        with pytest.raises(AssertionError, match="over the default"):
            cs.check_tuned(s, TuningResult({}, result.profiles,
                                           {"RED": bad}), args)
        unprobed = dataclasses.replace(result.plans["RED"],
                                       measured_s={2: 0.001})
        with pytest.raises(AssertionError, match="default not probed"):
            cs.check_tuned(s, TuningResult({}, result.profiles,
                                           {"RED": unprobed}), args)
    finally:
        s.close()


def test_check_tuned_fails_a_result_unlike_ref(cs):
    s, result, args = tuned_cpu_session(["RED", "GEMV"])
    a, gold = args["GEMV"]
    try:
        with pytest.raises(AssertionError):
            cs.check_tuned(s, result, {**args, "GEMV": (a, gold + 1.0)})
    finally:
        s.close()


def test_tune_phase_rehearses_on_the_cpu(cs, monkeypatch, capsys):
    """The whole tune phase at 8 banks (2 ranks of 4) and scale 1 on the
    CPU, the suite's arguments made by the phase itself."""
    import functools

    import repro_torch
    from repro_torch import pim
    for fn in ("make_bank_grid", "make_rank_grid"):
        monkeypatch.setattr(repro_torch, fn, functools.partial(
            getattr(repro_torch, fn), device="cpu"))
    monkeypatch.setattr(pim, "session", functools.partial(pim.session,
                                                          device="cpu"))
    for name, value in (("SUITE", ((8, 1), (1, 1))), ("BANKS", 8),
                        ("RANKS", 2), ("BANKS_PER_RANK", 4),
                        ("TRNS_BANKS", 8), ("NW_SCALE", 2),
                        ("TUNE_SCALE", 1), ("STREAM_N", 1 << 12),
                        ("RANK_SWEEP_BYTES", 1 << 14)):
        monkeypatch.setattr(cs, name, value)
    args: dict = {}
    counts = cs.tune_phase(args)
    assert not any(counts.values())          # CPU tensors launch no kernel
    assert len(args) == 16 - 2               # made here: all but NW and BFS
    out = capsys.readouterr().out
    for sweep in ("push_pull_sweep", "bank_compute_sweep",
                  "op_throughput_sweep", "stream_wram", "transfer_sweep",
                  "rank_parallel_sweep", "StageFits", "CostModel",
                  "GpuModel"):
        assert f"  {sweep}" in out, sweep
    assert out.count("served ok") == 14 + 3 + 3
    assert "session(banks=8, autotune=...): plans for 14 workloads" in out
    assert "cost model: geomean of predicted over measured" in out
