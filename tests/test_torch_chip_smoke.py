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
import os
import pathlib
import re

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


# -- the VLM and xLSTM phases ---------------------------------------------------------

@pytest.mark.parametrize("phase,arch", [("vlm_phase", "llama-3.2-vision-11b"),
                                        ("xlstm_phase", "xlstm-125m")])
def test_family_phases_rehearse_on_the_cpu(cs, monkeypatch, capsys, phase,
                                           arch):
    """The VLM and xLSTM phases at SMOKE size on the CPU (its config in
    bfloat16, the FULL dtype; 64 tokens, 16 of decode, the mLSTM chunked
    by 16 and held at the reference's 1e-4 of 64 positions): every check
    of the phase runs; CPU tensors launch no kernel, so the layer plan's
    launches are taken as zeros here."""
    import dataclasses

    from repro_torch import configs
    smoke = dataclasses.replace(configs.get_config(arch, smoke=True),
                                dtype=torch.bfloat16)
    monkeypatch.setattr(configs, "get_config", lambda name: smoke)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "expected_launches", lambda model: {
        "flash_attention": 0, "moe_gmm": 0, "ssd_scan": 0})
    for name, value in (("PREFILL", 64), ("CONSIST", 16), ("MLSTM_CHUNK", 16),
                        ("MLSTM_TOL", 1e-4)):
        monkeypatch.setattr(cs, name, value)
    counts = getattr(cs, phase)(torch.device("cpu"))
    assert not any(counts.values())
    out = capsys.readouterr().out
    assert f"check {arch} decode vs prefill" in out
    assert "forward bf16, " in out and "greedy_generate bf16 2 x (8 + 8)" \
        in out
    if phase == "vlm_phase":
        assert f"check {arch} f32 kernel vs plain" in out
        assert "['attn', 'attn', 'attn', 'attn', 'cross']" in out
    else:
        assert "per layer" in out and out.count("e-0") >= 3


# -- the train phase -------------------------------------------------------------------

@pytest.fixture
def train_rehearsal(cs, monkeypatch):
    """The train phase's config at SMOKE size in its FULL dtype and remat
    (bfloat16, remat on), sequences of 64 / 32 / 32 tokens, the CUDA
    memory counters and ``synchronize`` stubbed; the eval leg (the
    kernel, and its refusal under grad, exist only on the card) recorded
    instead of run."""
    import dataclasses

    from repro_torch import configs
    smoke = dataclasses.replace(configs.get_config("tinyllama-1.1b",
                                                   smoke=True),
                                dtype=torch.bfloat16, remat=True)
    monkeypatch.setattr(configs, "get_config", lambda name: smoke)
    for fn in ("synchronize", "reset_peak_memory_stats",
               "max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: 0)
    for name, value in (("TRAIN_SEQ", 64), ("F32_SEQ", 32),
                        ("RESTART_SEQ", 32)):
        monkeypatch.setattr(cs, name, value)
    evals = []
    monkeypatch.setattr(cs, "train_eval_leg", lambda model, cfg, batch: (
        evals.append((cfg, batch)), {"flash_attention": 0})[1])
    return smoke, evals


def test_train_phase_rehearses_on_the_cpu(cs, monkeypatch, capsys,
                                          train_rehearsal):
    """Legs (a), (b) and (d) on the CPU: 8 steps whose loss falls by
    TRAIN_MARGIN (the margin rehearsed: at this size the mean of the last
    3 lies 1.06 below the first 3's; 1.52 at 2,048 tokens), no kernel
    launched by the
    steps, one profiled step, 2 steps at 2 microbatches; the float32 leg
    (CPU against CPU here); the restart, run in this process
    (deterministic algorithms are the child's on the card)."""
    smoke, evals = train_rehearsal
    monkeypatch.setattr(cs, "restart_leg",
                        lambda: cs.restart_run(torch.device("cpu")))
    counts = cs.train_phase(torch.device("cpu"), "cpu rehearsal")
    assert counts == {"flash_attention": 0}
    assert len(evals) == 1 and evals[0][0] is smoke
    assert evals[0][1]["tokens"].shape == (cs.TRAIN_BATCH, 64)
    out = capsys.readouterr().out
    lines = out.splitlines()
    steps = [ln for ln in lines if ln.startswith("  step ")]
    assert len(steps) == cs.TRAIN_STEPS
    assert all(ln.endswith("tokens/s) on cpu rehearsal") for ln in steps)
    assert "peak memory at 2 microbatches 0.00 GB on cpu rehearsal" in out
    assert sum(ln.startswith("  2 microbatches, step ") for ln in lines) == 2
    head = "loss mean of the first 3 "
    first, last = (float(x) for x in
                   re.search(head + r"(\S+), of the last 3 (\S+)", out).groups())
    assert last < first - cs.TRAIN_MARGIN
    assert "launches of the steps {'reduce_sum': 0" in out
    assert "f32, 2 layers, 1 x 32: loss card" in out
    assert "apply on identical gradients, card vs cpu" in out
    assert "loss_chunks=8 vs whole logits" in out
    assert re.search(r"restart: 4 steps against 2 \+ a checkpoint \+ 2 "
                     r"resumed.*optimizer state equal", out)


def test_restart_leg_fails_with_its_child(cs, monkeypatch):
    """A non-zero exit of the restart child fails the phase, with the
    child's standard error in the message."""
    import subprocess

    monkeypatch.setattr(subprocess, "run", lambda *a, **kw:
                        subprocess.CompletedProcess(a, 1, "", "boom"))
    with pytest.raises(AssertionError, match="exited 1:\nboom"):
        cs.restart_leg()


def smoke_dist_configs():
    """The dist phase's models at SMOKE size (DeepSeek SMOKE with
    ``moe_ep``, 8 experts over 4 ranks, and as published, with and
    without ``fsdp``; TinyLlama SMOKE at 2 layers, with and without
    ``fsdp``; StableLM SMOKE, 4 heads and 2 kv heads over 4 ranks; the
    Jamba SMOKE cut to 2 layers with ``moe_ep``, and with ``fsdp`` as its
    FULL config is published; danube SMOKE, window 16, over a cache of 64
    positions decoded from 40, so that the window straddles a block
    boundary on (4, 1) and (2, 2); leg L's own SMOKE configs), in their
    FULL dtypes where the phase runs bfloat16, at short sequences."""
    import dataclasses
    import sys

    from repro_torch.configs import get_config
    published = get_config("deepseek-moe-16b", smoke=True)
    moe = dataclasses.replace(published, moe_ep=True)
    lm = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                             n_layers=2)
    bf16 = dataclasses.replace(published, dtype=torch.bfloat16)
    tp = get_config("stablelm-12b", smoke=True)
    danube = get_config("h2o-danube-3-4b", smoke=True)
    return {"tp_f32": dataclasses.replace(tp, n_layers=4),
            "tp_bf16": dataclasses.replace(tp, dtype=torch.bfloat16),
            "hy_f32": dataclasses.replace(
                get_config("jamba-1.5-large-398b", smoke=True), n_layers=2,
                moe_ep=True),
            "tp_seq": 32,
            "moe_f32": dataclasses.replace(moe, n_layers=4),
            "moe_bf16": dataclasses.replace(moe, dtype=torch.bfloat16),
            "lm_f32": lm,
            "lm_bf16": dataclasses.replace(lm, dtype=torch.bfloat16),
            "ep_train": dataclasses.replace(moe, n_layers=2,
                                            dtype=torch.bfloat16),
            "g_f32": dataclasses.replace(published, n_layers=4),
            "g_bf16": bf16,
            "h_f32": dataclasses.replace(published, n_layers=4, fsdp=True),
            "h_bf16": dataclasses.replace(bf16, fsdp=True),
            "h_jamba": dataclasses.replace(
                get_config("jamba-1.5-large-398b", smoke=True), n_layers=2,
                dtype=torch.bfloat16, fsdp=True),
            "i_lm": dataclasses.replace(lm, fsdp=True),
            "j_f32": danube,
            "j_bf16": dataclasses.replace(danube, dtype=torch.bfloat16),
            "j_max_len": 64, "j_start": 40, "j_new": 4, "j_slab": 8,
            "j_prefill": 64, "fsdp_seq": 32,
            "l_cases": {k: dataclasses.replace(get_config(arch, smoke=True),
                                               **fields)
                        for k, (arch, fields) in
                        sys.modules["chip_smoke"].CUT_CASES.items()},
            "l_seq": 64, "l_new": 2,
            "prefill": 64, "prompt": 8, "new": 4, "f32_seq": 16, "seq": 32,
            "steps": 4, "ep_seq": 16, "world": 4}


def test_dist_phase_rehearses_on_the_cpu(cs, monkeypatch, capsys):
    """The dist phase at SMOKE size in 4 gloo ranks on the CPU: leg A's
    float32 TP + EP forward against one process at every position (one
    process's top-k sets replayed), leg B's greedy tokens equal on
    every rank, leg C's float32 gradients, the compressed step, the
    restart onto (2, 1) at 1e-5 and the EP steps on (2, 2) within
    DIST_EP_TOL; leg D's tensor-parallel forward and greedy tokens on (1,
    4) and each rank's parameter bytes against the reference's specs,
    leg E's TP + EP Jamba cut, leg F's gradients on (2, 2) and its
    restart onto (1, 2); leg J's sequence-sharded cache on (4, 1) and (2,
    2), each rank's bytes of keys and values the reference's specs'; no
    launch (CPU tensors run the plain versions),
    no memory counter (the card's)."""
    import sys

    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.setattr(cs, "dist_configs", smoke_dist_configs)
    counts = cs.dist_phase(torch.device("cpu"), "cpu rehearsal")
    assert counts == {"ep": {"flash_attention": 0, "moe_gmm": 0},
                      "tp": {"flash_attention": 0, "ssd_scan": 0,
                             "moe_gmm": 0},
                      "seq": {"flash_attention": 0},
                      "cut": {"ssd_scan": 0}}
    out = capsys.readouterr().out
    assert "dist: 4 ranks on cpu rehearsal over gloo with cpu tensors" in out
    assert "experts [(0, 2), (2, 4), (4, 6), (6, 8)] of 8" in out
    assert re.search(r"leg A f32, 4 layers: TP \+ EP vs one process max "
                     r"\|diff\| \S+ \(1e-3 relative\) over all 64 positions, "
                     r"routed to one process's top-k sets; the ranks' own "
                     r"sets differ at \d+ \(token, layer\) pairs", out)
    assert "equal to one process's on every rank" in out
    assert re.search(r"worst gradient leaf \S+ at \S+ of its largest", out)
    assert re.search(r"\(2, 1\) resumed \[.*\] \(1e-5\)", out)
    assert "moe_ep on {'data': 2, 'model': 2}" in out
    assert re.search(r"leg D: StableLM 2 12B on \(data 1, model 4\): \S+ GB"
                     r" of bfloat16 parameters a rank, equal to the byte", out)
    assert re.search(r"leg D f32, 4 layers, prefill 1 x 32: TP vs one "
                     r"process max \|diff\|", out)
    assert re.search(r"leg E: .* vs one process max \|diff\| \S+ \(5e-3 "
                     r"relative\) over all positions, routed to one "
                     r"process's top-k sets", out)
    assert re.search(r"\(1, 2\) resumed \[.*\] \(1e-5\)", out)
    assert re.search(r"leg G: DeepSeek-MoE 16B as published \(moe_ep off\) "
                     r"on \(data 1, model 4\): \S+ GB of bfloat16 parameters"
                     r" a rank, equal to the byte", out)
    assert "experts [(0, 2), (2, 4), (4, 6), (6, 8)]; launches a rank" in out
    assert re.search(r"leg G f32, 4 layers: vs one process max \|diff\| \S+ "
                     r"\(1e-3 relative\) over all 64 positions, routed to "
                     r"one process's top-k sets.*greedy .* tokens equal", out)
    assert re.search(r"leg H: DeepSeek-MoE 16B with fsdp on \(data 2, model "
                     r"2\): \S+ GB of bfloat16 parameters a rank, equal to "
                     r"the byte .* vs one process max \|diff\| \S+ \(1e-3 "
                     r"relative\) at every position of every rank", out)
    assert re.search(r"leg H bf16, 3 layers, prefill 2 x 64 \(one timed\):"
                     r" .* FSDP gathers on rank 0: [1-9]\d* calls", out)
    assert re.search(r"no gathered leaf outlives its layer", out)
    assert re.search(r"leg H Jamba cut \(2 layers at full width, fsdp, "
                     r"moe_ep off\) bf16, 2 x 32: \S+ GB of parameters a "
                     r"rank, equal to the byte", out)
    assert re.search(r"leg J f32, 2 layers: keys and values a rank 8192 B "
                     r"on \(4, 1\) and 8192 B on \(2, 2\), equal to the "
                     r"byte .* \(one process 32768 B\); every step's logits"
                     r" vs one process max \|diff\| \S+ on \(4, 1\), \S+ on "
                     r"\(2, 2\) \(1e-3 relative\), on every rank", out)
    assert re.search(r"leg J bf16, 2 layers on \(data 2, model 2\): .* the "
                     r"merges on rank 0: 4 all-reduces", out)
    for key, widths in (("a", "[[[32]], [[32]], [[32]], [[32]]]"),
                        ("b", "[[[48]], [[16, 32]], [[32, 16]], [[48]]]"),
                        ("c", "[[[16, 16]], [[16, 16]], [[16, 16]], "
                              "[[16, 16]]]"),
                        ("d", None)):
        mixers = (f"columns a rank {re.escape(widths)}" if widths
                  else "no Mamba layer")
        assert re.search(
            rf"leg L \({key}\) .* float32 on \(1, 4\): .*{mixers}; prefill "
            rf"1 x 64 vs one process max "
            rf"\|diff\| \S+ \(\de-3 relative\) at every position of every "
            rf"rank .* greedy 2 x \(8 \+ 2\) tokens equal", out), key
    for shape in ("(1, 64, 1, 32)", "(1, 64, 1, 48)", "(1, 64, 2, 32)",
                  "(1, 64, 2, 16)"):
        assert re.search(rf"leg L ssd_scan at {re.escape(shape)} .* float32 "
                         rf"max \|diff\| \S+ \(5e-3\), - ms, bound",
                         out), shape
    for r in (1, 2):
        assert re.search(rf"leg L ssd_scan at \(1, 64, 2, 32\) \(ranks "
                         rf"\[\('b', {r}\)\], 16 zero columns\)", out)
    assert re.search(r"leg L: \S+ s in the one process, \S+ s in the ranks",
                     out)
    assert re.search(r"leg I f32, TinyLlama 2 layers with fsdp, 4 x 16 on "
                     r"\(2, 2\): .* optimizer state \S+ MB a rank, 0\.2\d+ "
                     r"of one process's; greedy tokens equal .* \(2, 1\) "
                     r"resumed \[.*\] \(1e-5\)", out)


def smoke_split_configs():
    """Leg K's models at SMOKE size on 4 ranks: musicgen SMOKE (6 heads of
    8: 1.5 heads a rank on (1, 4)) in float32 and bfloat16, xlstm SMOKE
    with 1 head of 64 (a quarter of a head a rank on (1, 4), half on (2,
    2)), at short sequences."""
    import dataclasses

    from repro_torch.configs import get_config
    mg = get_config("musicgen-medium", smoke=True)
    return {"mg_f32": mg, "mg_bf16": dataclasses.replace(mg,
                                                         dtype=torch.bfloat16),
            "xl_f32": dataclasses.replace(get_config("xlstm-125m", smoke=True),
                                          n_heads=1, n_kv_heads=1),
            "prefill": 64, "xl_seq": 32, "prompt": 1, "new": 4, "world": 4,
            "mg_layers": get_config("musicgen-medium").n_layers}


def test_split_phase_rehearses_on_the_cpu(cs, monkeypatch, capsys):
    """Leg K at SMOKE size in 4 gloo ranks on the CPU: musicgen's float32
    forward with its columns cutting a head, against one process at every
    position on every rank, its greedy tokens, each rank's parameter bytes
    the reference's specs' and its keys and values the 2 kv heads it
    computes (4/3 of the specs'); the bfloat16 forward with its head
    gathers counted; xlstm's quarter and half heads on (1, 4) and (2, 2),
    each rank's rows against one process, its tokens, and its mLSTM C the
    specs' bytes; no launch (CPU tensors run the plain versions)."""
    import sys

    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.setattr(cs, "split_configs", smoke_split_configs)
    counts = cs.split_phase(torch.device("cpu"), "cpu rehearsal")
    assert counts == {"flash_attention": 0}
    out = capsys.readouterr().out
    assert "split: leg K, 4 ranks on cpu rehearsal over gloo with cpu " \
        "tensors" in out
    assert re.search(r"leg K: musicgen-smoke \(d 48, 6 heads of 8, MHA\) on "
                     r"\(data 1, model 4\): 12 columns a rank, 1\.5 heads, 2 "
                     r"heads computed a rank \(8 for 6\); parameters a rank "
                     r"equal to the byte", out)
    assert re.search(r"leg K f32, 2 layers, prefill of 1 x 64 seeded frame "
                     r"embeddings: vs one process max \|diff\| \S+ \(1e-3 "
                     r"relative\) on every rank; flash_attention 0 launches "
                     r"a rank; greedy 1 x \(1 \+ 4\) tokens equal .* 2 of 6 kv "
                     r"heads whole: 1\.3333 x the reference's cache specs'",
                     out)
    assert re.search(r"leg K bf16, 2 of 48 layers, prefill 1 x 64: .* the "
                     r"head gathers on rank 0: 2 calls, ", out)
    assert re.search(r"leg K xlstm-smoke f32, 4 layers on \(data 1, model 4\)"
                     r": 16 columns a rank in 1 of 1 heads of 64 \(0\.25 of a "
                     r"head\); prefill 2 x 32 a rank: each mLSTM layer vs "
                     r"one process max \|diff\| \S+ \(1e-3 relative\), the "
                     r"stack's logits \S+ relative \(not held: .*\); head "
                     r"gathers of the prefill on rank 0 3 calls", out)
    assert re.search(r"leg K xlstm-smoke f32, 4 layers on \(data 2, model 2\)"
                     r": 32 columns a rank in 1 of 1 heads of 64 \(0\.5 of a "
                     r"head\); prefill 1 x 32", out)


def test_routing_tape_replays_top_k_sets(cs):
    """``routing_tape``: a recorded tape replayed into the same model gives
    the same logits bit for bit and no flipped set; a tape with every
    token sent to other experts changes the logits, and each replayed
    call counts all its tokens as flipped, by a positive margin; a tape
    of the wrong length fails."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config("deepseek-moe-16b", smoke=True)
    model = transformer.init(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 16),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        with cs.routing_tape() as tape:
            want, _ = transformer.forward(model, cfg, toks)
        assert len(tape) and all(t.shape == (16, cfg.moe_top_k)
                                 for t in tape)
        with cs.routing_tape(tape) as flips:
            got, _ = transformer.forward(model, cfg, toks)
        assert torch.equal(got, want) and cs.flipped(flips) == (0, 0.0)
        # each token's K experts outside its recorded set
        other = [torch.zeros(len(t), cfg.moe_experts).scatter(1, t, 1.0)
                 .argsort(dim=-1, stable=True)[:, :cfg.moe_top_k]
                 for t in tape]
        assert all(not set(a.tolist()) & set(b.tolist())
                   for t, o in zip(tape, other) for a, b in zip(t, o))
        with cs.routing_tape(other) as flips:
            got, _ = transformer.forward(model, cfg, toks)
        assert not torch.allclose(got, want)
        n, margin = cs.flipped(flips)
        assert n == 16 * len(tape) and margin > 0
        with pytest.raises(AssertionError):
            with cs.routing_tape(tape + tape[:1]):
                transformer.forward(model, cfg, toks)


def test_dryrun_phase_rehearses_on_the_cpu(cs, monkeypatch, capsys):
    """The dryrun phase at its real cells, whose traces hold no memory
    (meta): leg a's three CLI processes, their records read back and held
    to the reference's parameter specs; leg a', the spec lever tp1 on
    TinyLlama's train_4k and decode_32k (parameters the stripped specs',
    the decode cell fitting 80 GB with 16 times the cache specs' keys and
    values) and dp_all's refusal of prefill_32k's batch; legs b and b'
    as children on the meta device, their parameter, gradient,
    optimizer-state and cache bytes the traces' (the card's peak is not
    measured here); and the examples phase's processes started with
    them (on the CPU here, ``--device cpu``), each to its check line."""
    import sys

    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    cmds = cs.example_cmds
    monkeypatch.setattr(cs, "example_cmds",
                        lambda dev: cmds(torch.device("cpu")))
    cs.dryrun_phase(torch.device("meta"), "cpu rehearsal", examples=True)
    out = capsys.readouterr().out
    assert re.search(r"dryrun: 8 processes \(legs a, a', b, b'\) and the "
                     r"examples at once: \S+ s .*; each process's seconds: "
                     r"tinyllama-1\.1b train_4k \S+, .* tinyllama-1\.1b "
                     r"train_4k --opt tp1 \S+, .* leg b \S+, leg b' \S+$",
                     out, re.M)
    for name, check in cs.EXAMPLES.items():
        assert re.search(rf"  examples/{name}\.py on meta: exit 0 at \S+ s "
                         rf"from the start: " + re.escape(check), out), name
    assert re.search(r"tinyllama-1\.1b x train_4k x 16x16: peak \S+ GB a "
                     r"rank \(fits 80 GB: True; parameters 0\.138, gradients "
                     r"0\.138, optimizer 0\.826", out)
    assert re.search(r"deepseek-moe-16b x prefill_32k x 2x16x16: .* "
                     r"all-gather 1 x 419\.4 MB, all-reduce 165 x", out)
    assert "keys and values a rank 377487360 B, its 1/16 of the positions " \
        "of 1 of 8 kv heads: 0.1250 x the reference's cache specs'" in out
    assert re.search(r"leg b: tinyllama-1\.1b x train_4k rank 0 on meta, "
                     r"one step in \S+ s: parameters 137678848 B, gradients "
                     r"137678848 B, optimizer state 826073092 B, cache 0 B, "
                     r"equal to the meta trace's to the byte; the trace's "
                     r"peak \S+ GB; the card's not measured", out)
    # leg a': tp1, every "model" dimension whole (2.2 GB of bfloat16)
    assert re.search(r"tinyllama-1\.1b x train_4k x 16x16 --opt tp1: peak "
                     r"\S+ GB a rank \(fits 80 GB: False; parameters 2\.200, "
                     r"15\.9799 x the specs' with 'model'; .*collectives "
                     r"180, all-reduce 180 x 2200\.1 MB;", out)
    assert re.search(r"tinyllama-1\.1b x decode_32k x 16x16 --opt tp1: peak "
                     r"\S+ GB a rank \(fits 80 GB: True; .*collectives 0; "
                     r"keys and values a rank 5905580032 B, every kv head of "
                     r"its rows: 16\.0000 x the reference's cache specs' "
                     r"369098752 B", out)
    assert "tinyllama-1.1b x prefill_32k x 16x16 --opt dp_all: refused, " \
        "exit 1: [dryrun] tinyllama-1.1b × prefill_32k × 16x16: FAIL batch " \
        "32 does not split over 256 ranks of ('data', 'model')" in out
    # leg b': the tp1 decode cell's rank, the cell whose record fits
    assert re.search(r"leg b': tinyllama-1\.1b x decode_32k --opt tp1 rank 0 "
                     r"on meta, one step in \S+ s: parameters 2200096768 B, "
                     r"gradients 0 B, optimizer state 0 B, cache 5905580736 "
                     r"B, equal to the meta trace's to the byte; the trace's "
                     r"peak \S+ GB; the card's not measured", out)


def test_dryrun_child_picks_its_leg(cs):
    """The children's cells: leg b the first cell as published, leg b'
    the tp1 decode cell (picked because its record fits 80 GB: the tp1
    train_4k rank does not, 153 GB)."""
    assert cs.DRYRUN_CHILDREN == {"b": (cs.DRYRUN_CELLS[0], ()),
                                  "b'": (cs.DRYRUN_TP1[1], ("tp1",))}
    assert cs.DRYRUN_TP1[1][1] == "decode_32k"
    assert cs.dryrun_cmd("d", cs.DRYRUN_TP1[0], ("tp1",))[-2:] == \
        ["--opt", "tp1"]
    assert cs.dryrun_path("d", cs.DRYRUN_TP1[0], ("tp1",)) == os.path.join(
        "d", "opt-tp1_tinyllama-1.1b_train_4k_16x16.json")


def test_examples_phase_rehearses_on_the_cpu(cs, monkeypatch, capsys):
    """The examples phase: the quickstart and serve_decode scripts, each
    a process of its own started as a user starts it, on the CPU here
    (``--device cpu``) at their own arguments, each to its check line; a
    script that misses its line or exits non-zero fails the phase.  The
    other three examples are not run on the card
    (tests/test_torch_examples.py runs all five on the CPU)."""
    assert set(cs.EXAMPLES) == {"torch_quickstart", "torch_serve_decode"}
    assert set(cs.EXAMPLES) <= {os.path.basename(p)[:-3] for p in
                                (ROOT / "examples").glob("torch_*.py")}
    cs.examples_phase(torch.device("cpu"))
    out = capsys.readouterr().out
    for name, check in cs.EXAMPLES.items():
        assert re.search(rf"  examples/{name}\.py on cpu: exit 0 at \S+ s "
                         rf"from the start: " + re.escape(check), out), name
    monkeypatch.setattr(cs, "EXAMPLES",
                        {"torch_quickstart": "a line it never prints"})
    with pytest.raises(AssertionError, match="torch_quickstart"):
        cs.examples_phase(torch.device("cpu"))
    # a script that exits non-zero (argparse refusing an argument)
    cmds = cs.example_cmds
    monkeypatch.setattr(cs, "example_cmds", lambda dev: [
        c + ["--banks", "many"] for c in cmds(dev)])
    with pytest.raises(AssertionError, match="torch_quickstart"):
        cs.examples_phase(torch.device("cpu"))


def test_run_together_starts_every_command_at_once(cs):
    """The dryrun phase's launcher: every command started at once (two
    sleeps of two seconds both end before four), each command's exit code,
    output and seconds from the start, in the commands' order."""
    import sys

    sleep = [sys.executable, "-c", "import time; time.sleep(2); print('a')"]
    outs = cs.run_together([sleep, sleep,
                            [sys.executable, "-c", "import sys; sys.exit(3)"]],
                           dict(os.environ))
    assert [(rc, out.strip()) for rc, out, _, _ in outs] == [(0, "a"),
                                                              (0, "a"),
                                                              (3, "")]
    assert 2.0 <= outs[0][3] and max(o[3] for o in outs) < 4.0
