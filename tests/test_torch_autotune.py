"""Port parity: ``repro_torch.runtime.autotune`` against
``repro.runtime.autotune`` — tests/test_autotune.py in process, on CPU
grids of the port (no subprocess, no XLA host devices).

The planner is pure arithmetic copied from the reference: ``StageFit``,
``plan_for``, ``probe_candidates``, ``prefilter_candidates`` and
``rank_candidates`` give exactly the reference's results on the same
profiles.  ``autotune`` runs end to end on VA and GEMV; on an 8-bank CPU
grid every pipelineable workload's probed plan is measured no slower at
its adopted chunk count than at ``DEFAULT_N_CHUNKS`` and serves results
equal to ``ref()`` under the registry's comparator; ``probe_ranks`` settles
the rank count on a CPU ``RankGrid``.  Times are never compared across
packages.
"""
import dataclasses
import importlib
import json
import math

import numpy as np
import pytest
import torch

from repro.prim.registry import REGISTRY as JREG
from repro_torch import pim
from repro_torch.core.banked import make_bank_grid, make_rank_grid
from repro_torch.prim.registry import PIPELINEABLE, REGISTRY
from repro_torch.runtime import run_pipelined_many
from repro_torch.runtime.autotune import (CHUNK_CANDIDATES, DEFAULT_N_CHUNKS,
                                          StageFit, TuningResult,
                                          WorkloadProfile)
from repro_torch.runtime.scheduler import PimScheduler

# the packages' runtime exports an ``autotune`` function beside the module
jat = importlib.import_module("repro.runtime.autotune")
tat = importlib.import_module("repro_torch.runtime.autotune")

# the whole suite runs in 6 pytest workers on 8 cores: two intra-op threads
# a worker keep these modules from starving the reference's timing-gated tests
torch.set_num_threads(2)

SMALL = (1 << 12, 1 << 14)      # calibration sizes for CPU runs


def sane(fit):
    assert math.isfinite(fit.alpha_s) and fit.alpha_s >= 0
    assert math.isfinite(fit.bytes_per_s) and fit.bytes_per_s > 0


# -- the planner: the reference's arithmetic -------------------------------------

POINTS = [([100, 200, 400], [1.1, 2.1, 4.1]),
          ([100, 200, 400], [0.5, 0.5, 0.5]),
          ([100, 400], [0.5, 0.4]),
          ([1 << 18, 1 << 20, 1 << 22], [3e-4, 7e-4, 2.1e-3])]


@pytest.mark.parametrize("xs,ys", POINTS)
def test_stagefit_equals_the_reference(xs, ys):
    t, j = StageFit.from_points(xs, ys), jat.StageFit.from_points(xs, ys)
    assert t.as_dict() == j.as_dict()
    sane(t)
    assert t.time(1 << 20) == j.time(1 << 20)


def profiles(alpha, bw, serialized=0.0, bytes_in=1 << 20, bytes_out=1 << 18):
    out = []
    for mod in (tat, jat):
        push = mod.StageFit(alpha, bw)
        comp = mod.StageFit(alpha * 2, bw * 3)
        pull = mod.StageFit(alpha / 2, bw / 2)
        out.append(mod.WorkloadProfile("X", bytes_in, bytes_out, push=push,
                                       compute=comp, pull=pull,
                                       serialized_s=serialized))
    return out


PROFILES = [(0.0, 1e6), (1.0, 1e12), (1e-4, 1e8), (3e-5, 9e9),
            (1e-4, 1e8, 123.0), (2e-3, 1e10, 0.05)]


@pytest.mark.parametrize("prof", PROFILES, ids=str)
@pytest.mark.parametrize("warm", [False, True])
def test_plan_for_equals_the_reference(prof, warm):
    t, j = profiles(*prof)
    tp, jp = tat.plan_for(t, warm=warm), jat.plan_for(j, warm=warm)
    assert tp.as_dict() == jp.as_dict()
    assert tat.probe_candidates(tp) == jat.probe_candidates(jp)
    for k in (1, 2, 3):
        assert tat.probe_candidates(tp, k=k) == jat.probe_candidates(jp, k=k)
    assert DEFAULT_N_CHUNKS in tat.probe_candidates(tp)
    assert tp.n_chunks in tat.probe_candidates(tp)
    assert t.as_dict() == j.as_dict()
    for c in CHUNK_CANDIDATES:
        assert t.pipeline_time(c) == j.pipeline_time(c)
        assert t.warm_pipeline_time(c) == j.warm_pipeline_time(c)


@pytest.mark.parametrize("model_s", [
    {}, {1: 10.0, 2: 10.0, 4: 10.0, 8: 0.1, 16: 10.0},
    {c: float(c) for c in CHUNK_CANDIDATES}, {1: 10.0, 4: 0.2, 8: 0.1}])
def test_prefilter_candidates_equal_the_reference(model_s):
    t, j = profiles(1e-4, 1e8)
    tp = dataclasses.replace(tat.plan_for(t), model_candidate_s=model_s)
    jp = dataclasses.replace(jat.plan_for(j), model_candidate_s=model_s)
    for slack in (0.0, 0.25, 10.0):
        assert tat.prefilter_candidates(tp, slack=slack) == \
            jat.prefilter_candidates(jp, slack=slack)


def test_constants_and_rank_candidates_equal_the_reference():
    assert (tat.CHUNK_CANDIDATES, tat.MAX_BATCH_REQUESTS,
            tat.FILL_OVERHEAD_TARGET, tat.PREFILTER_SLACK,
            tat.DEFAULT_N_CHUNKS) == (
        jat.CHUNK_CANDIDATES, jat.MAX_BATCH_REQUESTS,
        jat.FILL_OVERHEAD_TARGET, jat.PREFILTER_SLACK, jat.DEFAULT_N_CHUNKS)
    for n in (1, 6, 32):
        assert tat.rank_candidates(n) == jat.rank_candidates(n)
    assert tat.rank_candidates(32) == [1, 2, 4, 8, 16, 32]


def test_plan_json_crosses_packages():
    t, _ = profiles(1e-4, 1e8, 0.5)
    plan = tat.plan_for(t, warm=True)
    via_ref = jat.TunedPlan.from_dict(json.loads(json.dumps(plan.as_dict())))
    assert via_ref.as_dict() == plan.as_dict()


# -- calibration and autotune on CPU grids ------------------------------------------

def test_calibrate_fits_finite_positive():
    stages = tat.calibrate(make_bank_grid(2, device="cpu"), nbytes=SMALL,
                           reps=2)
    assert set(stages) == {"push", "compute", "pull"}
    for fit in stages.values():
        sane(fit)


def test_autotune_va_gemv():
    res = tat.autotune(make_bank_grid(1, device="cpu"),
                       [REGISTRY["VA"], REGISTRY["GEMV"]], scale=1, reps=2,
                       calib_nbytes=SMALL)
    assert set(res.plans) == {"VA", "GEMV"}
    for name, plan in res.plans.items():
        prof = res.profiles[name]
        for stage in (prof.push, prof.compute, prof.pull):
            sane(stage)
        assert prof.bytes_in > 0 and prof.serialized_s > 0
        assert plan.n_chunks >= 1 and plan.max_batch_requests >= 1
        assert math.isfinite(plan.predicted_overlap)
        assert plan.predicted_overlap > 0
        assert not plan.measured_s                    # probe=False
    assert res.plans["GEMV"].warm_n_chunks > 0        # chunk-resident
    assert res.plans["VA"].warm_n_chunks == 0
    assert res.rank_sweep == []
    d = res.as_dict()
    assert TuningResult.from_dict(json.loads(json.dumps(d))).as_dict() == d


def test_profile_workload_bytes_match_the_reference(bank_grid, rng):
    """Same payload bytes as the reference's profile of the same arguments
    (the fits are times, not compared)."""
    for name in ("VA", "GEMV", "MLP", "BS"):
        args = REGISTRY[name].make_args(rng, 1)
        t = tat.profile_workload(make_bank_grid(1, device="cpu"),
                                 REGISTRY[name], args, reps=1)
        j = jat.profile_workload(bank_grid, JREG[name], args, reps=1)
        assert (t.workload, t.bytes_in, t.bytes_out) == (
            j.workload, j.bytes_in, j.bytes_out)
        assert isinstance(t, WorkloadProfile) and t.serialized_s > 0


@pytest.fixture(scope="module")
def eight_banks():
    return make_bank_grid(8, device="cpu")


@pytest.mark.parametrize("name", PIPELINEABLE)
def test_tuned_beats_or_ties_default_8_banks(eight_banks, name):
    """The reference's invariant, for every pipelineable workload: the
    probed plan's adopted chunk count is measured no slower than the
    untuned default, and serving under it matches ref()."""
    entry = REGISTRY[name]
    args = entry.make_args(np.random.default_rng(0), 1)
    prof = tat.profile_workload(eight_banks, entry, args, reps=1)
    plan = tat.plan_for(prof)
    probed = tat.probe_plan(eight_banks, entry, plan, [args, args])
    assert DEFAULT_N_CHUNKS in probed.measured_s
    assert probed.measured_s[probed.n_chunks] <= \
        probed.measured_s[DEFAULT_N_CHUNKS]
    assert probed.n_chunks == min(probed.measured_s,
                                  key=lambda c: (probed.measured_s[c], c))
    gold = entry.ref(*args)
    for out in run_pipelined_many(eight_banks, entry.chunked, [args, args],
                                  plan=probed):
        entry.compare(out, gold)


def test_probe_ranks_on_a_cpu_rank_grid(rng):
    g = make_rank_grid(4, 2, device="cpu")
    entry = REGISTRY["RED"]
    args = entry.make_args(rng, 1)
    plan = tat.plan_for(tat.profile_workload(g, entry, args, reps=1))
    ranked = tat.probe_ranks(g, entry, plan, [args])
    assert set(ranked.rank_measured_s) == {1, 2, 4}
    assert ranked.n_ranks == min(ranked.rank_measured_s,
                                 key=lambda r: (ranked.rank_measured_s[r], r))
    scripted = tat.probe_ranks(g, entry, plan, [args],
                               runner=lambda r: {1: 3.0, 2: 1.0, 4: 2.0}[r])
    assert scripted.n_ranks == 2
    flat = make_bank_grid(8, device="cpu")
    assert tat.probe_ranks(flat, entry, plan, [args]) is plan


def test_autotune_on_a_rank_grid_probes_ranks():
    g = make_rank_grid(2, 2, device="cpu")
    res = tat.autotune(g, [REGISTRY["SCAN"]], scale=1, reps=1, probe=True,
                       calib_nbytes=SMALL)
    plan = res.plans["SCAN"]
    assert set(plan.rank_measured_s) == {1, 2}
    assert [r["ranks"] for r in res.rank_sweep] == [1, 2]
    assert DEFAULT_N_CHUNKS in plan.measured_s


def test_autotune_with_a_cost_model_prefilters_and_stamps():
    from repro_torch.core.costmodel import CostModel
    g = make_bank_grid(4, device="cpu")
    cm = CostModel.calibrate(g, op_nbytes=SMALL, xfer_nbytes=SMALL, reps=1)
    res = tat.autotune(g, [REGISTRY["VA"], REGISTRY["GEMV"]], scale=1,
                       reps=1, probe=True, cost_model=cm, calib_nbytes=SMALL)
    universe = set(CHUNK_CANDIDATES) | {1, DEFAULT_N_CHUNKS}
    for plan in res.plans.values():
        assert set(plan.model_candidate_s) == set(CHUNK_CANDIDATES)
        assert set(plan.predicted_stage_s) == {"cpu_dpu", "dpu", "dpu_cpu"}
        assert DEFAULT_N_CHUNKS in plan.measured_s
        assert set(plan.measured_s) <= universe
        best = min(plan.measured_s, key=lambda c: (plan.measured_s[c], c))
        assert plan.n_chunks == best


def test_scheduler_autotuned_serves_tuned(monkeypatch, rng):
    g = make_bank_grid(2, device="cpu")
    calls = []
    real = tat.autotune

    def few(grid, entries=None, **kw):
        calls.append(kw)
        return real(grid, [REGISTRY["RED"]], reps=1, calib_nbytes=SMALL,
                    **kw)
    monkeypatch.setattr(tat, "autotune", few)
    sched = PimScheduler.autotuned(g, scale=1)
    assert calls == [{"scale": 1, "probe": True}]
    assert set(sched.plans) == {"RED"}
    args = REGISTRY["RED"].make_args(rng, 1)
    req = sched.submit("RED", *args)
    sched.drain()
    assert req.result() == REGISTRY["RED"].ref(*args)
    assert req.record.tuned


def test_session_serves_every_pipelineable_workload_tuned():
    with pim.session(banks=4, device="cpu",
                     autotune={"scale": 1, "reps": 1, "probe": False,
                               "calib_nbytes": SMALL}) as s:
        assert set(s.plans) == set(PIPELINEABLE)
        rng = np.random.default_rng(3)
        for name in PIPELINEABLE:
            entry = REGISTRY[name]
            args = entry.make_args(rng, 1)
            entry.compare(s.run(name, *args), entry.ref(*args))
            assert s.telemetry.records[-1].tuned
