"""Port parity: ``repro_torch.core.costmodel`` against
``repro.core.costmodel``.

* The fit and pricing layer is a copy of the reference's: on the same
  synthetic rows ``CostModel.fit`` / ``predict`` / ``candidate_predictions``
  / ``roofline_rows`` agree to 1e-12 relative, and profiles and models
  round-trip through JSON from either package into the other.
* ``count_ops`` replaces the reference's jaxpr walk.  For every
  pipelineable registry entry at scale 1 on 1 bank its table equals the
  reference's ``cost_profile``, except where jnp and aten break an op down
  differently (``DIFFERENCES``: SpMV's index guard, SEL / UNI / BS / TS /
  HST's compares, selects and scans); each such (op, dtype) is listed with
  both counts, and the totals stay within a factor of ``TOTAL_FACTOR``
  per workload and ``SUITE_FACTOR`` over the suite.
* The reference counts per bank; so does the port (whole bank axis over
  ``n_banks``): RED, VA and GEMV at 2 and 4 banks give the reference's
  per-bank counts measured on 2 XLA host devices.
"""
import json
import math

import numpy as np
import pytest
import torch

from repro.core import costmodel as jcm
from repro.prim.registry import REGISTRY as JREG
from repro.runtime.autotune import TunedPlan as JPlan
from repro_torch.core import characterize
from repro_torch.core import costmodel as tcm
from repro_torch.core.banked import make_bank_grid
from repro_torch.prim.registry import REGISTRY, PIPELINEABLE
from repro_torch.runtime.autotune import (DEFAULT_N_CHUNKS, TunedPlan,
                                          prefilter_candidates,
                                          probe_candidates)

# the whole suite runs in 6 pytest workers on 8 cores: two intra-op threads
# a worker keep these modules from starving the reference's timing-gated tests
torch.set_num_threads(2)

REL = 1e-12

#: (op, dtype) -> (reference count, port count) where the two break an
#: operation down differently, at scale 1 on 1 bank
DIFFERENCES = {
    "SpMV": {("add", "int32"): (4096, 0), ("cmp", "int32"): (16384, 8192)},
    "SEL": {("add", "int32"): (262144, 131072),
            ("cmp", "int32"): (720899, 262144)},
    "UNI": {("add", "int32"): (196608, 131072),
            ("cmp", "int32"): (393216, 262144)},
    "BS": {("add", "int32"): (12288, 131072),
           ("cmp", "int32"): (45057, 524288),
           ("div", "int32"): (8192, 65536), ("sub", "int32"): (4096, 0)},
    "TS": {("add", "float"): (2105537, 532481),
           ("add", "int32"): (1048577, 0),
           ("cmp", "float"): (24577, 16384),
           ("cmp", "int32"): (1056772, 0),
           ("div", "float"): (565316, 532544),
           ("mul", "float"): (1048640, 524288),
           ("sub", "float"): (1572994, 1048640)},
    "HST": {("add", "int32"): (65537, 0), ("cmp", "int32"): (262144, 65536)},
}
TOTAL_FACTOR = 16     # BS: the port's fixed 16-step search, the reference's
                      # while body counted once (a 10.4x gap)
SUITE_FACTOR = 2

#: the reference's per-bank counts at scale 1 on 2 XLA host devices
PER_BANK_2 = {"RED": {("add", "int32"): 32768},
              "VA": {("add", "int32"): 32768},
              "GEMV": {("mul", "float"): 65536, ("add", "float"): 65280}}


@pytest.fixture(scope="module")
def tgrid():
    return make_bank_grid(1, device="cpu")


# -- scalar helpers ----------------------------------------------------------------

@pytest.mark.parametrize("ratios", [[], [2.0, 8.0], [3.0], [1.0, 1.5, 7.25]])
def test_geomean_ratio_matches(ratios):
    assert tcm.geomean_ratio(ratios) == jcm.geomean_ratio(ratios)


@pytest.mark.parametrize("np_dt,torch_dt", [
    (np.float32, torch.float32), (np.float64, torch.float64),
    (np.int32, torch.int32), (np.int8, torch.int8), (np.uint8, torch.uint8),
    (np.int64, torch.int64), (np.bool_, torch.bool),
    (np.float16, torch.float16)])
def test_canon_dtype_matches_for_numpy_and_torch(np_dt, torch_dt):
    want = jcm.canon_dtype(np_dt)
    assert tcm.canon_dtype(np_dt) == want
    assert tcm.canon_dtype(torch_dt) == want
    assert tcm.canon_dtype(torch.bfloat16) == "float"


# -- the copied fit / pricing layer ------------------------------------------------

def synthetic_rows():
    """Exact affine measurements: t = issue + n * per_op, L = setup + n / bw."""
    op_rows = [{"op": op, "dtype": dt, "elements": n,
                "seconds": 1e-5 + n * per * (2 if dt == "float" else 1)}
               for op, per in (("add", 1e-9), ("mul", 4e-9), ("div", 9e-9))
               for dt in ("int32", "float") for n in (1_000, 100_000)]
    xfer_rows = [{"nbytes": n, "push_s": 2e-5 + n / 6.68e9,
                  "pull_s": 3e-5 + n / 4.74e9}
                 for n in (1 << 18, 1 << 20, 1 << 22)]
    return op_rows, xfer_rows


def models(n_banks=8):
    op_rows, xfer_rows = synthetic_rows()
    return (jcm.CostModel.fit(op_rows, xfer_rows, n_banks=n_banks),
            tcm.CostModel.fit(op_rows, xfer_rows, n_banks=n_banks))


PROFILE = dict(workload="X", bytes_in=1 << 20, bytes_out=1 << 18,
               op_counts={("add", "int32"): 1e6, ("mul", "float"): 2e5,
                          ("cmp", "int32"): 3e5, ("div", "int64"): 7e3},
               n_banks=8, source="test")


def close_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            close_tree(a[k], b[k])
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=REL, abs=0.0)
    else:
        assert a == b


def test_fit_equals_the_reference():
    j, t = models()
    close_tree(j.as_dict(), t.as_dict())


def test_fit_degenerate_slope_guard_equals_the_reference():
    flat = [{"op": "add", "dtype": "int32", "elements": n, "seconds": 1e-4}
            for n in (1_000, 100_000)]
    _, xfer = synthetic_rows()
    xfer_flat = [dict(r, push_s=5e-5, pull_s=5e-5) for r in xfer]
    close_tree(jcm.CostModel.fit(flat, xfer_flat, 8).as_dict(),
               tcm.CostModel.fit(flat, xfer_flat, 8).as_dict())


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("knobs", [{}, {"banks_x": 4.0}, {"problem_x": 2.5},
                                   {"xfer_bw_x": 3.0}])
def test_predict_equals_the_reference(n_chunks, knobs):
    j, t = models()
    jp = j.predict(jcm.CostProfile(**PROFILE), n_chunks, **knobs)
    tp = t.predict(tcm.CostProfile(**PROFILE), n_chunks, **knobs)
    close_tree(jp.as_dict(), tp.as_dict())


def test_candidate_predictions_and_predict_plan_equal_the_reference():
    j, t = models()
    cand = [1, 2, 3, 4, 6, 8, 12, 16]
    jt = j.candidate_predictions(jcm.CostProfile(**PROFILE), cand)
    tt = t.candidate_predictions(tcm.CostProfile(**PROFILE), cand)
    assert set(jt) == set(tt) == set(cand)
    for c in cand:
        assert tt[c] == pytest.approx(jt[c], rel=REL, abs=0.0)
    plan = dict(workload="X", n_chunks=6, max_batch_requests=8,
                predicted_serialized_s=1.0, predicted_pipelined_s=0.5,
                predicted_overlap=2.0)
    close_tree(j.predict_plan(jcm.CostProfile(**PROFILE),
                              JPlan(**plan)).as_dict(),
               t.predict_plan(tcm.CostProfile(**PROFILE),
                              TunedPlan(**plan)).as_dict())


def test_op_cost_and_instructions_equal_the_reference():
    j, t = models()
    for op in ("add", "sub", "mul", "div", "cmp"):
        for dt in ("int32", "int64", "float", "double"):
            jc, tc = j.op_cost(op, dt), t.op_cost(op, dt)
            assert tc.per_op_s == pytest.approx(jc.per_op_s, rel=REL)
            assert tc.issue_s == pytest.approx(jc.issue_s, rel=REL)
    assert t.instructions(tcm.CostProfile(**PROFILE)) == \
        j.instructions(jcm.CostProfile(**PROFILE))


def test_roofline_rows_equal_the_reference():
    j, t = models()
    empty = dict(PROFILE, workload="L", op_counts={})
    jr = jcm.roofline_rows(j, [jcm.CostProfile(**PROFILE),
                               jcm.CostProfile(**empty)])
    tr = tcm.roofline_rows(t, [tcm.CostProfile(**PROFILE),
                               tcm.CostProfile(**empty)])
    assert [r["workload"] for r in tr] == ["X"]
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        assert list(a) == list(b)
        close_tree(a, b)


def test_profile_scaled_and_retyped_equal_the_reference():
    jp, tp = jcm.CostProfile(**PROFILE), tcm.CostProfile(**PROFILE)
    assert tp.scaled(4.0).as_dict() == jp.scaled(4.0).as_dict()
    for dt in ("int8", "int32", "float", "double", "bfloat16"):
        assert tp.retyped(dt).as_dict() == jp.retyped(dt).as_dict()
    assert tp.mean_itemsize() == jp.mean_itemsize()
    assert tp.total_ops == jp.total_ops


def test_energy_model_equals_the_reference():
    kw = dict(instructions=3e6, bytes_moved=1 << 22, makespan_s=1e-3,
              n_banks=64)
    assert tcm.EnergyModel().joules(**kw) == jcm.EnergyModel().joules(**kw)
    assert tcm.EnergyModel().as_dict() == jcm.EnergyModel().as_dict()


# -- JSON both ways ----------------------------------------------------------------

def test_cost_model_json_round_trips_both_ways():
    j, t = models()
    via_ref = jcm.CostModel.from_dict(json.loads(json.dumps(t.as_dict())))
    assert via_ref.as_dict() == t.as_dict()
    via_port = tcm.CostModel.from_dict(json.loads(json.dumps(j.as_dict())))
    assert via_port.as_dict() == j.as_dict()


def test_cost_profile_json_round_trips_both_ways(bank_grid, tgrid, rng):
    args = REGISTRY["GEMV"].make_args(rng, 1)
    t = REGISTRY["GEMV"].cost_profile(tgrid, args)
    j = JREG["GEMV"].cost_profile(bank_grid, args)
    via_ref = jcm.CostProfile.from_dict(json.loads(json.dumps(t.as_dict())))
    assert via_ref.as_dict() == t.as_dict()
    via_port = tcm.CostProfile.from_dict(json.loads(json.dumps(j.as_dict())))
    assert via_port.as_dict() == j.as_dict()
    assert via_port.traced and t.traced and t.source == "aten:compute"


# -- op tables against the reference -----------------------------------------------

@pytest.fixture(scope="module")
def both_profiles(bank_grid, tgrid):
    out = {}
    for name in REGISTRY:
        args = REGISTRY[name].make_args(np.random.default_rng(0), 1)
        out[name] = (JREG[name].cost_profile(bank_grid, args),
                     REGISTRY[name].cost_profile(tgrid, args))
    return out


@pytest.mark.parametrize("name", list(REGISTRY))
def test_op_table_matches_the_reference(both_profiles, name):
    j, t = both_profiles[name]
    assert (t.workload, t.bytes_in, t.bytes_out, t.n_banks) == (
        j.workload, j.bytes_in, j.bytes_out, j.n_banks)
    if name not in PIPELINEABLE:
        assert t.source == j.source == "untraced" and t.op_counts == {}
        return
    diff = DIFFERENCES.get(name, {})
    for key in set(j.op_counts) | set(t.op_counts):
        got = (j.op_counts.get(key, 0), t.op_counts.get(key, 0))
        if key in diff:
            assert got == diff[key], (name, key, got)
        else:
            assert got[1] == got[0], (name, key, got)
    for key in diff:                     # every listed difference is real
        assert key in set(j.op_counts) | set(t.op_counts), (name, key)
    if j.total_ops:
        assert 1 / TOTAL_FACTOR <= t.total_ops / j.total_ops <= TOTAL_FACTOR


def test_op_tables_total_over_the_suite(both_profiles):
    jt = sum(j.total_ops for j, _ in both_profiles.values())
    tt = sum(t.total_ops for _, t in both_profiles.values())
    assert 1 / SUITE_FACTOR <= tt / jt <= SUITE_FACTOR, (tt, jt)


@pytest.mark.parametrize("banks", [2, 4])
@pytest.mark.parametrize("name", sorted(PER_BANK_2))
def test_op_table_is_per_bank(banks, name):
    args = REGISTRY[name].make_args(np.random.default_rng(0), 1)
    prof = REGISTRY[name].cost_profile(make_bank_grid(banks, device="cpu"),
                                       args)
    want = {k: v * 2 / banks for k, v in PER_BANK_2[name].items()}
    assert prof.op_counts == want and prof.n_banks == banks


def test_cost_profile_of_a_cuda_grid_counts_on_the_cpu(tgrid, rng):
    """A grid on another device is profiled on a CPU grid of its banks:
    nothing is placed on its device."""
    from repro_torch.core.banked import BankGrid

    meta_grid = BankGrid(n_banks=2, device=torch.device("meta"))
    args = REGISTRY["RED"].make_args(rng, 1)
    prof = REGISTRY["RED"].cost_profile(meta_grid, args)
    assert prof.op_counts == {("add", "int32"): 32768.0}


# -- count_ops rules ---------------------------------------------------------------

def test_count_ops_rules():
    a = torch.ones(6, 4)
    b = torch.ones(4, 5)
    v = torch.ones(4)
    i = torch.arange(24, dtype=torch.int32).reshape(6, 4)

    def phase():
        x = a @ b                              # mm: 30*4 mul, 30*3 add
        y = a @ v                              # mv: 6*4 mul, 6*3 add
        z = (i + 1).sum(-1, dtype=torch.int32)  # 24 add, then 24 add
        c = torch.cumsum(i, 0, dtype=torch.int32)  # 24 add (input)
        m = torch.maximum(i, c) > 3            # 24 cmp, 24 cmp
        k = i.max(dim=1).values                # a reduction: 24 cmp
        w = i.reshape(4, 6).t().contiguous()   # layout: free
        return x, y, z, m, k, w

    counts, out = tcm.count_ops(phase)
    assert counts == {("mul", "float"): 144.0, ("add", "float"): 108.0,
                      ("add", "int32"): 72.0, ("cmp", "int32"): 72.0}
    assert out[0].shape == (6, 5)
    counts, _ = tcm.count_ops(lambda: torch.ones(2, 3) @ torch.ones(3, 1))
    assert counts == {("mul", "float"): 6.0, ("add", "float"): 4.0}


def test_profile_every_registry_workload_is_deterministic(tgrid, rng):
    for name, entry in REGISTRY.items():
        args = entry.make_args(rng, 1)
        prof, again = (entry.cost_profile(tgrid, args) for _ in range(2))
        assert prof == again and prof.bytes_in > 0 and prof.bytes_out > 0
        for (op, dt), n in prof.op_counts.items():
            assert op in {"add", "sub", "mul", "div", "cmp"}
            assert dt in {"int32", "int64", "float", "double"}
            assert n >= 0 and math.isfinite(n)
        restored = tcm.CostProfile.from_dict(
            json.loads(json.dumps(prof.as_dict())))
        assert restored == prof


# -- calibration on the CPU ----------------------------------------------------------

class FakeTime:
    """Deterministic stand-in for characterize's ``time`` module."""

    def __init__(self, seed=0):
        self._inc = np.random.default_rng(seed).uniform(1e-4, 2e-4, 65536)
        self._t, self._k = 0.0, 0

    def perf_counter(self):
        self._t += float(self._inc[self._k % self._inc.size])
        self._k += 1
        return self._t


def test_calibrate_deterministic_under_seeded_clock(monkeypatch):
    g = make_bank_grid(2, device="cpu")
    dicts = []
    for _ in range(2):
        monkeypatch.setattr(characterize, "time", FakeTime(seed=0))
        cm = tcm.CostModel.calibrate(g, op_nbytes=(1 << 12, 1 << 14),
                                     xfer_nbytes=(1 << 12, 1 << 14), reps=2)
        dicts.append(cm.as_dict())
    assert dicts[0] == dicts[1]
    assert cm.n_banks == 2
    assert set(cm.ops) == {(op, dt) for op in ("add", "sub", "mul", "div")
                           for dt in ("int32", "float")}
    for c in cm.ops.values():
        assert math.isfinite(c.per_op_s) and c.per_op_s > 0


# -- the autotuner's pre-filter on port plans -----------------------------------------

def prefilter_plan(model_s, cls=TunedPlan):
    return cls(workload="X", n_chunks=8, max_batch_requests=8,
               predicted_serialized_s=1.0, predicted_pipelined_s=0.5,
               predicted_overlap=2.0,
               candidate_s={1: 3.0, 2: 2.0, 4: 1.5, 8: 1.0, 16: 2.5},
               model_candidate_s=model_s)


@pytest.mark.parametrize("model_s", [
    {}, {1: 10.0, 2: 10.0, 4: 10.0, 8: 0.1, 16: 10.0},
    {1: 0.1, 2: 10.0, 4: 10.0, 8: 10.0, 16: 10.0},
    {1: 10.0, 4: 0.2, 8: 0.1}])
def test_prefilter_equals_the_reference(model_s):
    from repro.runtime.autotune import (prefilter_candidates as jpre,
                                        probe_candidates as jprobe)
    t, j = prefilter_plan(model_s), prefilter_plan(model_s, JPlan)
    assert prefilter_candidates(t) == jpre(j)
    assert probe_candidates(t) == jprobe(j)
    assert DEFAULT_N_CHUNKS in prefilter_candidates(t)
