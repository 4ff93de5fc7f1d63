"""Port parity: the session façade ``repro_torch.pim`` against ``repro.pim``.

The cases of tests/test_session.py, and the shed and expiry counting
cases of tests/test_serving.py, each run on a port session (``device="cpu"``) and
on a reference session over its one in-process bank with the same inputs:
both must give the same results (under the registry's comparator) and the
same records and counters.  All 16 workloads are served; NW and BFS fall
back to their serialized ``pim()`` as in the reference.  RED stands in for
VA in the lifecycle and QoS cases, as it did before VA was ported.  Every
``result()`` and join has a timeout.
"""
import threading
import time
import warnings
import zlib

import numpy as np
import pytest
import torch

from repro import pim as jpim
from repro.runtime import TunedPlan as JPlan
from repro.runtime import TuningResult as JTuning
from repro.runtime.elastic import RankAllocator as JAllocator
from repro.runtime.qos import TenantState as JTenant
from repro_torch import make_bank_grid
from repro_torch import pim as tpim
from repro_torch.runtime import TunedPlan as TPlan
from repro_torch.runtime import TuningResult as TTuning
from repro_torch.runtime.elastic import RankAllocator as TAllocator
from repro_torch.runtime.qos import TenantState as TTenant
from repro_torch.prim.registry import PIPELINEABLE
from repro_torch.runtime.qos import resolve_options

# the whole suite runs in 6 pytest workers on 8 cores: two intra-op threads
# a worker keep these modules from starving the reference's timing-gated tests
torch.set_num_threads(2)

PORTED = ("VA", "GEMV", "GEMV-B", "GEMV-G", "SpMV", "SEL", "UNI", "BS", "TS",
          "BFS", "MLP", "NW", "HST", "RED", "SCAN", "TRNS")


def red_args(rng, n=4096):
    return (rng.integers(0, 99, n).astype(np.int32),)


def red_ref(args):
    return args[0].sum()


@pytest.fixture()
def pair(bank_grid):
    """(port session, reference session), both closed afterwards."""
    sessions = []

    def make(**kw):
        shape = {k: kw.pop(k) for k in ("banks", "ranks", "banks_per_rank")
                 if k in kw} or {"banks": 1}
        t = tpim.session(device="cpu", **shape, **kw)
        j = jpim.PimSession(grid=bank_grid, **kw)
        sessions.extend((t, j))
        return t, j
    yield make
    for s in sessions:
        s.close()


def record_view(rec) -> tuple:
    return (rec.workload, rec.n_items, rec.bytes_in, rec.bytes_out,
            rec.n_chunks, rec.n_ranks, rec.cache_hit, rec.tenant,
            rec.priority, rec.tuned, rec.predicted_overlap)


# -- allocation ---------------------------------------------------------------

def test_session_factory_allocates_and_closes():
    s = tpim.session(banks=4, device="cpu")
    assert s.n_banks == 4 and not s.closed and s.grid.device.type == "cpu"
    assert "open" in repr(s) and "4 banks" in repr(s)
    s.close()
    assert s.closed and "closed" in repr(s)


def test_session_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpim.session(banks=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpim.session(ranks=2, banks_per_rank=2)
    tpim.session(banks=2, device="cpu").close()


def test_ranked_session_shape():
    s = tpim.session(ranks=2, banks_per_rank=4, device="cpu")
    assert (s.n_ranks, s.banks_per_rank, s.n_banks) == (2, 4, 8)
    assert "2x4 ranks x banks" in repr(s)
    s.close()
    with pytest.raises(ValueError):
        tpim.session(banks=6, ranks=4, device="cpu")
    with pytest.raises(ValueError):
        tpim.session(banks_per_rank=4, device="cpu")


def test_grid_and_banks_are_mutually_exclusive():
    g = make_bank_grid(1, device="cpu")
    for kw in (dict(banks=1), dict(device="cpu")):
        with pytest.raises(ValueError):
            tpim.PimSession(grid=g, **kw)
    s = tpim.PimSession(grid=g)
    assert s.grid is g
    s.close()


def test_workload_view_is_the_reference_order_subset(pair):
    t, j = pair()
    assert t.workloads == tuple(n for n in j.workloads if n in PORTED)
    assert set(tpim.registry()) == set(PORTED)


def test_session_autotune_installs_plans(pair):
    t, j = pair()
    kw = dict(scale=1, reps=2, probe=False, calib_nbytes=(1 << 14, 1 << 16))
    result = t.autotune(["VA"], **kw)
    assert set(result.plans) == {"VA"} == set(j.autotune(["VA"], **kw).plans)
    assert t.plans["VA"] is result.plans["VA"]
    assert t.tuning is result


@pytest.mark.parametrize("autotune", [
    {"scale": 1, "reps": 1, "probe": False, "calib_nbytes": (1 << 12,)},
    {"entries": ["RED", "GEMV"], "reps": 1, "probe": True,
     "calib_nbytes": (1 << 12, 1 << 14)}])
def test_session_autotune_option_installs_plans(autotune, rng):
    s = tpim.session(banks=2, device="cpu", autotune=autotune)
    try:
        want = set(autotune.get("entries", PIPELINEABLE))
        assert set(s.plans) == want == set(s.tuning.plans)
        args = red_args(rng)
        assert s.run("RED", *args) == red_ref(args)
        assert s.telemetry.records[-1].tuned
        if autotune["probe"]:
            assert all(p.measured_s for p in s.plans.values())
    finally:
        s.close()


# -- lifecycle (dpu_free semantics) -------------------------------------------

def test_double_close_is_noop():
    s = tpim.session(banks=1, device="cpu")
    s.close()
    s.close()
    assert s.closed


def test_verbs_after_close_raise(rng):
    s = tpim.session(banks=1, device="cpu")
    a = red_args(rng)
    s.close()
    for verb in (lambda: s.submit("RED", *a),
                 lambda: s.run("RED", *a),
                 lambda: s.map("RED", [a]),
                 lambda: s.transfer_in(a[0]),
                 lambda: s.transfer_out(a[0]),
                 lambda: s.drain(),
                 lambda: s.start(),
                 lambda: s.pin("GEMV"),
                 lambda: s.unpin("x"),
                 lambda: s.autotune(["RED"])):
        with pytest.raises(RuntimeError, match="closed PimSession"):
            verb()


def test_close_drains_pending_futures(pair, rng):
    a = red_args(rng)
    outs = []
    for s in pair():
        req = s.submit("RED", *a)
        assert not req.done()
        s.close()
        assert req.done()
        outs.append(req.result(timeout=0))
    assert outs[0] == outs[1] == red_ref(a)


def test_context_manager_serves_and_closes(rng):
    a = red_args(rng, 1 << 16)
    with tpim.session(banks=4, device="cpu") as s:
        assert "serving" in repr(s) and s.serving
        reqs = [s.submit("RED", *a) for _ in range(3)]
        for r in reqs:
            assert r.result(timeout=60) == red_ref(a)
        with pytest.raises(RuntimeError, match="drain"):
            s.drain()
    assert s.closed
    with pytest.raises(RuntimeError):
        s.submit("RED", *a)


# -- launch verbs -------------------------------------------------------------

_REFERENCE_RUNS: dict = {}


def _reference_run(j, name, args):
    """The reference session's first ``run`` of ``name``: its output, its
    record's view and its request count.  A serialized-only workload's is
    kept for the other shapes: the reference's BFS ``pim`` takes ~15 s a
    call on the CPU."""
    if name in _REFERENCE_RUNS:
        return _REFERENCE_RUNS[name]
    out = j.run(name, *args)
    (rec,) = j.telemetry.records
    got = (out, record_view(rec), j.stats()["requests"])
    if name not in PIPELINEABLE:
        _REFERENCE_RUNS[name] = got
    return got


@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("shape", [dict(banks=1), dict(banks=8),
                                   dict(ranks=2, banks_per_rank=4)])
def test_run_matches_reference_and_records(pair, name, shape):
    """Each workload on the port at 1 bank, 8 banks and 2 x 4 against the
    reference at its one bank: the same values and dtype, the same
    records (the rank count apart), and — for the resident workloads —
    the same after ``pin`` on a warm hit."""
    entry = tpim.registry()[name]
    args = entry.make_args(np.random.default_rng(zlib.crc32(name.encode())), 1)
    t, j = pair(**shape)
    tout = t.run(name, *args)
    jout, jview, jrequests = _reference_run(j, name, args)
    entry.compare(tout, entry.ref(*args))
    entry.compare(tout, jout)
    assert np.asarray(tout).dtype == np.asarray(jout).dtype
    (trec,) = t.telemetry.records
    # a serialized-only workload shards no chunks across ranks
    assert trec.n_ranks == (shape.get("ranks", 1) if entry.pipelineable
                            else 1)
    assert record_view(trec)[:5] + record_view(trec)[6:] == (
        jview[:5] + jview[6:])
    assert t.stats()["requests"] == jrequests == 1
    if entry.resident:
        t.pin(name, *args)
        j.pin(name, *args)
        tout, jout = t.run(name, *args), j.run(name, *args)
        assert t.telemetry.records[-1].cache_hit
        assert j.telemetry.records[-1].cache_hit
        entry.compare(tout, jout)
        entry.compare(tout, entry.ref(*args))


@pytest.mark.parametrize("shape", [dict(banks=8), dict(ranks=2, banks_per_rank=4)])
def test_run_matches_ref_registry_wide(shape):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s = tpim.session(device="cpu", **shape)
    try:
        for name, entry in tpim.registry().items():
            rng = np.random.default_rng(zlib.crc32(name.encode()))
            args = entry.make_args(rng, scale=2)
            entry.compare(s.run(name, *args), entry.ref(*args))
        assert len(s.telemetry.records) == len(tpim.registry())
        assert {r.n_ranks for r in s.telemetry.records
                if r.workload in PIPELINEABLE} == {shape.get("ranks", 1)}
        assert {r.n_ranks for r in s.telemetry.records
                if r.workload not in PIPELINEABLE} == {1}
    finally:
        s.close()


def test_run_sync_records_telemetry(pair, rng):
    a = rng.integers(0, 99, 4096).astype(np.int32)
    recs = []
    for s in pair():
        np.testing.assert_array_equal(s.run("VA", a, a), a + a)
        (rec,) = s.telemetry.records
        assert rec.workload == "VA" and rec.n_chunks >= 1
        assert s.stats()["requests"] == 1
        recs.append(record_view(rec))
    assert recs[0] == recs[1]


def test_run_serialized_only_fallback(pair, rng):
    """NW/BFS have no chunked form: ``run`` picks the serialized ``pim()``
    from the registry, on the port as on the reference."""
    from repro_torch import prim
    s1 = rng.integers(0, 4, 48).astype(np.int32)
    s2 = rng.integers(0, 4, 40).astype(np.int32)
    adj = prim.bfs.random_graph(101, 3, seed=7)
    t, j = pair(banks=8)
    for name, args, want in (("NW", (s1, s2), prim.nw.ref(s1, s2)),
                             ("BFS", (adj, 0), prim.bfs.ref(adj, 0))):
        tout, jout = t.run(name, *args), j.run(name, *args)
        np.testing.assert_array_equal(tout, want)
        np.testing.assert_array_equal(tout, jout)
        assert tout.dtype == jout.dtype
    for s in (t, j):
        recs = {r.workload: r for r in s.telemetry.records}
        assert recs["NW"].phases.total > 0 and recs["BFS"].phases.total > 0
    assert [record_view(r) for r in t.telemetry.records] == [
        record_view(r) for r in j.telemetry.records]


def test_run_unknown_workload_raises(pair):
    t, j = pair()
    for s in (t, j):
        with pytest.raises(KeyError, match="FFT"):
            s.run("FFT", np.zeros(4))


def test_map_streams_in_order(pair, rng):
    streams = [red_args(rng, 1000 + i) for i in range(4)]
    t, j = pair()
    touts, jouts = t.map("RED", streams), j.map("RED", streams)
    assert [int(o) for o in touts] == [int(o) for o in jouts] == [
        int(red_ref(a)) for a in streams]
    assert [record_view(r) for r in t.telemetry.records] == [
        record_view(r) for r in j.telemetry.records]
    assert t.map("RED", []) == []


def test_map_serialized_only_falls_back(pair, rng):
    from repro_torch import prim
    pairs = [(rng.integers(0, 4, 32).astype(np.int32),
              rng.integers(0, 4, 32).astype(np.int32)) for _ in range(2)]
    t, j = pair(ranks=2, banks_per_rank=4)
    touts, jouts = t.map("NW", pairs), j.map("NW", pairs)
    for tout, jout, (s1, s2) in zip(touts, jouts, pairs):
        np.testing.assert_array_equal(tout, prim.nw.ref(s1, s2))
        np.testing.assert_array_equal(tout, jout)
    assert len(t.telemetry.records) == len(j.telemetry.records) == 2


def test_map_while_serving_goes_through_worker(rng):
    a, b = red_args(rng), red_args(rng)
    with tpim.session(banks=2, device="cpu") as s:
        outs = s.map("RED", [a, b])
    assert outs == [red_ref(a), red_ref(b)]


# -- error propagation --------------------------------------------------------

def test_future_error_propagates_deterministic(pair, rng):
    A = rng.normal(size=(16, 8)).astype(np.float32)
    for s in pair():
        bad = s.submit("GEMV", A, np.ones(5, np.float32))  # shape mismatch
        good = s.submit("GEMV", A, np.ones(8, np.float32))
        s.drain()
        with pytest.raises(Exception):
            bad.result(timeout=5)
        assert good.result(timeout=5).shape == (16,)


def test_future_error_propagates_serving(rng):
    A = rng.normal(size=(16, 8)).astype(np.float32)
    with tpim.session(banks=2, device="cpu") as s:
        bad = s.submit("GEMV", A, np.ones(5, np.float32))
        with pytest.raises(Exception):
            bad.result(timeout=60)
    assert s.closed


def test_run_raises_inline(pair, rng):
    for s in pair():
        with pytest.raises(Exception):
            s.run("GEMV", rng.normal(size=(4, 4)).astype(np.float32),
                  np.ones(5, np.float32))


# -- transfers ----------------------------------------------------------------

def test_transfer_roundtrip_and_broadcast(rng):
    s = tpim.session(banks=4, device="cpu")
    try:
        x = rng.integers(0, 99, 8 * s.n_banks).astype(np.int32)
        np.testing.assert_array_equal(s.transfer_out(s.transfer_in(x)), x)
        v = rng.normal(size=16).astype(np.float32)
        np.testing.assert_allclose(
            s.transfer_out(s.transfer_in(v, broadcast=True)), v)
        with pytest.raises(ValueError, match="bank axis"):
            s.transfer_in(x, "P(banks)")
    finally:
        s.close()


# -- plans --------------------------------------------------------------------

def test_plans_accessor_and_tuned_serving(bank_grid, rng):
    kw = dict(workload="RED", n_chunks=2, max_batch_requests=3,
              predicted_serialized_s=1.0, predicted_pipelined_s=0.5,
              predicted_overlap=2.0)
    t = tpim.session(banks=1, device="cpu", plans={"RED": TPlan(**kw)})
    j = jpim.PimSession(grid=bank_grid, plans={"RED": JPlan(**kw)})
    a = red_args(rng)
    try:
        assert t.plans == {"RED": TPlan(**kw)} and t.tuning is None
        assert t.run("RED", *a) == j.run("RED", *a) == red_ref(a)
        (trec,), (jrec,) = t.telemetry.records, j.telemetry.records
    finally:
        t.close()
        j.close()
    assert trec.tuned and trec.n_chunks == 2 and trec.predicted_overlap == 2.0
    assert record_view(trec) == record_view(jrec)


def test_session_accepts_tuning_result(rng):
    plan = TPlan(workload="RED", n_chunks=3, max_batch_requests=8,
                 predicted_serialized_s=1.0, predicted_pipelined_s=0.5,
                 predicted_overlap=2.0)
    tuning = TTuning(stages={}, profiles={}, plans={"RED": plan})
    assert TTuning.from_dict(tuning.as_dict()).plans["RED"] == plan
    assert (TTuning.from_dict(tuning.as_dict()).as_dict()
            == JTuning.from_dict(tuning.as_dict()).as_dict())
    s = tpim.session(banks=2, device="cpu", plans=tuning)
    try:
        assert s.tuning is tuning and s.plans["RED"].n_chunks == 3
        rec = s.submit("RED", *red_args(rng)).record
        s.drain()
        assert rec.n_chunks == 3
    finally:
        s.close()


# -- operand residency through the façade -------------------------------------

def test_stats_reports_cache_counters(pair, rng):
    entry = tpim.registry()["GEMV"]
    args = entry.make_args(rng, 1)
    outs = []
    for s in pair():
        s.run("GEMV", *args)
        s.run("GEMV", *args)
        outs.append(s.stats())
    tout, jout = outs
    assert tout["cache"]["hits"] == 1 and tout["cache"]["misses"] == 1
    assert {k: v for k, v in tout["cache"].items() if k != "budget_bytes"} == {
        k: v for k, v in jout["cache"].items() if k != "budget_bytes"}
    for k in ("cache_hits", "cache_misses", "cache_resident_bytes"):
        assert tout["counters"][k] == jout["counters"][k], k
    assert tout["cache_hits"] == jout["cache_hits"] == 1


def test_budget_is_the_mram_model():
    s = tpim.session(ranks=32, banks_per_rank=64, device="cpu")
    try:
        assert s.cache.budget_bytes == 64 << 30     # 2,048 x 64 MB / 2
    finally:
        s.close()


def test_resident_false_disables_cache(rng):
    s = tpim.session(banks=2, device="cpu", resident=False)
    entry = tpim.registry()["GEMV"]
    args = entry.make_args(rng, 1)
    try:
        assert s.cache is None
        for _ in range(2):
            entry.compare(s.run("GEMV", *args), entry.ref(*args))
        assert "cache" not in s.stats()
        with pytest.raises(RuntimeError, match="resident=False"):
            s.pin("GEMV", *args)
        assert s.unpin("anything") is False
    finally:
        s.close()


def test_close_releases_resident_operands(rng):
    entry = tpim.registry()["SpMV"]
    args = entry.make_args(rng, 1)
    s = tpim.session(banks=2, device="cpu")
    s.run("SpMV", *args)
    assert len(s.cache) == 1 and s.cache.resident_bytes > 0
    s.close()
    assert len(s.cache) == 0 and s.cache.resident_bytes == 0


def test_cache_spans_start_stop_cycles(rng):
    entry = tpim.registry()["GEMV"]
    args = entry.make_args(rng, 1)
    s = tpim.session(banks=2, device="cpu")
    try:
        s.run("GEMV", *args)
        s.start()
        entry.compare(s.submit("GEMV", *args).result(timeout=60),
                      entry.ref(*args))
        assert s.cache.stats()["hits"] == 1
    finally:
        s.close()


@pytest.mark.parametrize("shape", [dict(banks=4), dict(ranks=2, banks_per_rank=2)])
def test_pin_then_warm_runs_scatter_nothing(shape):
    entry = tpim.registry()["SpMV"]
    args = entry.make_args(np.random.default_rng(4), 1)
    s = tpim.session(device="cpu", trace=True, **shape)
    try:
        fp = s.pin("SpMV", *args)
        assert s.cache.lookup(fp).ready and s.cache.lookup(fp).pinned
        pushed = sum(sp.name == "scatter" for sp in s.tracer.spans)
        for _ in range(2):
            entry.compare(s.run("SpMV", *args), entry.ref(*args))
            assert s.telemetry.records[-1].cache_hit
        assert sum(sp.name == "scatter" for sp in s.tracer.spans) == pushed
        chunks = 4 * s.n_ranks                     # per request
        assert sum(sp.name == "scatter:cached"
                   for sp in s.tracer.spans) == 2 * chunks
    finally:
        s.close()


# -- the QoS surface and shed / expiry counting (tests/test_serving.py) -------

def test_request_options_validation():
    assert tpim.RequestOptions().tenant == "default"
    for kw in (dict(deadline_s=0.0), dict(deadline_s=-1.0), dict(weight=0.0)):
        with pytest.raises(ValueError):
            tpim.RequestOptions(**kw)


def test_legacy_priority_shim_warns_and_maps():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        opts = resolve_options(priority=3)
    assert opts == tpim.RequestOptions(priority=3)
    assert len(w) == 1 and issubclass(w[0].category, DeprecationWarning)
    with pytest.raises(ValueError, match="not both"):
        resolve_options(tpim.RequestOptions(priority=1), priority=2)


def test_session_verbs_accept_options_and_shim(rng):
    s = tpim.session(banks=2, device="cpu")
    a = red_args(rng)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            req = s.submit("RED", *a, options=tpim.RequestOptions(tenant="t1"))
            out = s.run("RED", *a, options=tpim.RequestOptions(priority=2))
            outs = s.map("RED", [a], options=tpim.RequestOptions(tenant="t1"))
        assert req.result(timeout=0) == out == outs[0] == red_ref(a)
        assert req.record.tenant == "t1"
        with pytest.deprecated_call():
            s.run("RED", *a, priority=1)
    finally:
        s.close()


def test_map_direct_path_stamps_tenant(pair, rng):
    a = red_args(rng)
    for s in pair():
        opts = type(s).__module__.startswith("repro_torch")
        opts = (tpim if opts else jpim).RequestOptions(tenant="mapper")
        s.map("RED", [a, a], options=opts)
        assert [r.tenant for r in s.telemetry.snapshot_records()] == [
            "mapper", "mapper"]
        assert s.stats()["tenants"]["mapper"]["completed"] == 2


def test_expired_request_counted_and_raised(pair, rng):
    a = red_args(rng)
    stats = []
    for s in pair():
        mod = tpim if type(s).__module__.startswith("repro_torch") else jpim
        req = s.submit("RED", *a, options=mod.RequestOptions(
            tenant="t", deadline_s=0.01))
        time.sleep(0.05)
        assert s.drain() == 0
        with pytest.raises(mod.DeadlineExpired) as ei:
            req.result(timeout=0)
        assert ei.value.tenant == "t" and ei.value.late_s > 0
        st = s.stats()
        stats.append((st["expired"], st["tenants"]["t"]["expired"],
                      st["counters"].get("expired")))
    assert stats[0] == stats[1] == (1, 1, 1)


def test_shed_reject_raises_and_counts(pair, rng):
    a = red_args(rng)
    stats = []
    for s in pair(max_queue_depth=2, shed="reject"):
        mod = tpim if type(s).__module__.startswith("repro_torch") else jpim
        keep = [s.submit("RED", *a) for _ in range(2)]
        with pytest.raises(mod.QueueFull) as ei:
            s.submit("RED", *a)
        assert ei.value.max_depth == 2
        s.drain()
        assert [r.result(timeout=0) for r in keep] == [red_ref(a)] * 2
        st = s.stats()
        stats.append((st["shed"], st["tenants"]["default"]["shed"]))
    assert stats[0] == stats[1] == (1, 1)


def test_shed_drop_evicts_least_urgent(rng):
    s = tpim.session(banks=1, device="cpu", max_queue_depth=2, shed="drop")
    a = red_args(rng)
    try:
        victim = s.submit("RED", *a, options=tpim.RequestOptions(priority=0))
        keeper = s.submit("RED", *a, options=tpim.RequestOptions(priority=5))
        newcomer = s.submit("RED", *a, options=tpim.RequestOptions(priority=3))
        assert victim.done()
        with pytest.raises(tpim.QueueFull):
            victim.result(timeout=0)
        s.drain()
        assert keeper.result(timeout=0) == newcomer.result(timeout=0)
        s.submit("RED", *a, options=tpim.RequestOptions(priority=5))
        s.submit("RED", *a, options=tpim.RequestOptions(priority=5))
        with pytest.raises(tpim.QueueFull):
            s.submit("RED", *a, options=tpim.RequestOptions(priority=-1))
        assert s.stats()["shed"] == 2
    finally:
        s.close()


def test_shed_block_applies_backpressure(rng):
    s = tpim.session(banks=1, device="cpu", max_queue_depth=2, shed=False)
    s.start()
    a = red_args(rng)
    try:
        reqs, errs = [], []

        def submitter():
            try:
                reqs.extend(s.submit("RED", *a) for _ in range(10))
            except Exception as e:           # noqa: BLE001 — asserted below
                errs.append(e)

        t = threading.Thread(target=submitter)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive() and not errs
        assert [r.result(timeout=60) for r in reqs] == [red_ref(a)] * 10
        assert s.stats()["shed"] == 0
    finally:
        s.close()


def test_close_drains_full_queue(rng):
    s = tpim.session(banks=1, device="cpu", max_queue_depth=4, shed="reject")
    a = red_args(rng)
    reqs = [s.submit("RED", *a) for _ in range(4)]
    with pytest.raises(tpim.QueueFull):
        s.submit("RED", *a)
    s.close()
    assert [r.result(timeout=0) for r in reqs] == [red_ref(a)] * 4


def test_serving_mode_close_drains_full_queue(rng):
    a = red_args(rng)
    with tpim.session(banks=1, device="cpu", max_queue_depth=4,
                      shed="reject") as s:
        reqs = []
        for _ in range(12):
            try:
                reqs.append(s.submit("RED", *a))
            except tpim.QueueFull:
                pass
    assert reqs and all(r.result(timeout=0) == red_ref(a) for r in reqs)


def test_bad_depth_and_policy_rejected():
    for kw in (dict(max_queue_depth=0), dict(policy="lifo"),
               dict(shed="maybe")):
        with pytest.raises(ValueError):
            tpim.session(banks=1, device="cpu", **kw)


def test_two_tenants_serving_block(rng):
    """The smoke script's serving block at CPU size: 8 submits over two
    tenants at weights 2:1 on a ranked grid, each checked."""
    with tpim.session(ranks=2, banks_per_rank=2, device="cpu",
                      tenants={"gold": 2.0, "free": 1.0}) as s:
        reqs = [(a, s.submit("RED", *a, options=tpim.RequestOptions(
            tenant=("gold", "free")[i % 2])))
            for i, a in enumerate(red_args(rng) for _ in range(8))]
        for a, r in reqs:
            assert r.result(timeout=60) == red_ref(a)
        tenants = s.stats()["tenants"]
    assert {t: tenants[t]["completed"] for t in ("gold", "free")} == {
        "gold": 4, "free": 4}
    assert tenants["gold"]["weight"] == 2.0


def test_rank_allocator_and_tenant_state_match_reference():
    for alloc in (TAllocator(8), JAllocator(8)):
        alloc.update({"a": 300.0, "b": 100.0})
        assert alloc.ranks_for("a", {"a": 1.0, "b": 1.0}) == 6
        alloc.on_straggle()
        assert alloc.cap == 4 and alloc.ranks_for("a", {}) == 4
        alloc.relax()
        assert alloc.cap == 5
    for t in (TTenant("x", 2.0), JTenant("x", 2.0)):
        assert t.charge(1.0) == 0.5
        t.activate(3.0)
        assert t.vtime == 3.0
