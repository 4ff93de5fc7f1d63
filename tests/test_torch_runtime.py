"""Port parity: the runtime beneath the session (``repro_torch.runtime``)
against ``repro.runtime``.

* the chunk pipeline: pipelined == serialized == ``ref()`` for every
  registry entry, flat at 8 banks and ranked at 2 x 4, and equal to the
  reference's pipeline at its one in-process bank;
* the residency battery of tests/test_resident.py: fingerprints equal to
  the reference's for the same bytes (numpy, tensors, pytrees, handles),
  LRU order and counters, leases, dead entries, warm hits, pin / unpin,
  budgets, host mutation, and leases released when a request fails;
* tracing: the same request sequence gives the same span names,
  categories and tracks in both packages;
* telemetry and metrics: the same ``stats()`` keys, the same percentiles.

The port runs on ``device="cpu"``, where the pipeline's stages run in
order without streams; the streams themselves are exercised on the card
in tests/test_torch_gpu.py.  Every thread join here has a timeout.
"""
import threading
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pim as jpim
from repro.runtime import metrics as jmetrics
from repro.runtime import pipeline as jpipe
from repro.runtime import resident as jres
from repro.runtime import trace as jtrace
from repro_torch import make_bank_grid, make_rank_grid
from repro_torch import pim as tpim
from repro_torch.runtime import metrics as tmetrics
from repro_torch.runtime import pipeline as tpipe
from repro_torch.runtime import resident as tres
from repro_torch.runtime import trace as ttrace
from repro_torch.runtime.telemetry import RequestRecord, Telemetry

NAMES = ("GEMV", "SpMV", "HST", "RED", "SCAN")
GEMV_NBYTES = 512 * 256 * 4


@pytest.fixture(autouse=True)
def _clean_tracers():
    """Both packages start from their disabled default tracer."""
    pj = jtrace.set_tracer(jtrace.NULL_TRACER)
    pt = ttrace.set_tracer(ttrace.NULL_TRACER)
    yield
    jtrace.set_tracer(pj)
    ttrace.set_tracer(pt)


def args_for(name: str, scale: int = 1):
    entry = tpim.registry()[name]
    return entry, entry.make_args(np.random.default_rng(
        zlib.crc32(name.encode())), scale)


def port_session(**kw):
    return tpim.session(device="cpu", **kw)


# -- the pipeline ------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("grid", ["flat8", "ranked2x4"])
def test_pipelined_equals_serialized_and_ref(bank_grid, name, grid):
    entry, args = args_for(name)
    g = (make_bank_grid(8, device="cpu") if grid == "flat8"
         else make_rank_grid(2, 4, device="cpu"))
    serial, _ = entry.pim(g, *args)
    res = tpipe.run_pipelined_ranked(g, entry.chunked, [args, args],
                                     n_chunks=3, _full=True)
    outs, makespans, phases = res
    want = jpipe.run_pipelined(bank_grid, jpim.registry()[name].chunked,
                               *args, n_chunks=3).value
    for out in outs:
        entry.compare(out, entry.ref(*args))
        entry.compare(out, serial)
        entry.compare(out, want)
        assert np.asarray(out).dtype == np.asarray(want).dtype
    assert all(m > 0 for m in makespans) and all(p.total > 0 for p in phases)


def test_run_pipelined_result_and_records():
    entry, args = args_for("RED")
    g = make_bank_grid(4, device="cpu")
    rec = RequestRecord(request_id=7, workload="RED")
    res = tpipe.run_pipelined(g, entry.chunked, *args, n_chunks=5, record=rec)
    assert res.n_chunks == 5 and res.makespan > 0
    entry.compare(res.value, entry.ref(*args))
    assert rec.n_chunks == 5 and rec.t_finish >= rec.t_start > 0
    outs = tpipe.run_pipelined_many(g, entry.chunked, [args] * 3, n_chunks=2)
    assert len(outs) == 3


@pytest.mark.parametrize("want,plan_ranks,have", [
    (None, None, 4), (2, None, 4), (8, None, 4), (None, 2, 4), (None, None, 1)])
def test_resolve_ranks_matches_reference(want, plan_ranks, have):
    from repro.runtime.autotune import TunedPlan as JPlan
    from repro_torch.runtime.autotune import TunedPlan as TPlan

    def plan(cls):
        if plan_ranks is None:
            return None
        return cls("RED", 4, 8, 1.0, 0.5, 2.0, n_ranks=plan_ranks)

    class G:
        n_ranks = have
    assert (tpipe._resolve_ranks(G, want, plan(TPlan))
            == jpipe._resolve_ranks(G, want, plan(JPlan)))


# -- fingerprints --------------------------------------------------------------------

def _payloads():
    a = np.arange(64, dtype=np.int32)
    ws = [np.ones((4, 4), np.float32), np.zeros((2, 4), np.float32)]
    return {
        "array": (a,),
        "strided": (np.arange(128, dtype=np.int32)[::2],),
        "int64": (a.astype(np.int64),),
        "reshaped": (a.reshape(8, 8),),
        "pytree list": (ws,),
        "pytree dict": ({"w": ws[0], "b": ws[1], "skip": None},),
        "two items": (a, ws[0]),
    }


@pytest.mark.parametrize("name", sorted(_payloads()))
@pytest.mark.parametrize("placement", [(8, 1, 4), (8, 2, 8)])
def test_fingerprint_equals_reference(name, placement):
    payload = _payloads()[name]
    want = jres.fingerprint("X", payload, placement)
    assert tres.fingerprint("X", payload, placement) == want
    as_tensors = tuple(_tensors(p) for p in payload)
    assert tres.fingerprint("X", as_tensors, placement) == want
    handles = tuple(tres.ResidentHandle(p) for p in payload)
    assert tres.fingerprint("X", handles, placement) == want


def _tensors(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return tree


def test_content_digest_refuses_bfloat16_like_reference():
    """The reference cannot take a bfloat16 leaf's buffer; neither does
    the port (no invented digest for bytes the reference never keys)."""
    x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    with pytest.raises(ValueError):
        jres.content_digest(jnp.asarray(x, jnp.bfloat16))
    with pytest.raises(TypeError):
        tres.content_digest(torch.from_numpy(x).to(torch.bfloat16))


def test_fingerprint_keys_content_dtype_shape_placement():
    a = np.arange(64, dtype=np.int32)
    f = tres.fingerprint("X", (a,), (8, 1, 4))
    b = a.copy()
    b[0] += 1
    assert f != tres.fingerprint("X", (b,), (8, 1, 4))
    assert f != tres.fingerprint("X", (a.astype(np.int64),), (8, 1, 4))
    assert f != tres.fingerprint("X", (a.reshape(8, 8),), (8, 1, 4))
    assert f != tres.fingerprint("X", (a,), (8, 2, 8))
    assert f != tres.fingerprint("Y", (a,), (8, 1, 4))


def test_unwrap_handles_nested():
    a = np.ones(3, np.float32)
    h = tres.ResidentHandle(a)
    out = tres.unwrap_handles((h, {"w": h, "b": [h, None]}, a))
    assert out[0] is a and out[1]["w"] is a and out[1]["b"][0] is a
    assert out[1]["b"][1] is None and out[2] is a


# -- the cache ---------------------------------------------------------------------

def test_cache_lru_eviction_order_and_counters():
    wl = tpim.registry()["GEMV"].chunked
    x = np.ones(4, np.float32)
    mats = [np.full((16, 4), i, np.float32) for i in range(3)]
    place = (1, 1, 2)
    fps = [tres.fingerprint("GEMV", (m,), place) for m in mats]
    cache = tres.ResidentCache(budget_bytes=512)
    for m in mats[:2]:
        e, hit = cache.acquire(wl, (m, x), place)
        assert not hit and not e.ready
        e.set_rank_meta(0, {}, n_chunks=0)
        assert e.ready and not e.chunk_resident
        cache.release(e)
    eh, hit = cache.acquire(wl, (mats[0], x), place)     # hit, to MRU
    assert hit
    cache.release(eh)
    e2, hit = cache.acquire(wl, (mats[2], x), place)     # evicts mats[1]
    assert not hit and e2 is not None
    cache.release(e2)
    assert cache.lookup(fps[1]) is None and cache.lookup(fps[0]) is not None
    st = cache.stats()
    assert (st["hits"], st["misses"], st["evictions"]) == (1, 3, 1)
    assert st["entries"] == 2 and st["resident_bytes"] == 512


def test_acquire_leases_block_eviction_and_failed_reservation_keeps_cache():
    wl = tpim.registry()["GEMV"].chunked
    x = np.ones(4, np.float32)
    m0, m1 = (np.full((16, 4), i, np.float32) for i in range(2))
    cache = tres.ResidentCache(budget_bytes=256)
    e0, _ = cache.acquire(wl, (m0, x), (1, 1, 2))
    e0.set_rank_meta(0, {}, n_chunks=0)
    assert cache.acquire(wl, (m1, x), (1, 1, 2)) == (None, False)  # leased
    assert len(cache) == 1 and cache.resident_bytes == 256
    cache.release(e0)
    e1, _ = cache.acquire(wl, (m1, x), (1, 1, 2))
    assert e1 is not None and e0.released and cache.stats()["evictions"] == 1


def test_store_into_released_entry_is_noop():
    wl = tpim.registry()["GEMV"].chunked
    cache = tres.ResidentCache(budget_bytes=1 << 20)
    ent, _ = cache.acquire(wl, (np.zeros((16, 4), np.float32),
                                np.ones(4, np.float32)), (1, 1, 2))
    ent.set_rank_meta(0, {"m": 1}, n_chunks=1)
    cache.clear()
    assert ent.released
    ent.store(0, object())
    assert ent.get(0) is None and not ent.ready
    assert ent.set_rank_meta(0, {"m": 2}, n_chunks=1) == {"m": 2}
    assert ent.rank_meta(0) is None


@pytest.mark.parametrize("name", ["GEMV", "SpMV"])
@pytest.mark.parametrize("shape", [dict(banks=8), dict(ranks=2, banks_per_rank=4)])
def test_warm_hit_bit_identical_and_counted_like_reference(bank_grid, name,
                                                           shape):
    entry, args = args_for(name)
    s = port_session(**shape)
    r = jpim.PimSession(grid=bank_grid)
    try:
        cold, warm = s.run(name, *args), s.run(name, *args)
        jcold, jwarm = r.run(name, *args), r.run(name, *args)
        cs, jcs = s.stats()["cache"], r.stats()["cache"]
        recs = list(s.telemetry.records)
    finally:
        s.close()
        r.close()
    entry.compare(cold, entry.ref(*args))
    entry.compare(cold, jcold)
    np.testing.assert_array_equal(np.asarray(cold), np.asarray(warm))
    for k in ("hits", "misses", "entries", "evictions", "resident_bytes"):
        assert cs[k] == jcs[k], k
    assert not recs[0].cache_hit and recs[1].cache_hit


def test_eviction_pin_unpin_like_reference(bank_grid):
    """The tight-budget and pin sequences of tests/test_resident.py, run on
    both packages: the same results and the same counters."""
    entry, (a1, x) = args_for("GEMV")
    a2 = np.random.default_rng(2).normal(size=a1.shape).astype(np.float32)
    seen = []
    for sess in (port_session(banks=1, resident=GEMV_NBYTES + 1024),
                 jpim.PimSession(grid=bank_grid, resident=GEMV_NBYTES + 1024)):
        try:
            outs = [sess.run("GEMV", a, x) for a in (a1, a2, a1)]
            after_evictions = dict(sess.stats()["cache"])
            fp = sess.pin("GEMV", a2, x)     # a2 resident: pin marks it
            outs.append(sess.run("GEMV", a1, x))  # uncacheable under the pin
            assert sess.cache.lookup(fp) is not None
            assert sess.unpin(fp) and not sess.unpin("nope")
            outs.append(sess.run("GEMV", a1, x))  # now displaces a2
            assert sess.cache.lookup(fp) is None
            seen.append((outs, after_evictions, dict(sess.stats()["cache"])))
        finally:
            sess.close()
    (touts, tcs0, tcs1), (jouts, jcs0, jcs1) = seen
    for t, j, a in zip(touts, jouts, (a1, a2, a1, a1, a1)):
        entry.compare(t, entry.ref(a, x))
        entry.compare(t, j)
    assert tcs0 == jcs0 and tcs1 == jcs1
    assert (tcs0["evictions"], tcs0["hits"]) == (2, 0)


def test_pin_rejects_non_resident_and_over_budget():
    s = port_session(banks=1, resident=1024)
    try:
        _, red = args_for("RED")
        with pytest.raises(ValueError, match="no resident operand"):
            s.pin("RED", *red)
        _, gemv = args_for("GEMV")
        with pytest.raises(RuntimeError, match="residency budget"):
            s.pin("GEMV", *gemv)
    finally:
        s.close()


def test_host_mutation_misses_like_reference(bank_grid):
    counters = []
    for sess in (port_session(banks=2), jpim.PimSession(grid=bank_grid)):
        entry, (a, x) = args_for("GEMV")
        a = a.copy()
        try:
            entry.compare(sess.run("GEMV", a, x), entry.ref(a, x))
            a[0, :] += 1.0
            entry.compare(sess.run("GEMV", a, x), entry.ref(a, x))
            counters.append(sess.stats()["cache"])
        finally:
            sess.close()
    assert counters[0]["hits"] == counters[1]["hits"] == 0
    assert counters[0]["misses"] == counters[1]["misses"] == 2


def test_resident_handle_shares_the_raw_arrays_entry():
    entry, (a, x) = args_for("GEMV")
    s = port_session(banks=2)
    try:
        s.run("GEMV", a, x)
        out = s.run("GEMV", tpim.ResidentHandle(a), x)
        entry.compare(out, entry.ref(a, x))
        assert s.stats()["cache"]["hits"] == 1 and len(s.cache) == 1
    finally:
        s.close()


@pytest.mark.parametrize("ranks", [1, 2])
def test_leases_released_when_a_request_fails(bank_grid, ranks):
    """A GEMV whose vector has the wrong length fails in compute; the
    entry it acquired must not stay leased (else it is unevictable)."""
    entry, (a, _) = args_for("GEMV")
    s = (port_session(banks=4) if ranks == 1
         else port_session(ranks=2, banks_per_rank=2))
    r = jpim.PimSession(grid=bank_grid)
    try:
        for sess in (s, r):
            with pytest.raises(Exception):
                sess.run("GEMV", a, np.ones(5, np.float32))
            ents = list(sess.cache._entries.values())
            assert ents and all(e.leases == 0 for e in ents)
    finally:
        s.close()
        r.close()


def test_concurrent_submits_same_fingerprint_scatter_once():
    entry, args = args_for("GEMV")
    s = port_session(banks=2, trace=True)
    try:
        s.start()
        reqs, errs = [], []

        def submit():
            try:
                reqs.append(s.submit("GEMV", *args))
            except Exception as e:           # noqa: BLE001 — asserted below
                errs.append(e)

        ts = [threading.Thread(target=submit) for _ in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not errs
        for req in reqs:
            entry.compare(req.result(timeout=60), entry.ref(*args))
        pushes = [sp for sp in s.tracer.spans
                  if sp.name == "scatter" and sp.args["workload"] == "GEMV"]
    finally:
        s.close()
    assert len(pushes) == 4                  # each of the 4 chunks once


# -- tracing -----------------------------------------------------------------------

def _traced_sequence(sess):
    """One request sequence: cold / warm GEMV, RED, a map of two SCANs, a
    submitted HST drained, one shed-free serve.  Returns the spans."""
    for name in ("GEMV", "GEMV", "RED"):
        _, args = args_for(name)
        sess.run(name, *args)
    _, scan = args_for("SCAN")
    sess.map("SCAN", [scan, scan])
    _, hst = args_for("HST")
    sess.submit("HST", *hst)
    sess.drain()
    return list(sess.tracer.spans)


def test_trace_spans_match_reference(bank_grid):
    s = port_session(banks=1, trace=True)
    r = jpim.PimSession(grid=bank_grid, trace=True)
    try:
        tspans = _traced_sequence(s)
        jspans = _traced_sequence(r)
    finally:
        s.close()
        r.close()

    def key(sp):
        tags = sp.args or {}
        return (sp.name, sp.cat, sp.track, tags.get("workload"),
                tags.get("chunk"), tags.get("bytes"))
    assert sorted(map(key, tspans), key=repr) == sorted(map(key, jspans),
                                                        key=repr)
    names = {sp.name for sp in tspans}
    assert {"scatter", "scatter:cached", "compute", "retrieve", "merge",
            "queue_wait", "batch_form", "serve", "run:GEMV",
            "map:SCAN"} <= names


def test_trace_export_and_ranked_tracks(tmp_path):
    s = port_session(ranks=2, banks_per_rank=2, trace=str(tmp_path / "t.json"))
    _, args = args_for("RED")
    s.run("RED", *args)
    s.close()
    import json
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    tracks = {ev["args"]["name"] for ev in events
              if ev["ph"] == "M" and ev["name"] == "thread_name"}
    assert {"rank-0", "rank-1", "host", "session"} <= tracks


def test_tracer_copy_behaves_as_reference():
    for mod in (ttrace, jtrace):
        tr = mod.Tracer(max_spans=4)
        for i in range(6):
            tr.emit(f"s{i}", "dpu", 0.0, 1.0, track="rank-1", chunk=i)
        assert len(tr) == 4 and tr.dropped == 2
        assert mod.NULL_TRACER.span("x") is mod.NULL_SPAN


# -- telemetry and metrics -----------------------------------------------------------

def _keys(d, depth=0):
    if not isinstance(d, dict) or depth > 3:
        return None
    return {k: _keys(v, depth + 1) for k, v in d.items()}


def test_stats_keys_match_reference(bank_grid):
    s = port_session(banks=1, tenants={"gold": 2.0})
    r = jpim.PimSession(grid=bank_grid, tenants={"gold": 2.0})
    try:
        for sess in (s, r):
            for name in ("GEMV", "GEMV", "RED"):
                _, args = args_for(name)
                sess.run(name, *args, options=jpim.RequestOptions(
                    tenant="gold") if sess is r else tpim.RequestOptions(
                        tenant="gold"))
        ts, js = s.stats(), r.stats()
        trow = s.telemetry.rows()[0]
        jrow = r.telemetry.rows()[0]
    finally:
        s.close()
        r.close()
    assert _keys(ts) == _keys(js)
    assert list(trow) == list(jrow)
    for k in ("requests", "cache_hits", "shed", "expired"):
        assert ts[k] == js[k], k


def test_histogram_percentiles_equal_reference():
    obs = np.random.default_rng(3).lognormal(-6, 2, size=500)
    th, jh = tmetrics.Histogram(), jmetrics.Histogram()
    for v in obs:
        th.observe(float(v))
        jh.observe(float(v))
    assert th.snapshot() == jh.snapshot()
    assert tmetrics.DEFAULT_BOUNDS == jmetrics.DEFAULT_BOUNDS


def test_telemetry_ring_keeps_aggregates_exact():
    tel = Telemetry(max_records=3)
    for i in range(10):
        rec = RequestRecord(request_id=i, workload="RED", t_submit=float(i),
                            t_start=i + 0.5, t_finish=i + 1.0)
        tel.record(rec)
    agg = tel.aggregate()
    assert len(tel.records) == 3 and agg["requests"] == 10
    assert agg["mean_latency_s"] == pytest.approx(1.0)
