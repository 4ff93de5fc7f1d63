"""Port parity: the 16 PrIM workloads of ``repro_torch.prim`` against
``repro.prim``.

Every ``pim`` variant runs on the port at 1 and 8 banks (``device="cpu"``)
and on the reference at its one in-process bank (Pallas kernels in
interpret mode); both must give the same values with the same dtype, and
pass the registry's ``compare`` against ``ref()``.  The chunked phases,
composed in series (split → scatter → compute → retrieve → merge), must
match the reference's same composition.  ``make_args`` must give
byte-identical arrays for the same seed, and the registry must equal the
reference's entry for entry, in its order.
"""
import functools
import zlib

import numpy as np
import pytest
import torch

from repro import prim as jprim
from repro.prim.registry import REGISTRY as JREG
from repro_torch import prim as tprim
from repro_torch.core import make_bank_grid
from repro_torch.prim.registry import (PIPELINEABLE, REGISTRY as TREG,
                                       SERIALIZED_ONLY)

# the whole suite runs in 6 pytest workers on 8 cores: two intra-op threads
# a worker keep these modules from starving the reference's timing-gated tests
torch.set_num_threads(2)

BANKS = [1, 8]


def cpu_grid(n_banks: int):
    return make_bank_grid(n_banks, device="cpu")


def same(out_t, out_j, compare):
    """Same dtype, and equal under the registry's comparator."""
    assert np.asarray(out_t).dtype == np.asarray(out_j).dtype, (
        np.asarray(out_t).dtype, np.asarray(out_j).dtype)
    assert np.asarray(out_t).shape == np.asarray(out_j).shape
    compare(out_t, out_j)


def run_both(name, tfn, jfn, bank_grid, banks, args):
    e = TREG[name]
    out_t, times = tfn(cpu_grid(banks), *args)
    out_j, _ = jfn(bank_grid, *args)
    same(out_t, out_j, e.compare)
    e.compare(out_t, e.ref(*args))
    assert times.total > 0
    return out_t


# -- serialized pim() -------------------------------------------------------------

@pytest.mark.parametrize("banks", BANKS)
@pytest.mark.parametrize("via", ["host", "fabric"])
@pytest.mark.parametrize("variant", ["single", "tree-barrier",
                                     "tree-handshake"])
def test_red_matches_reference(bank_grid, banks, via, variant):
    x = np.random.default_rng(1).integers(0, 100, 5001).astype(np.int32)
    run_both("RED", functools.partial(tprim.red.pim, via=via, variant=variant),
             functools.partial(jprim.red.pim, via=via, variant=variant),
             bank_grid, banks, (x,))


@pytest.mark.parametrize("banks", BANKS)
def test_red_plain_path_and_bad_variant(bank_grid, banks):
    x = np.random.default_rng(2).integers(0, 100, 4099).astype(np.int32)
    run_both("RED", functools.partial(tprim.red.pim, use_kernel=False),
             functools.partial(jprim.red.pim, use_kernel=False),
             bank_grid, banks, (x,))
    with pytest.raises(ValueError):
        tprim.red.pim(cpu_grid(banks), x, variant="nope")


@pytest.mark.parametrize("banks", BANKS)
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("via", ["host", "fabric"])
@pytest.mark.parametrize("variant", ["ssa", "rss"])
def test_scan_matches_reference(bank_grid, banks, use_kernel, via, variant):
    x = np.random.default_rng(3).integers(0, 10, 3001).astype(np.int32)
    name = f"pim_{variant}"
    out = run_both("SCAN",
                   functools.partial(getattr(tprim.scan, name), via=via,
                                     use_kernel=use_kernel),
                   functools.partial(getattr(jprim.scan, name), via=via,
                                     use_kernel=use_kernel),
                   bank_grid, banks, (x,))
    assert out.dtype == np.int32        # the reference's narrowed offsets


@pytest.mark.parametrize("banks", BANKS)
@pytest.mark.parametrize("variant", ["short", "long"])
@pytest.mark.parametrize("n,nbins", [(5003, 256), (777, 64)])
def test_hist_matches_reference(bank_grid, banks, variant, n, nbins):
    px = np.random.default_rng(4).integers(-3, nbins + 3, n).astype(np.int32)
    name = f"pim_{variant}"
    run_both("HST", getattr(tprim.hist, name), getattr(jprim.hist, name),
             bank_grid, banks, (px, nbins))


@pytest.mark.parametrize("banks", BANKS)
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("m,n", [(67, 33), (64, 128)])
def test_gemv_matches_reference(bank_grid, banks, use_kernel, m, n):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(m, n)).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    run_both("GEMV", functools.partial(tprim.gemv.pim, use_kernel=use_kernel),
             functools.partial(jprim.gemv.pim, use_kernel=use_kernel),
             bank_grid, banks, (a, x))


@pytest.mark.parametrize("banks", BANKS)
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("rows,ncols,nnz", [(53, 40, 6), (512, 256, 8)])
def test_spmv_matches_reference(bank_grid, banks, use_kernel, rows, ncols,
                                nnz):
    ip, ix, dv = tprim.spmv.random_csr(rows, ncols, nnz, seed=1)
    vals, cols = tprim.spmv.csr_to_ell(ip, ix, dv, rows)
    x = np.random.default_rng(7).normal(size=ncols).astype(np.float32)
    run_both("SpMV", functools.partial(tprim.spmv.pim, use_kernel=use_kernel),
             functools.partial(jprim.spmv.pim, use_kernel=use_kernel),
             bank_grid, banks, (vals, cols, x))


@pytest.mark.parametrize("banks", BANKS)
@pytest.mark.parametrize("m,n", [(67, 33), (512, 256)])
@pytest.mark.parametrize("name", ["GEMV-B", "GEMV-G"])
def test_gemv_fused_matches_reference(bank_grid, banks, name, m, n):
    """The decode engine's two matvecs: W @ x + b, and the SwiGLU gated
    hidden silu(Wg @ x) * (Wu @ x) with its silu in float32."""
    rng = np.random.default_rng(8)
    mat = lambda: rng.normal(size=(m, n)).astype(np.float32)  # noqa: E731
    w = ({"w": mat(), "b": rng.normal(size=m).astype(np.float32)}
         if name == "GEMV-B" else {"wg": mat(), "wu": mat()})
    x = rng.normal(size=n).astype(np.float32)
    suffix = name[-1].lower()
    run_both(name, getattr(tprim.gemv_fused, f"pim_{suffix}"),
             getattr(jprim.gemv_fused, f"pim_{suffix}"), bank_grid, banks,
             (w, x))
    same(TREG[name].ref(w, x), JREG[name].ref(w, x), TREG[name].compare)


def _va(rng):
    return (rng.integers(0, 99, 5001).astype(np.int32),
            rng.integers(0, 99, 5001).astype(np.int32))


def _bs(rng):
    return (np.sort(rng.integers(0, 5000, 1000)).astype(np.int32),
            rng.integers(-10, 5100, 777).astype(np.int32))


def _mlp(rng):
    return ([rng.normal(size=(67, 33)).astype(np.float32),
             rng.normal(size=(19, 67)).astype(np.float32)],
            rng.normal(size=33).astype(np.float32))


#: name -> inputs of sizes that leave padding in the last bank
NEW_ARGS = {
    "VA": _va,
    "SEL": lambda rng: (rng.integers(-50, 999, 5001).astype(np.int32),),
    "UNI": lambda rng: (np.sort(rng.integers(0, 99, 5001)).astype(np.int32),),
    "BS": _bs,
    "TS": lambda rng: (rng.normal(size=3001).astype(np.float32),
                       rng.normal(size=16).astype(np.float32)),
    "BFS": lambda rng: (tprim.bfs.random_graph(301, 3, seed=7), 5),
    "MLP": _mlp,
    "NW": lambda rng: (rng.integers(0, 4, 70).astype(np.int32),
                       rng.integers(0, 4, 45).astype(np.int32)),
    "TRNS": lambda rng: (rng.normal(size=(40, 64)).astype(np.float32),),
}


@functools.cache
def _reference_pim(name: str, which: str):
    """The reference's ``pim`` output on one of NEW_ARGS' inputs ("ragged")
    or on ``make_args`` at scale 1, once per module: its BFS and NW
    dispatch every level and diagonal anew, seconds a call."""
    args = _new_args(name, which)
    return JREG[name].pim(jprim_grid(), *args)[0]


def _new_args(name: str, which: str):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if which == "ragged":
        return NEW_ARGS[name](rng)
    return TREG[name].make_args(rng, scale=1)


@functools.cache
def jprim_grid():
    from repro.core import make_bank_grid as jgrid
    return jgrid(1)


@pytest.mark.parametrize("banks", BANKS)
@pytest.mark.parametrize("which", ["ragged", "make_args"])
@pytest.mark.parametrize("name", sorted(NEW_ARGS))
def test_workload_matches_reference(name, which, banks):
    """VA, SEL, UNI, BS, TS, BFS, MLP, NW and TRNS: each ``pim`` at sizes
    that leave padding in the last bank, and at ``make_args`` scale 1."""
    e = TREG[name]
    args = _new_args(name, which)
    out, times = e.pim(cpu_grid(banks), *args)
    same(out, _reference_pim(name, which), e.compare)
    e.compare(out, e.ref(*args))
    assert times.total > 0


@pytest.mark.parametrize("n", [10, 13])
@pytest.mark.parametrize("name", ["SEL", "UNI"])
def test_padding_past_the_last_bank(name, n):
    """With 8 banks of ceil(n / 8) slots, the padding spans more than the
    last bank: every bank's valid length is clipped into [0, per], so no
    padding counts as data."""
    x = np.arange(1, n + 1, dtype=np.int32) // 3 * 3 + 1
    for g in (cpu_grid(8), cpu_grid(5)):
        out, _ = TREG[name].pim(g, x)
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out, TREG[name].ref(x))
        got = compose(TREG[name].chunked, g, (x,), 3)
        np.testing.assert_array_equal(got, TREG[name].ref(x))


def test_random_graph_byte_equal():
    for n, deg, seed in ((301, 3, 7), (512, 4, 1), (64, 1, 0)):
        got = tprim.bfs.random_graph(n, deg, seed)
        want = jprim.bfs.random_graph(n, deg, seed)
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n", [0, 1, 2, 7, 8, 1000])
def test_binary_search_is_the_lower_bound(n):
    rng = np.random.default_rng(n)
    arr = np.sort(rng.integers(0, 50, n)).astype(np.int32)
    q = rng.integers(-5, 60, (3, 40)).astype(np.int32)
    got = tprim.bs.binary_search(torch.from_numpy(arr), torch.from_numpy(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(arr, q))


def test_ts_ref_blocks_equal_one_pass(monkeypatch):
    """``ts.ref`` evaluates its windows in blocks; the first minimum and its
    distance do not depend on the block size."""
    rng = np.random.default_rng(3)
    series = rng.normal(size=5000).astype(np.float32)
    series[4000:4016] = series[100:116]             # a tie: first one wins
    query = series[100:116].copy()
    want = tprim.ts.ref(series, query)
    monkeypatch.setattr(tprim.ts, "REF_BLOCK", 97)
    got = tprim.ts.ref(series, query)
    assert got == want and got[1] == 100
    TREG["TS"].compare(got, jprim.ts.ref(series, query))


@pytest.mark.parametrize("rows,ncols,nnz,seed", [(53, 40, 6, 1), (300, 256, 8, 9),
                                                 (7, 5, 0, 3)])
def test_csr_helpers_byte_equal(rows, ncols, nnz, seed):
    got = tprim.spmv.random_csr(rows, ncols, nnz, seed=seed)
    want = jprim.spmv.random_csr(rows, ncols, nnz, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    for g, w in zip(tprim.spmv.csr_to_ell(*got, rows),
                    jprim.spmv.csr_to_ell(*want, rows)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


# -- chunked phases, composed in series ----------------------------------------------

def compose(w, grid, args, n_chunks):
    meta, chunks = w.split(grid, n_chunks, *args)
    parts = [w.retrieve(grid, meta, w.compute(grid, meta,
                                              w.scatter(grid, meta, c)))
             for c in chunks]
    return w.merge(grid, meta, parts)


@pytest.mark.parametrize("banks", BANKS)
@pytest.mark.parametrize("n_chunks", [1, 3])
@pytest.mark.parametrize("name", PIPELINEABLE)
def test_chunked_composition_matches_reference(bank_grid, name, n_chunks,
                                               banks):
    e = TREG[name]
    args = e.make_args(np.random.default_rng(zlib.crc32(name.encode())),
                       scale=1)
    got = compose(e.chunked, cpu_grid(banks), args, n_chunks)
    want = compose(JREG[name].chunked, bank_grid, args, n_chunks)
    same(got, want, e.compare)
    e.compare(got, e.ref(*args))


@pytest.mark.parametrize("banks", BANKS)
def test_gemv_split_is_resident_then_varying(banks):
    w = TREG["GEMV"].chunked
    assert w.supports_residency and w.resident_args == (0,)
    g = cpu_grid(banks)
    a, x = TREG["GEMV"].make_args(np.random.default_rng(6), scale=1)
    meta, chunks = w.split(g, 3, a, x)
    res_meta, res_chunks = w.split_resident(g, 3, a)
    vmeta, vchunks = w.split_varying(g, 3, res_meta, a, x)
    assert vchunks is None and {k: meta[k] for k in res_meta} == res_meta
    assert set(meta) == set(vmeta)
    for c, r in zip(chunks, res_chunks):
        assert c.tobytes() == r.tobytes()


@pytest.mark.parametrize("banks", BANKS)
def test_spmv_split_is_resident_then_varying(banks):
    w = TREG["SpMV"].chunked
    assert w.supports_residency and w.resident_args == (0, 1)
    g = cpu_grid(banks)
    vals, cols, x = TREG["SpMV"].make_args(np.random.default_rng(6), scale=1)
    meta, chunks = w.split(g, 3, vals, cols, x)
    res_meta, res_chunks = w.split_resident(g, 3, vals, cols)
    vmeta, vchunks = w.split_varying(g, 3, res_meta, vals, cols, x)
    assert vchunks is None and {k: meta[k] for k in res_meta} == res_meta
    assert set(meta) == set(vmeta)
    for (cv, cc), (rv, rc) in zip(chunks, res_chunks):
        assert cv.tobytes() == rv.tobytes() and cc.tobytes() == rc.tobytes()


@pytest.mark.parametrize("banks", BANKS)
def test_bs_split_is_meta_resident_then_varying(banks):
    """BS's sorted array lives in the resident meta (broadcast), not in the
    chunk stream: the query chunks are the varying split's."""
    w = TREG["BS"].chunked
    assert w.supports_residency and w.resident_args == (0,) and w.meta_resident
    g = cpu_grid(banks)
    arr, q = TREG["BS"].make_args(np.random.default_rng(6), scale=1)
    meta, chunks = w.split(g, 3, arr, q)
    res_meta, res_chunks = w.split_resident(g, 3, arr)
    vmeta, vchunks = w.split_varying(g, 3, res_meta, arr, q)
    assert res_chunks is None and set(res_meta) == {"darr"}
    assert vmeta["darr"] is res_meta["darr"] and set(meta) == set(vmeta)
    np.testing.assert_array_equal(res_meta["darr"].numpy(), arr)
    for c, v in zip(chunks, vchunks):
        assert c.tobytes() == v.tobytes()
    parts = [w.retrieve(g, vmeta, w.compute(g, vmeta, w.scatter(g, vmeta, c)))
             for c in vchunks]
    np.testing.assert_array_equal(w.merge(g, vmeta, parts),
                                  TREG["BS"].ref(arr, q))


@pytest.mark.parametrize("banks", BANKS)
def test_mlp_split_is_resident_then_varying(banks):
    """MLP's hidden layers stay broadcast in the resident meta and its final
    layer's row chunks are the pipeline's chunks."""
    w = TREG["MLP"].chunked
    assert w.supports_residency and w.resident_args == (0,)
    assert not w.meta_resident
    g = cpu_grid(banks)
    wts, x = TREG["MLP"].make_args(np.random.default_rng(6), scale=1)
    meta, chunks = w.split(g, 3, wts, x)
    res_meta, res_chunks = w.split_resident(g, 3, wts)
    vmeta, vchunks = w.split_varying(g, 3, res_meta, wts, x)
    assert vchunks is None and set(meta) == set(vmeta)
    assert {k: meta[k] for k in ("m", "per")} == {
        k: res_meta[k] for k in ("m", "per")}
    assert torch.equal(meta["dh"], vmeta["dh"])
    for c, r in zip(chunks, res_chunks):
        assert c.tobytes() == r.tobytes()
    parts = [w.retrieve(g, vmeta, w.compute(g, vmeta, w.scatter(g, vmeta, c)))
             for c in res_chunks]
    TREG["MLP"].compare(w.merge(g, vmeta, parts), TREG["MLP"].ref(wts, x))


@pytest.mark.parametrize("banks", BANKS)
@pytest.mark.parametrize("name", ["GEMV-B", "GEMV-G"])
def test_gemv_fused_split_is_resident_then_varying(banks, name):
    w = TREG[name].chunked
    assert w.supports_residency and w.resident_args == (0,)
    g = cpu_grid(banks)
    wts, x = TREG[name].make_args(np.random.default_rng(6), scale=1)
    meta, chunks = w.split(g, 3, wts, x)
    res_meta, res_chunks = w.split_resident(g, 3, wts)
    vmeta, vchunks = w.split_varying(g, 3, res_meta, wts, x)
    assert vchunks is None and {k: meta[k] for k in res_meta} == res_meta
    assert set(meta) == set(vmeta)
    for c, r in zip(chunks, res_chunks):
        assert set(c) == set(r) == set(wts)
        assert all(c[k].tobytes() == r[k].tobytes() for k in c)


# -- registry ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TREG))
@pytest.mark.parametrize("scale", [1, 2])
def test_make_args_byte_parity(name, scale):
    got = TREG[name].make_args(np.random.default_rng(42), scale=scale)
    want = JREG[name].make_args(np.random.default_rng(42), scale=scale)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):                     # GEMV-B / G weights
            assert set(g) == set(w)
            pairs = [(g[k], w[k]) for k in w]
        elif isinstance(w, list):                   # MLP's layer weights
            assert isinstance(g, list) and len(g) == len(w)
            pairs = list(zip(g, w))
        else:
            pairs = [(g, w)]
        for gi, wi in pairs:
            if isinstance(wi, np.ndarray):
                assert gi.dtype == wi.dtype and gi.shape == wi.shape
                assert gi.tobytes() == wi.tobytes()
            else:                                   # BFS's source vertex
                assert type(gi) is type(wi) and gi == wi


@pytest.mark.parametrize("name", sorted(TREG))
def test_registry_entries_mirror_reference(name):
    t, j = TREG[name], JREG[name]
    assert t.section == j.section
    assert list(t.run_variants()) == list(j.run_variants())
    assert t.pipelineable == j.pipelineable
    assert t.resident_args == j.resident_args and t.resident == j.resident
    assert t.compare.__name__ == j.compare.__name__
    assert t.reason == j.reason
    assert (t.chunked is not None and t.chunked.meta_resident) == (
        j.chunked is not None and j.chunked.meta_resident)
    assert t.module.__name__.split(".")[-1] == j.module.__name__.split(".")[-1]


def test_registry_is_the_reference_order_subset():
    """Since every workload is ported: the reference's 16 names in its
    order, the same pipelineable ones and the same serialized-only reasons."""
    from repro.prim import registry as jregistry
    assert list(TREG) == list(JREG) and len(TREG) == 16
    assert PIPELINEABLE == jregistry.PIPELINEABLE
    assert set(PIPELINEABLE) == set(tprim.common.CHUNKED)
    assert SERIALIZED_ONLY == jregistry.SERIALIZED_ONLY
    assert sorted(SERIALIZED_ONLY) == ["BFS", "NW"]
    assert tprim.ALL == {n: e.module for n, e in TREG.items()}
