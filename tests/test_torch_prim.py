"""Port parity: the PrIM workloads of ``repro_torch.prim`` (GEMV, SpMV, HST,
RED, SCAN) against ``repro.prim``.

Every ``pim`` variant runs on the port at 1 and 8 banks (``device="cpu"``)
and on the reference at its one in-process bank (Pallas kernels in
interpret mode); both must give the same values with the same dtype, and
pass the registry's ``compare`` against ``ref()``.  The chunked phases,
composed in series (split → scatter → compute → retrieve → merge), must
match the reference's same composition.  ``make_args`` must give
byte-identical arrays for the same seed.
"""
import functools
import zlib

import numpy as np
import pytest

from repro import prim as jprim
from repro.prim.registry import REGISTRY as JREG
from repro_torch import prim as tprim
from repro_torch.core import make_bank_grid
from repro_torch.prim.registry import (PIPELINEABLE, REGISTRY as TREG,
                                       SERIALIZED_ONLY)

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


# -- registry ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TREG))
@pytest.mark.parametrize("scale", [1, 2])
def test_make_args_byte_parity(name, scale):
    got = TREG[name].make_args(np.random.default_rng(42), scale=scale)
    want = JREG[name].make_args(np.random.default_rng(42), scale=scale)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
        else:
            assert g == w


@pytest.mark.parametrize("name", sorted(TREG))
def test_registry_entries_mirror_reference(name):
    t, j = TREG[name], JREG[name]
    assert t.section == j.section
    assert list(t.run_variants()) == list(j.run_variants())
    assert t.pipelineable == j.pipelineable
    assert t.resident_args == j.resident_args and t.resident == j.resident
    assert t.compare.__name__ == j.compare.__name__
    assert t.module.__name__.split(".")[-1] == j.module.__name__.split(".")[-1]


def test_registry_is_the_reference_order_subset():
    assert list(TREG) == [n for n in JREG if n in TREG]
    assert set(PIPELINEABLE) == set(tprim.common.CHUNKED) == set(TREG)
    assert SERIALIZED_ONLY == {}
    assert tprim.ALL == {n: e.module for n, e in TREG.items()}
