"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without a CUDA device
("not verified on GPU"); the decision is made inside the test, never at
import time.  This file imports no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: integer results are exact.  The kernels add floats in another
order than the plain versions, and a float32 sum's rounding error scales
with the magnitudes added: float sums and prefix sums agree within 1e-6
(about 16 float32 epsilons) times the sum of |x| over the same prefix.
float32 GEMV and SpMV agree within the registry's rtol = atol = 1e-4;
bfloat16 GEMV and SpMV, compared in float32, within 2e-2, one bfloat16
rounding step being 2^-8 of the value.  The session and pipeline cases
hold results to the registry's comparators against ``ref()``.
"""
import threading
import zlib

import numpy as np
import pytest
import torch

from repro_torch import make_rank_grid, pim
from repro_torch.kernels import gemv as kgemv
from repro_torch.kernels import histogram as khist
from repro_torch.kernels import ops
from repro_torch.kernels import reduce as kred
from repro_torch.kernels import scan as kscan
from repro_torch.kernels import spmv as kspmv
from repro_torch.prim.registry import REGISTRY
from repro_torch.runtime import run_pipelined_ranked

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("not verified on GPU: no CUDA device")
    return torch.device("cuda", 0)


def close(got, want, allowed=0):
    """Equal dtype and shape; every element within ``allowed`` (0: exact)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.cuda.synchronize()
    assert bool(((got.float() - want.float()).abs() <= allowed).all())


def rel(want, tol):
    return tol * (1 + want.float().abs())


def make(shape, dtype, dev, lo=0, hi=100):
    g = torch.Generator(device=dev).manual_seed(0)
    if dtype == torch.int32:
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)
    return torch.randn(shape, generator=g, device=dev, dtype=dtype)


@pytest.mark.parametrize("shape", [(1, 128), (1, 1000), (3, 12345),
                                   (64, 4096), (2, 1 << 20)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_reduce_and_scan_match_plain(dev, shape, dtype):
    x = make(shape, dtype, dev)
    n = shape[-1]
    b = min(4096, max(128, 1 << (n - 1).bit_length()))
    xp = torch.nn.functional.pad(x, (0, (-n) % b))
    floats = dtype == torch.float32
    close(ops.reduce_sum(x), kred.plain(xp, b),
          1e-6 * x.abs().sum(-1) if floats else 0)
    cum = 1e-6 * x.abs().cumsum(-1) if floats else 0
    close(ops.scan_inclusive(x), kscan.plain(xp, b)[:, :n], cum)
    close(ops.scan_exclusive(x), kscan.plain(xp, b)[:, :n] - x, cum)


def test_int32_wraps(dev):
    x = torch.full((2, 12288), 1 << 20, device=dev, dtype=torch.int32)
    close(ops.reduce_sum(x), kred.plain(x, 4096))
    close(ops.scan_inclusive(x), kscan.plain(x, 4096))


@pytest.mark.parametrize("n,nbins", [(4096, 256), (10000, 64), (500, 1024),
                                     (3000, 20000)])
def test_histogram_matches_plain(dev, n, nbins):
    v = make((4, n), torch.int32, dev, lo=-5, hi=nbins + 5)
    close(ops.histogram(v, nbins), khist.plain(v, nbins, 4096))


@pytest.mark.parametrize("m,n", [(128, 512), (64, 64), (100, 300),
                                 (7, 1000), (33, 5000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemv_matches_plain(dev, m, n, dtype):
    a = make((3, m, n), dtype, dev)
    x = make((n,), dtype, dev)
    got = ops.gemv(a, x)
    want = kgemv.plain(a.reshape(-1, n), x).reshape(3, m)
    close(got, want, rel(want, 2e-2 if dtype == torch.bfloat16 else 1e-4))


def test_launch_counts_and_refusals(dev):
    ops.reset_launch_counts()
    x = make((2, 5000), torch.int32, dev)
    ops.reduce_sum(x)
    ops.scan_exclusive(x)
    ops.histogram(x, 256)
    ops.gemv(make((2, 4, 128), torch.float32, dev),
             make((128,), torch.float32, dev))
    ops.spmv_ell(make((2, 8, 4), torch.float32, dev),
                 make((2, 8, 4), torch.int32, dev, lo=-1, hi=16),
                 make((16,), torch.float32, dev))
    assert ops.launch_counts() == {"reduce_sum": 1, "scan_inclusive": 1,
                                   "histogram": 1, "gemv": 1, "spmv_ell": 1}
    with pytest.raises(TypeError):
        ops.reduce_sum(x.to(torch.int64))
    with pytest.raises(ValueError):
        kred.reduce_sum(x.cpu().to(dev).t(), block=128)


# -- spmv_ell ----------------------------------------------------------------------

@pytest.mark.parametrize("banks,rows,k,n", [(1, 128, 8, 256), (3, 200, 16, 512),
                                            (2, 64, 1, 128), (4, 1000, 5, 300),
                                            (64, 256, 8, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmv_matches_plain(dev, banks, rows, k, n, dtype):
    """Columns in [-1, n + 4): -1 is padding (an inf there is skipped),
    n and past read x[n-1], as the Pallas kernel's clamped gather does."""
    cols = make((banks, rows, k), torch.int32, dev, lo=-1, hi=n + 4)
    vals = make((banks, rows, k), torch.float32, dev)
    vals = torch.where(cols < 0, float("inf"), vals).to(dtype)
    x = make((n,), torch.float32, dev)
    got = ops.spmv_ell(vals, cols, x)
    want = kspmv.plain(vals.view(-1, k), cols.view(-1, k), x).view(banks, rows)
    assert torch.isfinite(got.float()).all()
    close(got, want, rel(want, 2e-2 if dtype == torch.bfloat16 else 1e-4))


def test_spmv_refuses_bad_inputs(dev):
    v = make((4, 8), torch.float32, dev)
    c = make((4, 8), torch.int32, dev, hi=8)
    with pytest.raises(TypeError):
        kspmv.spmv_ell(v, c.to(torch.int64), make((8,), torch.float32, dev))
    with pytest.raises(ValueError):
        kspmv.spmv_ell(v, c[:2], make((8,), torch.float32, dev))


# -- the pipeline on CUDA streams, and the session -----------------------------------

def test_rank_views_get_distinct_streams(dev):
    """Rank views compare equal (their rank index is left out of equality),
    so per-rank streams hang on the view objects, not on a key."""
    g = make_rank_grid(2, 4, device=dev)
    a, b = g.rank_view(0), g.rank_view(1)
    assert a == b and (a.rank, b.rank) == (0, 1)
    sa, sb = a.streams, b.streams
    assert sa is not sb and sa is a.streams
    assert len({s.cuda_stream for s in (sa.h2d, sa.compute, sa.d2h,
                                        sb.h2d, sb.compute, sb.d2h)}) == 6


def test_session_pipelined_matches_ref(dev):
    with pim.session(ranks=2, banks_per_rank=4) as s:
        for name, entry in pim.registry().items():
            rng = np.random.default_rng(zlib.crc32(name.encode()))
            args = entry.make_args(rng, scale=4)
            entry.compare(s.submit(name, *args).result(timeout=120),
                          entry.ref(*args))
            entry.compare(s.submit(name, *args).result(timeout=120),
                          entry.ref(*args))          # warm where resident
        assert s.stats()["cache"]["hits"] == 2     # GEMV and SpMV


def test_pinned_staging_reused_under_two_ranks(dev):
    """Each rank's scatter stage double-buffers its pinned staging: after
    the first two chunks it only reuses, and every result matches."""
    g = make_rank_grid(2, 4, device=dev)
    entry = REGISTRY["SpMV"]                      # two puts per chunk
    reqs = [entry.make_args(np.random.default_rng(i), scale=8)
            for i in range(3)]
    out = run_pipelined_ranked(g, entry.chunked, reqs, n_chunks=4)
    for args, got in zip(reqs, out):
        entry.compare(got, entry.ref(*args))
    for view in g.rank_views:
        stage = view.streams.stage
        assert stage.allocations <= 2 * 2          # two lanes, two buffers
        assert stage.reuses == 2 * 4 * 3 - stage.allocations


def test_rank_threads_fill_concurrently(dev):
    """Two pipelines on two rank views from two threads at once."""
    g = make_rank_grid(2, 4, device=dev)
    entry = REGISTRY["SCAN"]
    args = entry.make_args(np.random.default_rng(5), scale=16)
    want = entry.ref(*args)
    outs, errs = [None, None], []

    def run(r):
        try:
            outs[r] = run_pipelined_ranked(g.rank_view(r), entry.chunked,
                                           [args], n_chunks=4)[0]
        except Exception as e:               # noqa: BLE001 — asserted below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errs, errs
    for out in outs:
        entry.compare(out, want)
