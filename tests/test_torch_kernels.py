"""Port parity: every wrapper of ``repro_torch.kernels.ops`` against
``repro.kernels.ops`` on the shapes of tests/test_kernels.py.

The reference runs its Pallas kernels in interpret mode on the CPU; the
port runs on CPU tensors, so each wrapper's padding and block clamp run
for real and the kernel's plain PyTorch version does the arithmetic (the
CUDA kernels themselves are held against those plain versions on the card,
in tests/test_torch_gpu.py and chip_smoke.py).

Tolerances: integer results are exact (same values, same wrap-around).
float32 results agree to rtol = atol = 1e-4, the registry's GEMV and SpMV
tolerance: both sides accumulate in float32 but may add in another order.
bfloat16 GEMV and SpMV are compared in float32 at 2e-2: both round one
float32 sum to bfloat16, where one rounding step is 2^-8 of the value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spmv as tspmv

R = np.random.default_rng(7)

JNP = {torch.int32: jnp.int32, torch.float32: jnp.float32,
       torch.bfloat16: jnp.bfloat16}


def both(x: np.ndarray, dtype: torch.dtype):
    """The same values as a jax array and a CPU tensor of ``dtype``."""
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(x).to(dtype)


def agree(got: torch.Tensor, want, tol: float):
    """Same dtype and shape; values exact (tol 0) or within tol."""
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    want = np.asarray(want, np.float32 if want.dtype == jnp.bfloat16 else None)
    assert tuple(got.shape) == want.shape
    g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    if tol == 0:
        np.testing.assert_array_equal(g, want)
    else:
        np.testing.assert_allclose(g, want, rtol=tol, atol=tol)


def data(n, dtype):
    if dtype == torch.int32:
        return R.integers(0, 100, size=n).astype(np.int32)
    return R.normal(size=n).astype(np.float32)


# -- reduce / scan ---------------------------------------------------------------

@pytest.mark.parametrize("n", [128, 4096, 1000, 12345])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["reduce_sum", "scan_inclusive",
                                "scan_exclusive"])
def test_reduce_scan_match_reference(op, n, dtype):
    jx, tx = both(data(n, dtype), dtype)
    tol = 0 if dtype == torch.int32 else 1e-4
    agree(getattr(tops, op)(tx), getattr(jops, op)(jx), tol)


@pytest.mark.parametrize("op", ["reduce_sum", "scan_inclusive"])
@pytest.mark.parametrize("n", [4096, 12288, 5000])
def test_int32_wraps_like_reference(op, n):
    x = np.full(n, 1 << 20, np.int32)           # total is past 2**31
    x[::7] = (1 << 31) - 1
    jx, tx = both(x, torch.int32)
    agree(getattr(tops, op)(tx), getattr(jops, op)(jx), 0)


@pytest.mark.parametrize("op", ["reduce_sum", "scan_inclusive",
                                "scan_exclusive"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_banked_rows_match_reference_per_bank(op, dtype):
    x = data((5, 777), dtype)
    _, tx = both(x, dtype)
    got = getattr(tops, op)(tx)
    tol = 0 if dtype == torch.int32 else 1e-4
    for b in range(5):
        agree(got[b], getattr(jops, op)(both(x[b], dtype)[0]), tol)


# -- histogram --------------------------------------------------------------------

@pytest.mark.parametrize("n,nbins", [(4096, 256), (10000, 64), (500, 1024)])
def test_histogram_matches_reference(n, nbins):
    v = R.integers(-5, nbins + 5, size=n).astype(np.int32)   # edge bins clip
    jv, tv = both(v, torch.int32)
    got = tops.histogram(tv, nbins)
    agree(got, jops.histogram(jv, nbins), 0)
    assert int(got.sum()) == n


def test_histogram_banked_pad_correction():
    v = R.integers(0, 64, size=(3, 1000)).astype(np.int32)
    got = tops.histogram(torch.from_numpy(v), 64)
    for b in range(3):
        agree(got[b], jops.histogram(jnp.asarray(v[b]), 64), 0)


# -- gemv ------------------------------------------------------------------------

@pytest.mark.parametrize("m,n", [(128, 512), (64, 64), (100, 300), (7, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemv_matches_reference(m, n, dtype):
    ja, ta = both(R.normal(size=(m, n)).astype(np.float32), dtype)
    jx, tx = both(R.normal(size=n).astype(np.float32), dtype)
    agree(tops.gemv(ta, tx), jops.gemv(ja, jx),
          2e-2 if dtype == torch.bfloat16 else 1e-4)


def test_gemv_bank_batched_equals_per_bank():
    a = R.normal(size=(4, 33, 100)).astype(np.float32)
    x = R.normal(size=100).astype(np.float32)
    got = tops.gemv(torch.from_numpy(a), torch.from_numpy(x))
    assert tuple(got.shape) == (4, 33)
    for b in range(4):
        agree(got[b], jops.gemv(jnp.asarray(a[b]), jnp.asarray(x)), 1e-4)


# -- spmv ------------------------------------------------------------------------

def ell(rows, k, n, lo=-1):
    cols = R.integers(lo, n, size=(rows, k)).astype(np.int32)
    vals = R.normal(size=(rows, k)).astype(np.float32)
    return vals, cols, R.normal(size=(n,)).astype(np.float32)


@pytest.mark.parametrize("rows,k,n", [(128, 8, 256), (200, 16, 512),
                                      (64, 1, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmv_matches_reference(rows, k, n, dtype):
    """tests/test_kernels.py's sweep: the wrapper (row pad, cols -1) against
    the reference's wrapper in interpret mode, and the oracles alike."""
    vals, cols, x = ell(rows, k, n)
    jv, tv = both(vals, dtype)
    jc, tc = both(cols, torch.int32)
    jx, tx = both(x, torch.float32)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    agree(tops.spmv_ell(tv, tc, tx), jops.spmv_ell(jv, jc, jx), tol)
    agree(tref.spmv_ell(tv, tc, tx), jref.spmv_ell(jv, jc, jx), tol)


def test_spmv_columns_past_n_read_the_last_x():
    """A JAX gather clamps: cols = [0, 5] with n = 4 reads x[0] + x[3]."""
    vals = np.ones((1, 2), np.float32)
    cols = np.array([[0, 5]], np.int32)
    x = np.array([1.0, 2.0, 4.0, 8.0], np.float32)
    for fn in (tops.spmv_ell, tref.spmv_ell):
        got = fn(*(torch.from_numpy(a) for a in (vals, cols, x)))
        assert got.tolist() == [9.0]
    agree(tops.spmv_ell(*(torch.from_numpy(a) for a in (vals, cols, x))),
          jops.spmv_ell(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x)),
          0)
    agree(tref.spmv_ell(*(torch.from_numpy(a) for a in (vals, cols, x))),
          jref.spmv_ell(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x)),
          0)


def test_spmv_padded_inf_is_skipped_by_the_kernel_not_the_oracle():
    """The Pallas body applies ``where`` after the product, so an inf in a
    padded slot gives 0; the oracle multiplies it by a gathered 0 (NaN).
    The wrapper / plain version follow the first, the port's oracle the
    second — each as its counterpart."""
    vals, cols, x = ell(64, 4, 32, lo=0)
    cols[::3, 1] = -1
    vals[::3, 1] = np.inf
    tv, tc, tx = (torch.from_numpy(a) for a in (vals, cols, x))
    jv, jc, jx = (jnp.asarray(a) for a in (vals, cols, x))
    got = tops.spmv_ell(tv, tc, tx)
    assert torch.isfinite(got).all()
    agree(got, jops.spmv_ell(jv, jc, jx), 1e-4)
    agree(tspmv.plain(tv, tc, tx), jops.spmv_ell(jv, jc, jx), 1e-4)
    oracle = tref.spmv_ell(tv, tc, tx)
    assert torch.isnan(oracle[::3]).all()
    np.testing.assert_array_equal(np.isnan(oracle.numpy()),
                                  np.isnan(np.asarray(jref.spmv_ell(jv, jc,
                                                                    jx))))


def test_spmv_bank_batched_equals_per_bank():
    vals = R.normal(size=(3, 50, 6)).astype(np.float32)
    cols = R.integers(-1, 40, size=(3, 50, 6)).astype(np.int32)
    x = R.normal(size=40).astype(np.float32)
    got = tops.spmv_ell(*(torch.from_numpy(a) for a in (vals, cols, x)))
    assert tuple(got.shape) == (3, 50)
    for b in range(3):
        agree(got[b], jops.spmv_ell(jnp.asarray(vals[b]), jnp.asarray(cols[b]),
                                    jnp.asarray(x)), 1e-4)


# -- oracles and dispatch ----------------------------------------------------------

def test_oracles_keep_int32():
    x = torch.tensor([2**31 - 1, 5], dtype=torch.int32)
    assert tref.reduce_sum(x).dtype == torch.int32
    assert tref.scan_inclusive(x).dtype == torch.int32
    assert tref.scan_exclusive(x).tolist() == [0, 2**31 - 1]
    assert tref.histogram(torch.tensor([-3, 0, 9], dtype=torch.int32),
                          4).tolist() == [2, 0, 0, 1]


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    tops.reset_launch_counts()
    x = torch.arange(300, dtype=torch.int32)
    tops.reduce_sum(x)
    tops.scan_exclusive(x)
    tops.histogram(x, 16)
    tops.gemv(torch.ones(3, 8), torch.ones(8))
    tops.spmv_ell(torch.ones(3, 4), torch.zeros(3, 4, dtype=torch.int32),
                  torch.ones(8))
    assert tops.launch_counts() == {"reduce_sum": 0, "scan_inclusive": 0,
                                    "histogram": 0, "gemv": 0, "spmv_ell": 0}


def test_wrappers_reject_bad_ranks():
    with pytest.raises(ValueError):
        tops.reduce_sum(torch.zeros(2, 2, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        tops.gemv(torch.zeros(8), torch.zeros(8))
    with pytest.raises(ValueError):
        tops.spmv_ell(torch.zeros(8), torch.zeros(8, dtype=torch.int32),
                      torch.zeros(8))
