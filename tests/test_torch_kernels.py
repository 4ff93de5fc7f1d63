"""Port parity: every wrapper of ``repro_torch.kernels.ops`` against
``repro.kernels.ops`` on the shapes of tests/test_kernels.py, attention and
decode attention included.

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
Attention keeps tests/test_kernels.py's own tolerances: 2e-3 in float32
(the reference's online softmax over 128-key blocks against one softmax
over the row) and 2e-2 in bfloat16; the decode attentions, whose two sides
take one softmax each, agree at 1e-4.  moe_gmm and ssd_scan keep them too:
moe_gmm 1e-3 in float32 and 5e-2 in bfloat16 (a float32 sum over d of
unit normals, rounded once to bfloat16), ssd_scan 5e-3 between its
chunked and sequential forms; like against like (chunked against chunked,
sequential against sequential) the scans agree at 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba_scan as tmamba
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import scan as tscan
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


@pytest.mark.parametrize("banks", [1, 2, 5, 8])
@pytest.mark.parametrize("n", [1, 127, 4097])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_scan_exclusive_ragged_banks_match_reference(banks, n, dtype):
    """``ops.scan_exclusive`` (on the card one pass of the kernel, here
    inclusive - x) per bank against the reference's, and the kernel
    module's ``exclusive`` path alike."""
    x = data((banks, n), dtype)
    tx = torch.from_numpy(x)
    got = tops.scan_exclusive(tx)
    tol = 0 if dtype == torch.int32 else 1e-4
    for b in range(banks):
        agree(got[b], jops.scan_exclusive(both(x[b], dtype)[0]), tol)
    b = min(4096, max(128, 1 << (n - 1).bit_length()))
    xp = torch.nn.functional.pad(tx, (0, (-n) % b))
    ex = tscan.scan_inclusive(xp, block=b, exclusive=True)[:, :n]
    assert torch.equal(ex, tscan.plain(xp, b)[:, :n] - tx)
    assert torch.equal(ex, got)


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


@pytest.mark.parametrize("banks", [0, 3])
@pytest.mark.parametrize("rows", [1, 7, 129, 300])
def test_spmv_rows_that_need_padding_match_reference(banks, rows):
    """Row counts that are no multiple of the reference's row block, one
    bank (2-D) and three: the reference pads to its block and slices
    back, the wrapper passes the rows as they are, and the kernel module
    takes (..., k) whole."""
    shape = (banks, rows, 8) if banks else (rows, 8)
    vals = R.normal(size=shape).astype(np.float32)
    cols = R.integers(-1, 40, size=shape).astype(np.int32)
    x = R.normal(size=40).astype(np.float32)
    tv, tc, tx = (torch.from_numpy(a) for a in (vals, cols, x))
    got = tops.spmv_ell(tv, tc, tx)
    assert tuple(got.shape) == shape[:-1]
    agree(tspmv.spmv_ell(tv, tc, tx), got.numpy(), 0)
    for b in range(banks or 1):
        want = jops.spmv_ell(jnp.asarray(vals[b] if banks else vals),
                             jnp.asarray(cols[b] if banks else cols),
                             jnp.asarray(x))
        agree(got[b] if banks else got, want, 1e-4)


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


# -- attention -------------------------------------------------------------------

def qkv(B, H, KVH, S, T, D, dtype):
    return (both(R.normal(size=(B, H, S, D)).astype(np.float32), dtype),
            both(R.normal(size=(B, KVH, T, D)).astype(np.float32), dtype),
            both(R.normal(size=(B, KVH, T, D)).astype(np.float32), dtype))


@pytest.mark.parametrize("B,H,KVH,S,T,D", [
    (1, 4, 4, 128, 128, 64),      # MHA aligned
    (2, 4, 2, 256, 256, 128),     # GQA aligned
    (1, 6, 2, 100, 100, 80),      # ragged seq + head dim
    (1, 8, 1, 64, 64, 120),       # MQA, danube head dim
    (1, 3, 3, 96, 48, 160),       # cross shapes, stablelm head dim
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_matches_reference(B, H, KVH, S, T, D, dtype):
    """tests/test_kernels.py's sweep: the port's wrapper (the plain version
    on CPU tensors) against the reference's padded Pallas kernel in
    interpret mode, and the two oracles against each other."""
    (jq, tq), (jk, tk), (jv, tv) = qkv(B, H, KVH, S, T, D, dtype)
    causal = S == T
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    agree(tops.attention(tq, tk, tv, causal=causal),
          jops.attention(jq, jk, jv, causal=causal), tol)
    agree(tref.attention(tq, tk, tv, causal=causal),
          jref.attention(jq, jk, jv, causal=causal), tol)


@pytest.mark.parametrize("window", [16, 64, 1000])
def test_attention_sliding_window_matches_reference(window):
    (jq, tq), (jk, tk), (jv, tv) = qkv(1, 4, 2, 128, 128, 64, torch.float32)
    agree(tops.attention(tq, tk, tv, causal=True, window=window),
          jops.attention(jq, jk, jv, causal=True, window=window), 2e-3)


@pytest.mark.parametrize("S,T,causal,window", [(40, 24, True, None),
                                               (40, 40, True, 0),
                                               (24, 40, False, 8)])
def test_attention_offset_and_fully_masked_rows(S, T, causal, window):
    """Queries sit at i + (T - S): with S > T the first S - T rows see no
    key and give 0 (not NaN), as both the Pallas kernel and the oracle
    do; a window of 0 masks every key."""
    (jq, tq), (jk, tk), (jv, tv) = qkv(1, 2, 1, S, T, 16, torch.float32)
    got = tops.attention(tq, tk, tv, causal=causal, window=window)
    assert torch.isfinite(got).all()
    agree(got, jref.attention(jq, jk, jv, causal=causal, window=window), 2e-3)
    agree(got, jops.attention(jq, jk, jv, causal=causal, window=window), 2e-3)
    if causal and S > T:
        assert bool((got[:, :, :S - T] == 0).all())


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("D", [5, 13])
def test_attention_head_dim_padding_matches_reference(D, window):
    """The padding the bfloat16 kernel's wrapper applies for the TMA (D to
    a multiple of 8): pad, run the plain version with the scale of the
    unpadded D, slice back; it agrees with the reference's padded Pallas
    kernel (interpret mode), and the padded columns come out zero."""
    (jq, tq), (jk, tk), (jv, tv) = qkv(1, 4, 2, 40, 40, D, torch.float32)
    qp, kp, vp = tfa.pad_head_dim(tq, tk, tv)
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == D + (-D) % 8
    assert bool((qp[..., D:] == 0).all()) and bool((qp[..., :D] == tq).all())
    full = tfa.plain(qp, kp, vp, causal=True, window=window,
                     scale=float(D) ** -0.5)
    assert bool((full[..., D:] == 0).all())
    agree(full[..., :D], jops.attention(jq, jk, jv, causal=True,
                                        window=window), 1e-5)


@pytest.mark.parametrize("impl", ["ref", "grouped"])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_reference(impl, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = qkv(2, 8, 2, 1, 64, 32, dtype)
    lens = np.asarray([10, 64], np.int32)
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)
    agree(tops.decode_attention(tq, tk, tv, tl, window=window, impl=impl),
          jops.decode_attention(jq, jk, jv, jl, window=window, impl=impl),
          2e-2 if dtype == torch.bfloat16 else 1e-4)


def test_decode_attention_equals_full_attention_over_the_cache():
    (jq, tq), (jk, tk), (jv, tv) = qkv(2, 4, 2, 1, 32, 64, torch.float32)
    lens = torch.tensor([32, 32], dtype=torch.int32)
    agree(tops.decode_attention(tq, tk, tv, lens),
          jref.attention(jq, jk, jv, causal=False), 1e-4)


# -- moe grouped matmul --------------------------------------------------------------

GMM_SHAPES = [(4, 64, 96, 160), (8, 128, 128, 128), (2, 16, 64, 48)]


@pytest.mark.parametrize("E,C,d,f", GMM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_matches_reference(E, C, d, f, dtype):
    """tests/test_kernels.py's sweep, with one expert at count 0 and one at
    C beside the random counts: the port's wrapper (the plain version on
    CPU tensors) against the reference's padded Pallas kernel in
    interpret mode, and the two oracles against each other."""
    (jx, tx) = both(R.normal(size=(E, C, d)).astype(np.float32), dtype)
    (jw, tw) = both(R.normal(size=(E, d, f)).astype(np.float32), dtype)
    cnt = R.integers(0, C + 1, size=E).astype(np.int32)
    cnt[:2] = (0, C)
    jc, tc = jnp.asarray(cnt), torch.from_numpy(cnt)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-3
    got = tops.moe_gmm(tx, tw, tc)
    agree(got, jops.moe_gmm(jx, jw, jc), tol)
    agree(tref.moe_gmm(tx, tw, tc), jref.moe_gmm(jx, jw, jc), tol)
    assert bool((got[0] == 0).all()) and bool((got[1] != 0).any())
    for e in range(E):
        assert bool((got[e, cnt[e]:] == 0).all())


@pytest.mark.parametrize("E,C,d,f", [(1, 37, 13, 9), (3, 100, 203, 301)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_padding_matches_reference(E, C, d, f, dtype):
    """The padding the bfloat16 kernel's wrapper applies for the TMA (d and
    f to multiples of 8): pad, run the plain version, slice back; it agrees
    with the reference's padded Pallas kernel (interpret mode)."""
    (jx, tx) = both(R.normal(size=(E, C, d)).astype(np.float32), dtype)
    (jw, tw) = both(R.normal(size=(E, d, f)).astype(np.float32), dtype)
    cnt = R.integers(0, C + 1, size=E).astype(np.int32)
    cnt[0] = C
    xp, wp = tgmm.pad_gmm(tx, tw)
    assert xp.shape[2] % 8 == 0 and wp.shape[1:] == (xp.shape[2], f + (-f) % 8)
    got = tgmm.plain(xp, wp, torch.from_numpy(cnt))[..., :f]
    agree(got, jops.moe_gmm(jx, jw, jnp.asarray(cnt)),
          5e-2 if dtype == torch.bfloat16 else 1e-4)


def test_moe_gmm_counts_past_capacity_keep_every_row():
    """A count at or past C (or below 0) is clamped into [0, C]."""
    x = torch.from_numpy(R.normal(size=(3, 8, 16)).astype(np.float32))
    w = torch.from_numpy(R.normal(size=(3, 16, 4)).astype(np.float32))
    got = tops.moe_gmm(x, w, torch.tensor([8, 99, -1], dtype=torch.int32))
    full = torch.einsum("ecd,edf->ecf", x, w)
    torch.testing.assert_close(got[:2], full[:2], rtol=1e-5, atol=1e-5)
    assert bool((got[2] == 0).all())


# -- ssd scan ---------------------------------------------------------------------------

SSD_SHAPES = [(2, 256, 3, 32, 16, 64), (1, 128, 1, 64, 8, 128),
              (1, 100, 2, 16, 4, 32)]


def ssd_inputs(B, S, H, P, N, dtype=torch.float32):
    """x, b, c in ``dtype``, a float32 in [0.3, 1), as jax and torch."""
    x = both(R.normal(size=(B, S, H, P)).astype(np.float32), dtype)
    a = both(R.uniform(0.3, 1.0, size=(B, S, H)).astype(np.float32),
             torch.float32)
    b = both(R.normal(size=(B, S, N)).astype(np.float32), dtype)
    c = both(R.normal(size=(B, S, N)).astype(np.float32), dtype)
    return [t[0] for t in (x, a, b, c)], [t[1] for t in (x, a, b, c)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_scan_matches_reference(B, S, H, P, N, chunk):
    """tests/test_kernels.py's sweep: y and the final h of the port's
    wrapper (the chunked form on CPU tensors) against the reference's
    Pallas kernel in interpret mode and against its sequential oracle, at
    5e-3; and like against like at 1e-4."""
    jin, tin = ssd_inputs(B, S, H, P, N)
    y, h = tops.ssd_scan(*tin, chunk=chunk)
    jy, jh = jops.ssd_scan(*jin, chunk=chunk)
    ry, rh = jref.ssd_scan(*jin)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, N, P)
    assert h.dtype == torch.float32
    for got, want in ((y, ry), (h, rh), (y, jy), (h, jh)):
        agree(got, want, 5e-3)
    agree(y, jy, 1e-4)                       # chunked against chunked
    agree(h, jh, 1e-4)
    sy, sh = tref.ssd_scan(*tin)             # sequential against sequential
    agree(sy, ry, 1e-4)
    agree(sh, rh, 1e-4)


def test_ssd_scan_bfloat16_inputs_match_reference():
    """The Jamba path's dtypes: x, b, c bfloat16, a float32; y comes back
    in bfloat16 and h in float32.  Both round the same float32 sums to
    bfloat16 (2e-2: one rounding step is 2^-8 of the value)."""
    jin, tin = ssd_inputs(1, 200, 2, 16, 8, torch.bfloat16)
    y, h = tops.ssd_scan(*tin, chunk=64)
    jy, jh = jops.ssd_scan(*jin, chunk=64)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    agree(y, jy, 2e-2)
    agree(h, jh, 1e-4)


@pytest.mark.parametrize("S,chunk", [(5, 128), (8, 8), (130, 64), (1, 16)])
def test_ssd_scan_clamps_the_chunk_and_pads_the_tail(S, chunk):
    """The chunk is clamped to ``max(8, next_pow2(S))`` and the tail padded
    with a = 1, as the reference does; the chunked form equals the
    sequential recurrence."""
    jin, tin = ssd_inputs(1, S, 2, 8, 4)
    y, h = tops.ssd_scan(*tin, chunk=chunk)
    jy, jh = jops.ssd_scan(*jin, chunk=chunk)
    agree(y, jy, 1e-4)
    agree(h, jh, 1e-4)
    sy, sh = tmamba.plain(*tin)
    agree(y, np.asarray(sy), 5e-3)
    agree(h, np.asarray(sh), 5e-3)


def test_ssd_oracle_takes_an_initial_state():
    jin, tin = ssd_inputs(2, 20, 2, 8, 4)
    h0 = R.normal(size=(2, 2, 4, 8)).astype(np.float32)
    y, h = tref.ssd_scan(*tin, h0=torch.from_numpy(h0))
    jy, jh = jref.ssd_scan(*jin, h0=jnp.asarray(h0))
    agree(y, jy, 1e-4)
    agree(h, jh, 1e-4)


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
    tops.attention(*(torch.ones(1, 2, 4, 8),) * 3)
    tops.moe_gmm(torch.ones(2, 8, 4), torch.ones(2, 4, 3),
                 torch.tensor([3, 8], dtype=torch.int32))
    tops.ssd_scan(torch.ones(1, 16, 2, 4), torch.full((1, 16, 2), 0.5),
                  torch.ones(1, 16, 3), torch.ones(1, 16, 3))
    assert tops.launch_counts() == {"reduce_sum": 0, "scan_inclusive": 0,
                                    "histogram": 0, "gemv": 0, "spmv_ell": 0,
                                    "flash_attention": 0, "moe_gmm": 0,
                                    "ssd_scan": 0}


def test_wrappers_reject_bad_ranks():
    with pytest.raises(ValueError):
        tops.reduce_sum(torch.zeros(2, 2, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        tops.gemv(torch.zeros(8), torch.zeros(8))
    with pytest.raises(ValueError):
        tops.spmv_ell(torch.zeros(8), torch.zeros(8, dtype=torch.int32),
                      torch.zeros(8))
