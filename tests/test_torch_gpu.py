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
rounding step being 2^-8 of the value.  flash_attention agrees with its
plain version within the reference's kernel-test tolerances
(tests/test_kernels.py): rtol = atol = 2e-3 in float32 (an online softmax
over key tiles against one softmax over the row) and 2e-2 in bfloat16
(the kernel rounds P to bfloat16 for its tensor-core P V product, and both
round a float32 result to bfloat16).  moe_gmm keeps the reference's
kernel-test tolerances too: 1e-3 in float32 (float32 sums over d in
another order) and 5e-2 in bfloat16 (one bfloat16 step of a sum of d unit
products).  ssd_scan agrees with its sequential plain version at 5e-3 (the
reference's chunked-vs-sequential tolerance) and with its chunked form in
plain PyTorch at 1e-3 (float32 sums over a chunk in another order, the
device's expf / logf); with bfloat16 x, both round one float32 value to
bfloat16, so y is held at 2e-2.  The session and pipeline cases, and
the cases of VA, SEL, UNI, BS, TS, BFS, MLP, NW and TRNS on 64 banks of
the card, hold results to the registry's comparators against ``ref()``.
"""
import os
import subprocess
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from repro_torch import make_rank_grid, pim
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import gemv as kgemv
from repro_torch.kernels import histogram as khist
from repro_torch.kernels import mamba_scan as kmamba
from repro_torch.kernels import moe_gmm as kgmm
from repro_torch.kernels import ops
from repro_torch.kernels import reduce as kred
from repro_torch.kernels import scan as kscan
from repro_torch.kernels import spmv as kspmv
from repro_torch.models import transformer
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
    err = (got.float() - want.float()).abs()
    assert bool((err <= allowed).all()), f"max |got - want| {float(err.max())}"


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


# -- reduce_sum: one launch, spans combined by the last block -----------------------

def wrapped_sum(x):
    """The int32 sum of each row with two's-complement wrap, from int64."""
    s = x.to(torch.int64).sum(-1)
    return (torch.remainder(s + (1 << 31), 1 << 32) - (1 << 31)).to(torch.int32)


@pytest.mark.parametrize("shape", [(1, 128), (1, 1000), (3, 12345),
                                   (64, 4096), (2, 1 << 20)])
def test_reduce_int32_exact_and_wraps(dev, shape):
    """Values near 2^30: every row's sum passes 2^31 and wraps, at each
    shape of test_reduce_and_scan_match_plain."""
    x = make(shape, torch.int32, dev, lo=1 << 30, hi=(1 << 31) - 1)
    close(ops.reduce_sum(x), wrapped_sum(x))


@pytest.mark.parametrize("shape", [(2048, 32768), (1, 1 << 22), (3, 12345)])
def test_reduce_float32_same_on_every_call(dev, shape):
    x = make(shape, torch.float32, dev)
    first = ops.reduce_sum(x)
    for _ in range(2):
        assert torch.equal(ops.reduce_sum(x), first)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_reduce_unaligned_view(dev, dtype):
    """A base 4 bytes past a 16-byte boundary and rows of odd length: each
    row starts on another alignment, its head and tail added by scalar
    loads."""
    x = make((3 * 5001 + 1,), dtype, dev, lo=-1000, hi=1000)[1:].view(3, 5001)
    assert x.data_ptr() % 16 == 4
    want = kred.plain(torch.nn.functional.pad(x, (0, 8192 - 5001)), 4096)
    floats = dtype == torch.float32
    close(ops.reduce_sum(x), want, 1e-6 * x.abs().sum(-1) if floats else 0)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_reduce_one_bank_4194304(dev, dtype):
    """The suite's 1-bank shape: one bank cut into many spans, whose
    partials the last block sums."""
    x = make((1, 1 << 22), dtype, dev, lo=-1000, hi=1000)
    floats = dtype == torch.float32
    close(ops.reduce_sum(x), kred.plain(x, 4096),
          1e-6 * x.abs().sum(-1) if floats else 0)


def test_reduce_on_two_streams(dev):
    """Reductions in flight at once on two streams: each call has its own
    arrival counters."""
    a = make((1, 1 << 22), torch.int32, dev, lo=-9, hi=9)
    b = make((300, 1 << 15), torch.float32, dev)
    want_a, want_b = wrapped_sum(a), ops.reduce_sum(b)
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        with torch.cuda.stream(s1):
            ra = ops.reduce_sum(a)
        with torch.cuda.stream(s2):
            rb = ops.reduce_sum(b)
        outs.append((ra, rb))
    torch.cuda.synchronize()
    for ra, rb in outs:
        close(ra, want_a)
        assert torch.equal(rb, want_b)


# -- scan: the single-pass look-back -------------------------------------------------

def scan_both(x):
    """The kernel's inclusive and exclusive scans of ``x`` against the
    plain version (int32 exact, float32 within 1e-6 * sum |x| over the
    prefix); the exclusive int32 scan also bit for bit against the
    formula ``scan_inclusive(x) - x``."""
    n = x.shape[-1]
    b = min(4096, max(128, 1 << (n - 1).bit_length()))
    want = kscan.plain(torch.nn.functional.pad(x, (0, (-n) % b)), b)[:, :n]
    floats = x.dtype == torch.float32
    cum = 1e-6 * x.abs().cumsum(-1) if floats else 0
    close(ops.scan_inclusive(x), want, cum)
    ex = ops.scan_exclusive(x)
    close(ex, want - x, cum)
    if not floats:
        assert torch.equal(ex, ops.scan_inclusive(x) - x)


@pytest.mark.parametrize("shape", [(1, 1 << 22), (1, (1 << 24) + 123),
                                   (2048, 32768), (5, 4100)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_scan_look_back_chains(dev, shape, dtype):
    """A bank of 2^22 values is 512 tiles of 8,192 whose prefixes chain
    through the look-back; 2^24 + 123 ends in a ragged tile; 2,048 banks
    of 4 tiles each must never look back into the bank before; 4,100
    values are padded to 8,192, one ragged tile a bank."""
    scan_both(make(shape, dtype, dev, lo=-50, hi=50))


def test_scan_int32_wraps_across_tile_borders(dev):
    """Prefixes pass 2^31 inside tiles and at their borders, and the
    look-back adds wrapped tile totals: uint32 arithmetic, exact."""
    t = kscan.TILE
    x = torch.full((3, 5 * t), (1 << 31) - 1, device=dev, dtype=torch.int32)
    x[:, t - 1::t] = 1 << 30
    scan_both(x)


def test_scan_int32_same_on_every_call(dev):
    x = make((64, 1 << 16), torch.int32, dev, lo=-1000, hi=1000)
    first = ops.scan_inclusive(x)
    for _ in range(2):
        assert torch.equal(ops.scan_inclusive(x), first)
    first = ops.scan_exclusive(x)
    for _ in range(2):
        assert torch.equal(ops.scan_exclusive(x), first)


def test_scan_calls_in_a_row_reuse_the_status_words(dev):
    """Back-to-back calls without a synchronize: the caching allocator
    hands the second call the first call's (cleared) status words."""
    xs = [make((16, 40000), torch.int32, dev, lo=i, hi=100 + i)
          for i in range(3)]
    outs = [ops.scan_exclusive(x) for x in xs] + [ops.scan_inclusive(x)
                                                  for x in xs]
    for x, ex, inc in zip(xs, outs[:3], outs[3:]):
        close(inc, x.cumsum(-1, dtype=torch.int32))
        close(ex, x.cumsum(-1, dtype=torch.int32) - x)


def test_scan_on_two_streams(dev):
    """Two scans in flight at once on two streams: each has its own
    status words and tile counter."""
    a = make((1, 1 << 23), torch.int32, dev, lo=-9, hi=9)
    b = make((300, 1 << 15), torch.int32, dev, lo=0, hi=5)
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        with torch.cuda.stream(s1):
            ya = ops.scan_inclusive(a)
        with torch.cuda.stream(s2):
            yb = ops.scan_exclusive(b)
        outs.append((ya, yb))
    torch.cuda.synchronize()
    for ya, yb in outs:
        close(ya, a.cumsum(-1, dtype=torch.int32))
        close(yb, b.cumsum(-1, dtype=torch.int32) - b)


def test_scan_refuses_bad_inputs(dev):
    with pytest.raises(TypeError):
        kscan.scan_inclusive(make((2, 128), torch.int32, dev).to(torch.int64),
                             block=128)
    with pytest.raises(ValueError):
        kscan.scan_inclusive(make((2, 130), torch.int32, dev), block=130)
    odd = make((1, 129), torch.int32, dev)[:, 1:]     # contiguous, 4 B off
    close(kscan.scan_inclusive(odd, block=128), kscan.plain(odd, 128))


@pytest.mark.parametrize("n,nbins", [(4096, 256), (10000, 64), (500, 1024),
                                     (3000, 20000)])
def test_histogram_matches_plain(dev, n, nbins):
    v = make((4, n), torch.int32, dev, lo=-5, hi=nbins + 5)
    close(ops.histogram(v, nbins), khist.plain(v, nbins, 4096))


@pytest.mark.parametrize("m,n", [(128, 512), (64, 64), (100, 300),
                                 (7, 1000), (33, 5000), (1, 256), (7, 256),
                                 (33, 256), (33, 9000), (2048 * 256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemv_matches_plain(dev, m, n, dtype):
    """Three banks of (m, n): n = 256 (the suite's), n past one shared-memory
    tile of x (9000), rows that are no multiple of a warp's row group, and
    the suite's 2,048 x 256 rows a bank (a grid of 24,576 blocks)."""
    a = make((3, m, n), dtype, dev)
    x = make((n,), dtype, dev)
    got = ops.gemv(a, x)
    want = kgemv.plain(a.reshape(-1, n), x).reshape(3, m)
    close(got, want, rel(want, 2e-2 if dtype == torch.bfloat16 else 1e-4))


@pytest.mark.parametrize("shape", [(2048, 256, 256), (3, 33, 9000)])
def test_gemv_float32_same_on_every_call(dev, shape):
    """A row's sum order depends only on n (no atomics): bit for bit over
    3 calls, on the short-row path and the tiled long-row path."""
    a = make(shape, torch.float32, dev)
    x = make(shape[-1:], torch.float32, dev)
    first = ops.gemv(a, x)
    assert all(torch.equal(ops.gemv(a, x), first) for _ in range(2))


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
    qkv = make((1, 2, 16, 64), torch.float32, dev)
    ops.attention(qkv, qkv, qkv)
    ops.moe_gmm(make((2, 8, 16), torch.float32, dev),
                make((2, 16, 8), torch.float32, dev),
                torch.tensor([3, 8], dtype=torch.int32, device=dev))
    ops.ssd_scan(make((1, 16, 2, 8), torch.float32, dev),
                 torch.full((1, 16, 2), 0.5, device=dev),
                 make((1, 16, 4), torch.float32, dev),
                 make((1, 16, 4), torch.float32, dev))
    assert ops.launch_counts() == {"reduce_sum": 1, "scan_inclusive": 1,
                                   "histogram": 1, "gemv": 1, "spmv_ell": 1,
                                   "flash_attention": 1, "moe_gmm": 1,
                                   "ssd_scan": 1}
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


@pytest.mark.parametrize("k", [4, 8, 16, 32, 12, 64, 5])
@pytest.mark.parametrize("n", [256, 8192, 10000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmv_lane_paths(dev, k, n, dtype):
    """k % 4 == 0 reads a row with min(k / 4, 8) lanes (the power of two
    below: 2 at k = 12, 8 at k = 64, looping), k = 5 one thread a row; x
    up to 8,192 values is staged in shared memory, 10,000 is gathered
    through __ldg.  Columns past n read x[n-1]; an inf in a padded slot is
    skipped."""
    cols = make((2, 3000, k), torch.int32, dev, lo=-1, hi=n + 4)
    vals = make((2, 3000, k), torch.float32, dev)
    vals = torch.where(cols < 0, float("inf"), vals).to(dtype)
    x = make((n,), torch.float32, dev)
    got = ops.spmv_ell(vals, cols, x)
    want = kspmv.plain(vals.view(-1, k), cols.view(-1, k), x).view(2, 3000)
    assert torch.isfinite(got.float()).all()
    close(got, want, rel(want, 2e-2 if dtype == torch.bfloat16 else 1e-4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmv_unaligned_views(dev, dtype):
    """vals and cols that start 4 or 2 bytes past an alignment take the
    one-thread-a-row path with scalar loads."""
    rows, k, n = 999, 8, 300
    cbuf = make((rows * k + 1,), torch.int32, dev, lo=-1, hi=n + 2)
    vbuf = make((rows * k + 1,), torch.float32, dev).to(dtype)
    cols, vals = cbuf[1:].view(rows, k), vbuf[1:].view(rows, k)
    x = make((n,), torch.float32, dev)
    got = kspmv.spmv_ell(vals, cols, x)
    want = kspmv.plain(vals, cols, x)
    close(got, want, rel(want, 2e-2 if dtype == torch.bfloat16 else 1e-4))


def test_spmv_refuses_bad_inputs(dev):
    v = make((4, 8), torch.float32, dev)
    c = make((4, 8), torch.int32, dev, hi=8)
    with pytest.raises(TypeError):
        kspmv.spmv_ell(v, c.to(torch.int64), make((8,), torch.float32, dev))
    with pytest.raises(ValueError):
        kspmv.spmv_ell(v, c[:2], make((8,), torch.float32, dev))


# -- flash_attention -----------------------------------------------------------------

FLASH_CASES = [   # B, H, KVH, S, T, D, causal, window
    (1, 4, 4, 128, 128, 64, True, None),       # MHA, causal
    (2, 8, 2, 200, 200, 80, True, None),       # GQA, ragged tiles
    (1, 8, 1, 64, 64, 120, True, None),        # MQA, danube head dim
    (1, 3, 3, 96, 48, 160, False, None),       # S != T, stablelm head dim
    (1, 4, 2, 100, 37, 128, True, None),       # S > T: 63 rows fully masked
    (1, 4, 2, 37, 100, 64, True, None),        # S < T, offset queries
    (1, 4, 2, 300, 300, 64, True, 16),         # window 16
    (1, 4, 2, 300, 300, 120, True, 100),       # window, danube head dim
    (1, 4, 4, 130, 130, 64, False, 16),        # window without causal
    (1, 2, 1, 70, 70, 5, True, None),          # head dim not a multiple of 4
    (1, 2, 2, 64, 64, 256, True, None),        # the largest head dim
    (1, 2, 1, 64, 64, 8, True, None),          # D 8: one 16-byte row
    (1, 2, 1, 200, 200, 64, True, None),       # S no multiple of the 128-row tile
    (1, 4, 2, 130, 300, 120, True, None),      # S < T: offset queries, D 120
    (1, 4, 2, 300, 130, 128, True, None),      # S > T: 170 rows see no key
    (1, 2, 2, 333, 333, 160, True, None),      # D 160, ragged S
    (1, 2, 1, 200, 200, 256, True, None),      # D 256, ragged S
    (1, 4, 2, 400, 400, 64, True, 100),        # window edge inside a key tile
    (1, 2, 2, 256, 300, 120, False, 50),       # window, not causal, S != T
    (2, 16, 2, 256, 256, 128, True, None),     # B 2, GQA groups of 8
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(dev, case, dtype):
    B, H, KVH, S, T, D, causal, window = case
    g = torch.Generator(device=dev).manual_seed(S * T + D)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((B, H, S, D), (B, KVH, T, D), (B, KVH, T, D)))
    got = ops.attention(q, k, v, causal=causal, window=window)
    want = kfa.plain(q, k, v, causal=causal, window=window)
    close(got, want, rel(want, 2e-2 if dtype == torch.bfloat16 else 2e-3))
    if causal and S > T:
        assert bool((got[:, :, :S - T] == 0).all())   # no live key: 0


def test_flash_attention_takes_strided_inputs_and_refuses(dev):
    x = make((1, 40, 6, 64), torch.float32, dev).transpose(1, 2)  # (1,6,40,64)
    want = kfa.plain(x, x[:, :3], x[:, :3])
    close(ops.attention(x, x[:, :3], x[:, :3]), want, rel(want, 2e-3))
    with pytest.raises(ValueError):
        ops.attention(*(make((1, 2, 8, 300), torch.float32, dev),) * 3)
    with pytest.raises(TypeError):
        kfa.flash_attention(x, x.half(), x)


def test_flash_attention_bf16_unaligned_storage(dev):
    """Contiguous views whose data starts 2 bytes past a 16-byte boundary:
    the wrapper copies them for the TMA, and the result is the plain one."""
    B, H, KVH, S, T, D = 1, 4, 2, 150, 150, 64
    g = torch.Generator(device=dev).manual_seed(11)
    views = []
    for shape in ((B, H, S, D), (B, KVH, T, D), (B, KVH, T, D)):
        n = int(np.prod(shape))
        buf = torch.randn(n + 1, generator=g, device=dev).to(torch.bfloat16)
        views.append(buf[1:].view(shape))
    q, k, v = views
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in views)
    want = kfa.plain(q, k, v)
    close(ops.attention(q, k, v), want, rel(want, 2e-2))


def test_forward_with_kernel_launches_once_per_layer(dev):
    cfg = get_config("tinyllama-1.1b", smoke=True)
    model = transformer.init(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab, (2, 50), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    ops.reset_launch_counts()
    got, _ = transformer.forward(model, cfg, toks, use_kernel=True)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    want, _ = transformer.forward(model, cfg, toks)
    close(got, want, rel(want, 1e-3))


# -- moe_gmm ---------------------------------------------------------------------------

GMM_CASES = [   # E, C, d, f
    (4, 64, 96, 160),        # the reference's sweep
    (8, 128, 128, 128),
    (2, 16, 64, 48),
    (3, 100, 200, 300),      # C, d, f no multiple of any tile
    (2, 240, 2048, 2816),    # DeepSeek-MoE's up projection, 2 experts
    (1, 37, 13, 9),          # d, f odd: no 16-byte loads
    (4, 240, 256, 384),      # DeepSeek's capacity: one row tile spans it
    (3, 320, 512, 256),      # Jamba's capacity: three row tiles share a panel
    (2, 100, 200, 136),      # d no multiple of the 64-wide step, f of 128
    (2, 64, 96, 72),         # f below one column tile
]


@pytest.mark.parametrize("case", GMM_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_matches_plain(dev, case, dtype):
    """Counts 0, C and ragged ones: dead rows come out 0 from an output the
    kernel allocates with torch.empty."""
    E, C, d, f = case
    g = torch.Generator(device=dev).manual_seed(E * C + d + f)
    x = torch.randn((E, C, d), generator=g, device=dev).to(dtype)
    w = torch.randn((E, d, f), generator=g, device=dev).to(dtype)
    cnt = torch.randint(0, C + 1, (E,), generator=g, device=dev,
                        dtype=torch.int32)
    cnt[0] = 0
    if E > 1:
        cnt[1] = C
    got = ops.moe_gmm(x, w, cnt)
    want = kgmm.plain(x, w, cnt)
    close(got, want, rel(want, 5e-2 if dtype == torch.bfloat16 else 1e-3))
    assert bool((got[0] == 0).all())


def test_moe_gmm_bf16_counts_at_tile_edges(dev):
    """64 experts at capacity 320: counts 0, partial, exactly at a 64-row
    sub-tile or a 256-row tile boundary, past C, negative and C; every dead
    row is 0 in an output that starts as torch.empty."""
    E, C, d, f = 64, 320, 128, 128
    g = torch.Generator(device=dev).manual_seed(64)
    x = torch.randn((E, C, d), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((E, d, f), generator=g, device=dev).to(torch.bfloat16)
    edges = [0, 1, 37, 63, 64, 65, 128, 192, 255, 256, 257, 319, 320, 999, -5]
    cnt = torch.randint(0, C + 1, (E,), generator=g, device=dev,
                        dtype=torch.int32)
    cnt[:len(edges)] = torch.tensor(edges, dtype=torch.int32, device=dev)
    got = ops.moe_gmm(x, w, cnt)
    want = kgmm.plain(x, w, cnt)
    close(got, want, rel(want, 5e-2))
    for e, c in enumerate(cnt.clamp(0, C).tolist()):
        assert bool((got[e, c:] == 0).all()), e


def test_moe_gmm_refuses_bad_inputs(dev):
    x = make((2, 8, 16), torch.float32, dev)
    w = make((2, 16, 4), torch.float32, dev)
    cnt = torch.tensor([8, 8], dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kgmm.moe_gmm(x, w.to(torch.bfloat16), cnt)
    with pytest.raises(ValueError):
        kgmm.moe_gmm(x, w[:, :8], cnt)
    with pytest.raises(ValueError):         # a CPU operand never reaches it
        kgmm.moe_gmm(x, w.cpu(), cnt)


# -- ssd_scan ----------------------------------------------------------------------------

SSD_CASES = [   # B, S, H, P, N, chunk
    (2, 256, 3, 32, 16, 64),     # the reference's sweep
    (1, 128, 1, 64, 8, 128),
    (1, 100, 2, 16, 4, 32),      # S no multiple of the chunk
    (1, 2048, 8, 64, 16, 128),   # the Jamba cut's shape, 8 of its 256 heads
    (2, 5, 3, 8, 4, 128),        # S below 8: the chunk clamps to 8
    (2, 2048, 8, 64, 16, 128),   # many chunks, B > 1
    (1, 256, 5, 64, 16, 64),     # H = 5: no multiple of the 4-head block
    (1, 1000, 4, 64, 16, 64),    # chunk 64, a ragged tail of 40 steps
]


def ssd_inputs(case, dtype, dev):
    B, S, H, P, N, _ = case
    g = torch.Generator(device=dev).manual_seed(S * H + P)
    x = torch.randn((B, S, H, P), generator=g, device=dev).to(dtype)
    a = torch.rand((B, S, H), generator=g, device=dev) * 0.7 + 0.3
    b = torch.randn((B, S, N), generator=g, device=dev).to(dtype)
    c = torch.randn((B, S, N), generator=g, device=dev).to(dtype)
    return x, a, b, c


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_matches_plain(dev, case, dtype):
    x, a, b, c = ssd_inputs(case, dtype, dev)
    chunk = case[-1]
    y, h = ops.ssd_scan(x, a, b, c, chunk=chunk)
    assert y.dtype == dtype and h.dtype == torch.float32
    want_y, want_h = kmamba.plain(x, a, b, c)
    ytol = 2e-2 if dtype == torch.bfloat16 else 5e-3
    close(y, want_y, rel(want_y, ytol))
    close(h, want_h, rel(want_h, 5e-3))
    S = x.shape[1]
    ch = min(chunk, max(8, 1 << (S - 1).bit_length()))
    cy, chh = kmamba.chunked(x, a, b, c, ch)
    close(y, cy, rel(cy, 2e-2 if dtype == torch.bfloat16 else 1e-3))
    close(h, chh, rel(chh, 1e-3))


def test_ssd_scan_refuses_bad_inputs(dev):
    x, a, b, c = ssd_inputs((1, 64, 2, 8, 4, 64), torch.float32, dev)
    with pytest.raises(TypeError):          # a must be float32
        kmamba.ssd_scan(x, a.double(), b, c, chunk=64)
    with pytest.raises(ValueError):         # the chunk's tiles exceed 227 KB
        kmamba.ssd_scan(x, a, b, c, chunk=512)
    with pytest.raises(ValueError):         # a CPU operand never reaches it
        kmamba.ssd_scan(x, a.cpu(), b, c, chunk=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_on_a_ranks_columns_of_cut_heads(dev, dtype):
    """The kernel on each rank's own columns of Mamba heads that a "model"
    axis cuts: jamba SMOKE with ``ssm_expand=3`` and heads of 64 (3 heads,
    di 192) over 4 ranks, 48 columns a rank — (1, S, 1, 48) on ranks 0
    and 3, (1, S, 2, 32) with 16 zero columns on ranks 1 and 2
    (``layers.padded_layout``) — at a prefill of 2,048 (16 chunks of
    128): against plain at 5e-3 (y at 2e-2 in bfloat16), and its own
    columns against those of the whole heads' plain scan; the zero
    columns give zeros."""
    from repro_torch.models import layers
    H, P, M = 3, 64, 4
    x, a, b, c = ssd_inputs((1, 2048, H, P, 8, 128), dtype, dev)
    ytol = 2e-2 if dtype == torch.bfloat16 else 5e-3
    whole = kmamba.plain(x, a, b, c)[0].flatten(-2)
    for r in range(M):
        sp = layers.head_split(H, P, M, r)
        lay = layers.padded_layout(sp)
        xr = layers.pad_heads(x.flatten(-2)[..., sp.cols], lay)
        ar = a[..., sp.heads].contiguous()
        y, h = ops.ssd_scan(xr, ar, b, c, chunk=128)
        assert y.shape == (1, 2048, sp.n, lay[0])
        want_y, want_h = kmamba.plain(xr, ar, b, c)
        close(y, want_y, rel(want_y, ytol))
        close(h, want_h, rel(want_h, 5e-3))
        want = whole[..., sp.cols]
        close(layers.own_columns(y.flatten(-2), lay), want, rel(want, ytol))
        pad = layers.pad_heads(torch.ones(sp.cols.stop - sp.cols.start,
                                          device=dev), lay) == 0
        assert pad.any() == (r in (1, 2))
        assert not y[..., pad].any() and not h.transpose(1, 2)[..., pad].any()


# -- the MoE and hybrid forwards --------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b",
                                  "jamba-1.5-large-398b"])
def test_moe_and_hybrid_forward_launch_the_kernels(dev, arch):
    """``forward(use_kernel=True)`` on the card: moe_gmm twice per MoE
    layer, ssd_scan once per Mamba layer, flash_attention once per
    attention layer; logits against the plain forward (float32; rtol =
    atol = 1e-3, jamba's chunked against sequential scan at 5e-3)."""
    cfg = get_config(arch, smoke=True)
    model = transformer.init(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    ops.reset_launch_counts()
    got, aux = transformer.forward(model, cfg, toks, use_kernel=True)
    counts = ops.launch_counts()
    descs = [b.desc for b in model.layers]
    assert counts["moe_gmm"] == 2 * sum(d["ffn"] == "moe" for d in descs)
    assert counts["ssd_scan"] == sum(d["mixer"] == "mamba" for d in descs)
    assert counts["flash_attention"] == sum(d["mixer"] == "attn"
                                            for d in descs)
    want, want_aux = transformer.forward(model, cfg, toks)
    tol = 5e-3 if arch.startswith("jamba") else 1e-3
    close(got, want, rel(want, tol))
    close(aux, want_aux, rel(want_aux, 1e-5))


# -- the VLM and xLSTM families -------------------------------------------------------

def test_vision_forward_launches_the_kernel_on_self_attention_only(dev):
    """llama-vision SMOKE on the card: ``forward(use_kernel=True,
    frontend=)`` runs flash_attention once per self-attention layer (the
    cross layer runs the plain attention, as the reference's does);
    logits against the plain forward (float32, rtol = atol = 1e-3, as the
    TinyLlama case)."""
    cfg = get_config("llama-3.2-vision-11b", smoke=True)
    model = transformer.init(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=dev, generator=g)
    fr = torch.randn((2, cfg.n_frontend_tokens, cfg.d_model), device=dev,
                     generator=g)
    ops.reset_launch_counts()
    got, _ = transformer.forward(model, cfg, toks, frontend=fr,
                                 use_kernel=True)
    assert ops.launch_counts()["flash_attention"] == sum(
        b.desc["mixer"] == "attn" for b in model.layers) == 4
    want, _ = transformer.forward(model, cfg, toks, frontend=fr)
    close(got, want, rel(want, 1e-3))


def test_xlstm_on_the_card_matches_the_cpu(dev):
    """xlstm SMOKE (3 mLSTM blocks, then an sLSTM), parallel and chunked
    mLSTM: the same weights on the card and on the CPU give the same
    logits, and so does teacher-forced decode (float32, rtol = atol =
    1e-3: the card sums in another order, and its expf / logf differ in
    the last bits)."""
    import dataclasses
    base = get_config("xlstm-125m", smoke=True)
    cpu_model = transformer.init(base, seed=0, device="cpu")
    card_model = transformer.init(base, seed=0, device="cpu").to(dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, base.vocab, (2, 32)).astype(np.int32))
    for chunk in (0, 8):
        cfg = dataclasses.replace(base, mlstm_chunk=chunk)
        want, _ = transformer.forward(cpu_model, cfg, toks)
        got, _ = transformer.forward(card_model, cfg, toks.to(dev))
        assert got.is_cuda
        close(got.cpu(), want, rel(want, 1e-3))
    ccache = transformer.init_cache(cpu_model, base, 2, 8)
    gcache = transformer.init_cache(card_model, base, 2, 8)
    for i in range(8):
        want, ccache = transformer.decode_step(cpu_model, base,
                                               toks[:, i:i + 1], ccache)
        got, gcache = transformer.decode_step(card_model, base,
                                              toks[:, i:i + 1].to(dev), gcache)
        close(got.cpu(), want, rel(want, 1e-3))


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


NEW_WORKLOADS = ("VA", "SEL", "UNI", "BS", "TS", "BFS", "MLP", "NW", "TRNS")


@pytest.mark.parametrize("name", NEW_WORKLOADS)
def test_workload_on_the_card_matches_ref(dev, name):
    """Each workload's serialized ``pim`` on 64 banks of the card, and its
    chunked phases where it has them, at make_args scale 2."""
    from repro_torch import make_bank_grid
    entry = REGISTRY[name]
    args = entry.make_args(np.random.default_rng(zlib.crc32(name.encode())),
                           scale=2)
    gold = entry.ref(*args)
    g = make_bank_grid(64, device=dev)
    out, times = entry.pim(g, *args)
    entry.compare(out, gold)
    assert times.total > 0
    if entry.chunked is not None:
        w = entry.chunked
        meta, chunks = w.split(g, 3, *args)
        parts = [w.retrieve(g, meta, w.compute(g, meta, w.scatter(g, meta, c)))
                 for c in chunks]
        entry.compare(w.merge(g, meta, parts), gold)


def test_session_pipelined_matches_ref(dev):
    with pim.session(ranks=2, banks_per_rank=4) as s:
        for name, entry in pim.registry().items():
            rng = np.random.default_rng(zlib.crc32(name.encode()))
            args = entry.make_args(rng, scale=4)
            entry.compare(s.submit(name, *args).result(timeout=120),
                          entry.ref(*args))
            entry.compare(s.submit(name, *args).result(timeout=120),
                          entry.ref(*args))          # warm where resident
        # GEMV, GEMV-B, GEMV-G, SpMV, BS and MLP
        assert s.stats()["cache"]["hits"] == 6


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


# -- characterization and the autotuner on the card --------------------------------

def test_async_transfers_match_the_sync_ones(dev):
    """push_*_async stage through pinned staging on each rank's h2d stream
    and pull_*_async copy on its d2h stream: the same arrays as the
    synchronous transfers, device work on the current stream ordered after
    the push."""
    from repro_torch.core import transfer as tx
    g = make_rank_grid(4, 2, device=dev)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 99, (8, 4096)).astype(np.int32)
    sync, _ = tx.push_parallel(g, x)
    out, rec = tx.push_parallel_async(g, x)
    assert rec.kind == "cpu_dpu_async" and out.is_cuda
    assert torch.equal(out + 0, sync)            # ordered on this stream
    assert g.streams.stage.allocations >= 1
    host, rec = tx.pull_async(out * 2, g)()
    np.testing.assert_array_equal(host, tx.pull_parallel(g, sync * 2)[0])
    assert rec.kind == "dpu_cpu_async"
    per_rank = [rng.normal(size=(2, 1024)).astype(np.float32)
                for _ in range(4)]
    outs, rec = tx.push_ranks_async(g, per_rank)
    assert rec.kind == "cpu_dpu_rank_async"
    hosts, rec = tx.pull_ranks_async([o + 1 for o in outs], g)()
    assert rec.kind == "dpu_cpu_rank_async"
    for h, x in zip(hosts, per_rank):
        np.testing.assert_array_equal(h, x + 1)
    assert all(v.streams.stage.allocations >= 1 for v in g.rank_views)


def test_profile_workload_scatters_through_pinned_staging(dev):
    """The autotuner times each stage as the pipeline runs it: the
    scatter goes through the grid's pinned staging, not a pageable copy."""
    from repro_torch.core.banked import make_bank_grid
    from repro_torch.runtime.autotune import profile_workload
    g = make_bank_grid(8, device=dev)
    entry = REGISTRY["GEMV"]
    args = entry.make_args(np.random.default_rng(0), scale=8)
    before = g.streams.stage.allocations + g.streams.stage.reuses
    prof = profile_workload(g, entry, args, reps=2)
    staged = g.streams.stage.allocations + g.streams.stage.reuses - before
    assert g.streams.stage.allocations >= 1
    assert staged == 2 * (1 + 2)         # two chunk counts, warm-up + reps
    for fit in (prof.push, prof.compute, prof.pull):
        assert fit.alpha_s >= 0 and fit.bytes_per_s > 0
    assert prof.serialized_s > 0


def test_session_autotune_on_the_card(dev):
    with pim.session(banks=8, autotune={"scale": 4, "reps": 1,
                                        "probe": True}) as s:
        assert set(s.plans) == set(pim.registry()) - {"NW", "BFS"}
        for name, plan in s.plans.items():
            assert plan.measured_s[plan.n_chunks] <= plan.measured_s[4], name
            entry = pim.registry()[name]
            args = entry.make_args(np.random.default_rng(1), scale=4)
            entry.compare(s.run(name, *args), entry.ref(*args))


# -- the tune phase's device-side assert (ROADMAP queue 3) -------------------------

#: (banks, make_args scale, iterations) of the loop: the 8-bank session of
#: test_session_autotune_on_the_card and the 2,048 banks of chip_smoke.py's
#: tune phase, the two runs that hit the assert once
FAULT_SHAPES = {"8 banks, scale 4": (8, 4, 20),
                "2,048 banks, scale 1024": (2048, 1024, 3)}


def fault_loop(banks: int, scale: int, iters: int) -> None:
    """What ran up to the assert, ``iters`` times on one flat grid:
    GEMV-G's ``profile_workload`` and its chunk probes (``probe_plan``),
    then SpMV's serialized ``pim()`` (its plain gather) held to ``ref()``,
    then SpMV's own ``profile_workload``."""
    from repro_torch.core.banked import make_bank_grid
    from repro_torch.runtime.autotune import (plan_for, probe_plan,
                                              profile_workload)
    g = make_bank_grid(banks)
    rng = np.random.default_rng(0)
    gemv_g, spmv = REGISTRY["GEMV-G"], REGISTRY["SpMV"]
    gargs, sargs = gemv_g.make_args(rng, scale), spmv.make_args(rng, scale)
    want = spmv.ref(*sargs)
    for _ in range(iters):
        plan = plan_for(profile_workload(g, gemv_g, gargs, reps=1))
        probe_plan(g, gemv_g, plan, [gargs])
        out, _ = spmv.pim(g, *sargs)
        torch.cuda.synchronize()
        spmv.compare(out, want)
        profile_workload(g, spmv, sargs, reps=1)
        torch.cuda.synchronize()


@pytest.mark.parametrize("allocator", ["caching", "no caching"])
@pytest.mark.parametrize("shape", list(FAULT_SHAPES))
def test_gemv_g_probes_then_spmv_pim_loop(dev, shape, allocator):
    """The sequence of the device-side "index out of bounds" assert that
    one run of the tune phase hit (ROADMAP queue 3), in a loop; with
    ``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` too (in a process of its own:
    the allocator is chosen when CUDA starts), where a block freed while
    another stream still uses it goes to cudaFree instead of to the next
    tensor.  The 2,048-bank loop needs a card of 40 GiB."""
    banks, scale, iters = FAULT_SHAPES[shape]
    if banks > 8 and torch.cuda.get_device_properties(dev).total_memory \
            < 40 * 2**30:
        pytest.skip("not verified on GPU: the 2,048-bank loop needs 40 GiB")
    if allocator == "caching":
        fault_loop(banks, scale, iters)
        return
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = {**os.environ, "PYTORCH_NO_CUDA_MEMORY_CACHING": "1",
           "PYTHONPATH": os.pathsep.join(
               [src] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    run = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--fault-loop", str(banks), str(scale),
                          str(max(1, iters // 4))],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]


# -- the training path ------------------------------------------------------------------

def trainable_pair(dev, arch="tinyllama-1.1b"):
    """The SMOKE config (float32) and one seeded trainable model on the
    card and a copy on the CPU."""
    from repro_torch.launch import train

    cfg = get_config(arch, smoke=True)
    card, _ = train.init_state(0, cfg, dev)
    host = transformer.Transformer(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    return cfg, card, host.requires_grad_(True)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """float32 SMOKE, the same weights and batch: the loss at 1e-5 and each
    gradient leaf at 1e-4 of its largest |g|; after one AdamW step the
    parameters at the reference's rtol = atol = 5e-3 (a tiny gradient whose
    sign a rounding flips moves a parameter by 2 lr)."""
    from repro_torch import optim
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch import train

    cfg, card, host = trainable_pair(dev)
    b = make_batch(cfg, DataConfig(seed=0, batch=2, seq=32), 0)
    out = []
    for model, where in ((card, dev), (host, torch.device("cpu"))):
        loss, _ = transformer.loss_fn(model, cfg, train.to_device(b, cfg, where))
        named = dict(model.named_parameters())
        out.append((loss.detach().cpu(), {k: g.cpu() for k, g in zip(
            named, torch.autograd.grad(loss, list(named.values())))}))
    (lc, gc), (lh, gh) = out
    assert abs(float(lc) - float(lh)) <= 1e-5
    for k, g in gh.items():
        assert float((gc[k] - g).abs().max()) <= 1e-4 * float(g.abs().max()), k
    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    for model, where in ((card, dev), (host, torch.device("cpu"))):
        opt = optim.init(dict(model.named_parameters()))
        train.make_train_step(cfg, ocfg)(model, opt,
                                         train.to_device(b, cfg, where))
    for (k, a), (_, w) in zip(card.named_parameters(), host.named_parameters()):
        assert torch.allclose(a.detach().cpu(), w.detach(), rtol=5e-3,
                              atol=5e-3), k


def test_kernel_wrappers_refuse_autograd_inputs(dev):
    """A kernel's output has no ``grad_fn``: under grad, flash_attention,
    moe_gmm and ssd_scan refuse an input that requires grad, and so does
    ``loss_fn(use_kernel=True)`` of a trainable model; under
    ``torch.no_grad()`` the same calls run."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((1, 4, 16, 64), generator=g, device=dev)
    kv = torch.randn((1, 2, 16, 64), generator=g, device=dev)
    xg = torch.randn((2, 8, 16), generator=g, device=dev)
    w = torch.randn((2, 16, 24), generator=g, device=dev)
    cnt = torch.tensor([8, 3], dtype=torch.int32, device=dev)
    x = torch.randn((1, 32, 2, 8), generator=g, device=dev)
    a = torch.rand((1, 32, 2), generator=g, device=dev)
    bc = torch.randn((1, 32, 4), generator=g, device=dev)
    for call, t in ((lambda t: kfa.flash_attention(t, kv, kv), q),
                    (lambda t: kgmm.moe_gmm(t, w, cnt), xg),
                    (lambda t: kmamba.ssd_scan(t, a, bc, bc, chunk=16), x)):
        leaf = t.clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            call(leaf)
        with torch.no_grad():
            call(leaf)
    cfg, card, _ = trainable_pair(dev)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    with pytest.raises(RuntimeError, match="no backward"):
        transformer.loss_fn(card, cfg, batch, use_kernel=True)
    with torch.no_grad():
        transformer.loss_fn(card, cfg, batch, use_kernel=True)


def restart_check(steps: int = 6) -> None:
    """SMOKE ``fit`` for ``steps`` steps uninterrupted against half of
    them with an async checkpoint and a resumed ``fit``: every parameter
    and the optimizer state equal."""
    import tempfile

    from repro_torch import optim
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import DataConfig, Loader
    from repro_torch.launch import train

    cfg = get_config("tinyllama-1.1b", smoke=True)
    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)

    def fit(n, ck=None, every=0):
        return train.fit(cfg, steps=n, data_loader=Loader(
            cfg, DataConfig(batch=2, seq=64)), ocfg=ocfg, checkpointer=ck,
            checkpoint_every=every, log_every=0, device="cuda")

    full, full_opt, hist = fit(steps)
    with tempfile.TemporaryDirectory() as d:
        fit(steps // 2, Checkpointer(d, async_mode=True), steps // 2)
        res, res_opt, res_hist = fit(steps, Checkpointer(d))
    assert res_hist == hist[steps // 2:], (res_hist, hist)
    for (k, a), (_, b) in zip(full.named_parameters(), res.named_parameters()):
        assert torch.equal(a, b), k
    for part in ("master", "mu", "nu"):
        for k, a in full_opt[part].items():
            assert torch.equal(a, res_opt[part][k]), (part, k)


def test_restart_is_bit_exact_in_a_subprocess(dev):
    """``restart_check`` in a process started with
    CUBLAS_WORKSPACE_CONFIG=:4096:8 that turns on deterministic algorithms
    before its first CUDA call (the embedding's backward accumulates with
    ``index_put``, non-deterministic on CUDA without them)."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
           "PYTHONPATH": os.pathsep.join(
               [src] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    run = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--restart"], env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]


# -- expert parallelism over torch.distributed ------------------------------------

def _ep_forward_rank(rank: int, toks, per_rank_card: bool):
    """DeepSeek SMOKE with ``moe_ep`` on a (1, 2) mesh: the rank's half of
    the experts, ``forward(use_kernel=True)`` -> (logits, aux, launches)."""
    import dataclasses

    from repro_torch.runtime import elastic

    card = torch.device("cuda", rank if per_rank_card else 0)
    torch.cuda.set_device(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = elastic.carve_mesh(model_parallel=2)
    cfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                              moe_ep=True)
    model = transformer.init(cfg, seed=0, device=card, mesh=mesh)
    ops.reset_launch_counts()
    with torch.no_grad():
        logits, aux = transformer.forward(model, cfg, toks.to(card),
                                          use_kernel=True)
    torch.cuda.synchronize()
    return logits.cpu(), float(aux), ops.launch_counts()


def _ep_forward_against_one_process(dev, per_rank_card: bool, backend: str):
    import dataclasses

    from repro_torch.launch import mesh as lmesh

    cfg = get_config("deepseek-moe-16b", smoke=True)
    toks = torch.randint(0, cfg.vocab, (2, 64), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(3))
    got = lmesh.spawn(_ep_forward_rank, 2, toks, per_rank_card,
                      backend=backend, timeout=300)
    torch.backends.cuda.matmul.allow_tf32 = False
    one = transformer.init(cfg, seed=0, device=dev)
    with torch.no_grad():
        want, aux = transformer.forward(one, cfg, toks.to(dev))
    want = want.cpu()
    for logits, a, counts in got:
        err = (logits - want).abs()
        assert bool((err <= 1e-4 * (1 + want.abs())).all()), float(err.max())
        assert abs(a - float(aux)) <= 1e-5
        assert counts["flash_attention"] == cfg.n_layers, counts
        assert counts["moe_gmm"] == 0 and sum(counts.values()) == \
            cfg.n_layers, counts
    assert dataclasses.replace(cfg, moe_ep=True).moe_experts == 8


def test_expert_parallel_forward_on_one_card_over_gloo(dev):
    """Two ranks on cuda:0 over gloo (CUDA tensors through the host):
    each rank's logits and aux equal the one-process forward's at 1e-4;
    ``flash_attention`` once a layer, ``moe_gmm`` never (``apply_ep``
    multiplies the experts with ``torch.bmm``, as the reference's
    einsums)."""
    _ep_forward_against_one_process(dev, False, "gloo")


def test_expert_parallel_forward_over_nccl(dev):
    """The same over NCCL with a card a rank; NCCL refuses two ranks on
    one card, so a machine with one card skips it (not verified on GPU)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"not verified on GPU: NCCL takes a card a rank and "
                    f"this machine has {n}")
    _ep_forward_against_one_process(dev, True, "nccl")


# -- tensor parallelism over torch.distributed --------------------------------------

#: (arch, ranks): StableLM (parallel_block, kv heads split), TinyLlama over
#: 4 ranks (its 2 kv heads gathered), the Jamba cut (Mamba heads split,
#: ssd_scan on the rank's heads)
TP_CASES = [("stablelm-12b", 2), ("tinyllama-1.1b", 4),
            ("jamba-1.5-large-398b", 2)]


def _tp_cfg(arch: str):
    import dataclasses

    cfg = get_config(arch, smoke=True)
    return dataclasses.replace(cfg, n_layers=2) if cfg.attn_every else cfg


def _tp_forward_rank(rank: int, arch: str, toks, per_rank_card: bool):
    """The SMOKE config on a (1, world) mesh, seeded as one process:
    ``forward(use_kernel=True)`` and ``greedy_generate`` -> (logits,
    tokens, launches of the forward)."""
    import torch.distributed as dist

    from repro_torch.launch import serve
    from repro_torch.runtime import elastic

    card = torch.device("cuda", rank if per_rank_card else 0)
    torch.cuda.set_device(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = elastic.carve_mesh(model_parallel=dist.get_world_size())
    cfg = _tp_cfg(arch)
    model = transformer.init(cfg, seed=0, device=card, mesh=mesh)
    ops.reset_launch_counts()
    with torch.no_grad():
        logits, _ = transformer.forward(model, cfg, toks.to(card),
                                        use_kernel=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    out = serve.greedy_generate(model, cfg, toks[:, :8], 6)
    return logits.cpu(), out.cpu(), counts


def _tp_forward_against_one_process(dev, arch: str, world: int,
                                    per_rank_card: bool, backend: str):
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import serve

    cfg = _tp_cfg(arch)
    toks = torch.randint(0, cfg.vocab, (2, 64), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(5))
    got = lmesh.spawn(_tp_forward_rank, world, arch, toks, per_rank_card,
                      backend=backend, timeout=300)
    torch.backends.cuda.matmul.allow_tf32 = False
    one = transformer.init(cfg, seed=0, device=dev)
    with torch.no_grad():
        want, _ = transformer.forward(one, cfg, toks.to(dev), use_kernel=True)
    tokens = serve.greedy_generate(one, cfg, toks[:, :8], 6).cpu()
    want = want.cpu()
    descs = [b.desc["mixer"] for b in one.layers]
    for logits, out, counts in got:
        err = (logits - want).abs()
        assert bool((err <= 1e-4 * (1 + want.abs())).all()), float(err.max())
        assert torch.equal(out, tokens), (out, tokens)
        assert counts["flash_attention"] == descs.count("attn"), counts
        assert counts["ssd_scan"] == descs.count("mamba"), counts


@pytest.mark.parametrize("arch, world", TP_CASES)
def test_tensor_parallel_forward_on_one_card_over_gloo(dev, arch, world):
    """``world`` ranks on cuda:0 over gloo (CUDA tensors through the host;
    the kv heads' and the logits' gathers as all-reduces of a zero-filled
    whole): each rank's logits equal the one-process forward's at 1e-4,
    its greedy tokens the one process's, and the kernels launch on the
    rank's heads."""
    _tp_forward_against_one_process(dev, arch, world, False, "gloo")


def test_tensor_parallel_forward_over_nccl(dev):
    """StableLM over NCCL with a card a rank; NCCL refuses two ranks on
    one card, so a machine with one card skips it (not verified on GPU)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"not verified on GPU: NCCL takes a card a rank and "
                    f"this machine has {n}")
    _tp_forward_against_one_process(dev, "stablelm-12b", 2, True, "nccl")


# -- the rest of the placement: the experts on "model", FSDP's "data" ------------------

#: (arch, fsdp, model ranks) on 2 ranks: DeepSeek SMOKE as published on
#: (1, 2) (its experts split without moe_ep, ``moe_gmm`` on the rank's 4),
#: TinyLlama SMOKE with ``fsdp`` on (2, 1) (each layer gathered over
#: "data", a row a rank)
PLACEMENT_CASES = [("deepseek-moe-16b", False, 2), ("tinyllama-1.1b", True, 1)]


def _placement_rank(rank: int, arch: str, fsdp: bool, mp: int, toks,
                    per_rank_card: bool):
    """The SMOKE config on a (2 / mp, mp) mesh, seeded as one process:
    ``forward(use_kernel=True)`` of the rank's rows and ``greedy_generate``
    -> (rows, logits, greedy rows, tokens, launches of the forward)."""
    import dataclasses

    from repro_torch.launch import serve, train
    from repro_torch.runtime import elastic

    card = torch.device("cuda", rank if per_rank_card else 0)
    torch.cuda.set_device(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = elastic.carve_mesh(model_parallel=mp)
    cfg = dataclasses.replace(get_config(arch, smoke=True), fsdp=fsdp)
    model = transformer.init(cfg, seed=0, device=card, mesh=mesh)
    rows = train.rows(toks.shape[0], mesh)
    ops.reset_launch_counts()
    with torch.no_grad():
        logits, _ = transformer.forward(model, cfg, toks[rows].to(card),
                                        use_kernel=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    out = serve.greedy_generate(model, cfg, toks[:, :8], 6)
    bm = serve.batch_mesh(mesh, toks.shape[0])
    greedy = (train.rows(toks.shape[0], bm)
              if bm and "data" in bm.mesh_dim_names else slice(None))
    return rows, logits.cpu(), greedy, out.cpu(), counts


def _placement_against_one_process(dev, arch: str, fsdp: bool, mp: int,
                                   per_rank_card: bool, backend: str):
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import serve

    cfg = get_config(arch, smoke=True)
    toks = torch.randint(0, cfg.vocab, (2, 64), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(7))
    got = lmesh.spawn(_placement_rank, 2, arch, fsdp, mp, toks,
                      per_rank_card, backend=backend, timeout=300)
    torch.backends.cuda.matmul.allow_tf32 = False
    one = transformer.init(cfg, seed=0, device=dev)
    with torch.no_grad():
        want, _ = transformer.forward(one, cfg, toks.to(dev), use_kernel=True)
    tokens = serve.greedy_generate(one, cfg, toks[:, :8], 6).cpu()
    want = want.cpu()
    descs = [b.desc for b in one.layers]
    for rows, logits, greedy, out, counts in got:
        err = (logits - want[rows]).abs()
        assert bool((err <= 1e-4 * (1 + want[rows].abs())).all()), \
            float(err.max())
        assert torch.equal(out, tokens[greedy]), (out, tokens)
        assert counts["flash_attention"] == sum(
            d["mixer"] == "attn" for d in descs), counts
        assert counts["moe_gmm"] == 2 * sum(
            d["ffn"] == "moe" for d in descs), counts


@pytest.mark.parametrize("arch, fsdp, mp", PLACEMENT_CASES)
def test_placement_forward_on_one_card_over_gloo(dev, arch, fsdp, mp):
    """Two ranks on cuda:0 over gloo (CUDA tensors through the host; the
    FSDP gathers as all-reduces of a zero-filled whole): each rank's
    logits of its rows equal the one-process forward's at 1e-4, its
    greedy tokens the one process's, and the kernels launch on the
    rank's experts (``moe_gmm`` twice a MoE layer)."""
    _placement_against_one_process(dev, arch, fsdp, mp, False, "gloo")


def test_placement_forward_over_nccl(dev):
    """DeepSeek's experts on "model" over NCCL with a card a rank (the
    gathers by ``all_gather_into_tensor``); NCCL refuses two ranks on one
    card, so a machine with one card skips it (not verified on GPU)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"not verified on GPU: NCCL takes a card a rank and "
                    f"this machine has {n}")
    _placement_against_one_process(dev, "deepseek-moe-16b", False, 2, True,
                                   "nccl")


def test_session_close_releases_the_rank_workspaces(dev):
    """A ranked session's GEMV runs a matmul on each rank's compute
    stream from a thread a rank, and PyTorch keeps a cuBLAS workspace (32
    MiB on Hopper) for every (handle, stream) pair: 8 ranks take at least
    8.  ``close()`` gives them back: the memory allocated after it is
    within 64 MiB of what it was before the session."""
    import gc

    from repro_torch.core.streams import release_cublas_workspaces

    gemv = REGISTRY["GEMV"]
    args = gemv.make_args(np.random.default_rng(0), scale=4)
    release_cublas_workspaces()     # no pair left by an earlier test
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    with pim.session(ranks=8, banks_per_rank=8) as s:
        for _ in range(2):
            gemv.compare(s.run("GEMV", *args), gemv.ref(*args))
        torch.cuda.synchronize()
        during = torch.cuda.memory_allocated(dev)
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated(dev)
    assert during - before >= 8 * (32 << 20), (before, during)
    assert after - before <= 64 << 20, (before, during, after)


# -- the sequence-sharded decode cache --------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "grouped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sequence_partials_merge_on_the_card(dev, impl, dtype):
    """H2O-Danube3's decode shape (32 heads, 8 kv heads of 120, window
    4,096) over a seeded cache of 16,384 positions on CUDA tensors, split
    into blocks at seeded boundaries: each block's ``decode_partial`` (the
    window masked by global position), merged by ``rescaled`` /
    ``normalized`` as ``merge_partials`` sums them over the ranks, equals
    the plain decode attention over the whole cache (1e-5 in float32; the
    grouped form rounds its probabilities to bfloat16 before the value
    product, per block against the whole row's, so 2e-2 there), with no
    NaN from the blocks that hold no valid position."""
    from repro_torch.kernels import ref as kref
    from repro_torch.models import attention

    g = torch.Generator(device=dev).manual_seed(21)
    B, H, KVH, T, D, window = 1, 32, 8, 16384, 120, 4096
    q = torch.randn((B, H, 1, D), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((B, KVH, T, D), generator=g, device=dev).to(dtype)
            for _ in range(2))
    f = kref.decode_attention_grouped if impl == "grouped" \
        else kref.decode_attention
    cuts = np.random.default_rng(21).choice(np.arange(1, T), 6,
                                            replace=False)
    edges = [0, *sorted(int(c) for c in cuts), T]
    for n in (1, 4096, 9000, T):
        lens = torch.full((B,), n, dtype=torch.int32, device=dev)
        want = f(q, k, v, lens, window=window)
        parts = [attention.decode_partial(
            q, k[:, :, a:b], v[:, :, a:b], lens, start=a, window=window,
            impl=impl) for a, b in zip(edges, edges[1:])]
        empty = [p for p, (a, b) in zip(parts, zip(edges, edges[1:]))
                 if b <= n - window or a >= n]
        for m, l, o in empty:
            assert bool(torch.isneginf(m).all()) and not l.any() \
                and not o.any()
        M = torch.stack([p[0] for p in parts]).amax(0)
        got = attention.normalized(sum(attention.rescaled(*p, M)
                                       for p in parts)).to(dtype)
        assert bool(torch.isfinite(got).all())
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        close(got, want, rel(want, tol))


def _seq_rank(rank: int, toks):
    """danube-smoke on (2, 1) on cuda:0, batch 1: the cache's positions
    split over "data" -> (this rank's block length, every step's logits
    of a teacher-forced decode, greedy tokens)."""
    from repro_torch.runtime import elastic

    card = torch.device("cuda", 0)
    torch.cuda.set_device(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = elastic.carve_mesh(model_parallel=1)
    cfg = get_config("h2o-danube-3-4b", smoke=True)
    model = transformer.init(cfg, seed=0, device=card, mesh=mesh)
    return _seq_decode(model, cfg, toks)


def _seq_decode(model, cfg, toks):
    from repro_torch.launch import serve

    L = toks.shape[1]
    cache = serve.make_cache(model, cfg, 1, L)
    step = serve.make_serve_step(cfg, batch=1, max_len=L)
    logits = []
    with torch.no_grad():
        for i in range(L):
            lg, cache = step(model, cache, toks[:, i:i + 1].to(model.device))
            logits.append(lg.float().cpu())
    return (cache["layers"][0]["k"].shape[2], torch.cat(logits, 1),
            serve.greedy_generate(model, cfg, toks[:, :40], 8).cpu())


def test_sequence_sharded_decode_on_one_card_over_gloo(dev):
    """Two ranks on cuda:0 over gloo, batch 1 over 48 positions: each
    holds 24 (the reference's spec splits the sequence over "data"),
    every step's logits equal the one-process decode on the whole cache
    at 1e-4 and the greedy tokens are its."""
    from repro_torch.launch import mesh as lmesh

    cfg = get_config("h2o-danube-3-4b", smoke=True)
    toks = torch.randint(0, cfg.vocab, (1, 48), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(9))
    got = lmesh.spawn(_seq_rank, 2, toks, backend="gloo", timeout=300)
    torch.backends.cuda.matmul.allow_tf32 = False
    T, want, tokens = _seq_decode(transformer.init(cfg, seed=0, device=dev),
                                  cfg, toks)
    assert T == 48
    for t, logits, out in got:
        assert t == 24
        close(logits, want, rel(want, 1e-4))
        assert torch.equal(out, tokens), (out, tokens)


def _split_head_rank(rank: int, dtype, x):
    """musicgen SMOKE (6 heads of 8) on (1, 4) on cuda:0 in ``dtype``: 12
    columns a rank, 1.5 heads, so each rank gathers the 2 heads its
    columns touch -> (the first layer's attention with the kernel and
    plain, the launches of the kernel's call, the forward's logits with
    the kernel and its launches)."""
    import dataclasses

    from repro_torch.models import attention
    from repro_torch.runtime import elastic

    card = torch.device("cuda", 0)
    torch.cuda.set_device(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = elastic.carve_mesh(model_parallel=4)
    cfg = dataclasses.replace(get_config("musicgen-medium", smoke=True),
                              dtype=dtype)
    model = transformer.init(cfg, seed=0, device=card, mesh=mesh)
    p = model.layers[0].mixer
    x = x.to(card, dtype)
    with torch.no_grad():
        ops.reset_launch_counts()
        got = attention.apply(p, cfg, x, use_kernel=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = attention.apply(p, cfg, x)
        ops.reset_launch_counts()
        logits, _ = transformer.forward(model, cfg, embeds=x,
                                        use_kernel=True)
        torch.cuda.synchronize()
    return (p.heads, got.float().cpu(), want.float().cpu(), counts,
            logits.float().cpu(), ops.launch_counts())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_head_attention_on_one_card_over_gloo(dev, dtype):
    """Four ranks on cuda:0 over gloo, musicgen SMOKE with 1.5 heads a
    rank: each rank launches ``flash_attention`` once on the 2 whole heads
    its columns touch (q, k and v gathered over "model", sliced to those
    heads), and the layer's output equals its plain version's at the
    kernel's tolerance (2e-3 float32, 2e-2 bfloat16); the forward through
    the kernel launches it once a layer a rank, and in float32 equals the
    one process's at 2e-3 (in bfloat16 the ranks' partial sums round
    apart from the one process's: finite only)."""
    import dataclasses

    from repro_torch.launch import mesh as lmesh

    cfg = dataclasses.replace(get_config("musicgen-medium", smoke=True),
                              dtype=dtype)
    x = torch.randn((2, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(11))
    got = lmesh.spawn(_split_head_rank, 4, dtype, x, backend="gloo",
                      timeout=300)
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    torch.backends.cuda.matmul.allow_tf32 = False
    one = transformer.init(cfg, seed=0, device=dev)
    with torch.no_grad():
        whole, _ = transformer.forward(one, cfg, embeds=x.to(dev, dtype),
                                       use_kernel=True)
    whole = whole.float().cpu()
    for heads, kernel, plain, counts, logits, fwd_counts in got:
        assert heads == (2, 2)
        close(kernel, plain, rel(plain, tol))
        assert counts["flash_attention"] == 1 and sum(counts.values()) == 1
        if dtype == torch.float32:
            close(logits, whole, rel(whole, tol))
        assert bool(torch.isfinite(logits).all())
        assert fwd_counts["flash_attention"] == cfg.n_layers, fwd_counts
        assert sum(fwd_counts.values()) == cfg.n_layers, fwd_counts


if __name__ == "__main__" and sys.argv[1:2] == ["--fault-loop"]:
    fault_loop(*map(int, sys.argv[2:5]))
if __name__ == "__main__" and sys.argv[1:2] == ["--restart"]:
    torch.use_deterministic_algorithms(True)
    restart_check()


def test_dryrun_rank_on_the_card_holds_the_meta_traces_bytes(dev):
    """The dry-run's rank on the card (``chip_smoke.py``'s dryrun phase,
    leg b, cut to 2 layers): rank 0 of TinyLlama FULL at train_4k on the
    (16, 16) mesh over a fake group of 256 ranks, built on the card with
    its weights uninitialised and on the meta device; its parameter,
    gradient and optimizer-state bytes equal to the byte, and the card's
    peak over one step at least the bytes held across it.  Values are not
    checked: over a fake group the collectives move nothing."""
    import dataclasses

    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2)
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        want = dryrun._cell_costs(dryrun.trace_cell(
            cfg, SHAPES["train_4k"], mesh))["memory"]
        t = dryrun.trace_cell(cfg, SHAPES["train_4k"], mesh, device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t.step()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    got = {"parameters": sum(p.numel() * p.element_size()
                             for p in t.model.parameters()),
           "gradients": sum(t.grads.values()),
           "optimizer_state": sum(x.numel() * x.element_size() for x in
                                  dryrun._tensors(t.held["optimizer_state"]))}
    assert got == {k: want[k] for k in got}
    held = want["parameters"] + want["optimizer_state"] + want["inputs"]
    assert peak >= held, (peak, held)
    print(f"peak on the card {peak} B, the meta trace's "
          f"{want['total_per_device']} B: ratio "
          f"{peak / want['total_per_device']:.4f}")


def test_tp1_dryrun_rank_on_the_card_holds_the_meta_traces_bytes(dev):
    """Leg b' of ``chip_smoke.py``'s dryrun phase, cut to 2 layers: rank
    0 of TinyLlama FULL at decode_32k on the (16, 16) mesh under the
    reference's ``tp1`` (every "model" dimension whole, every kv head of
    the rank's 8 streams in its cache), built on the card with its weights
    uninitialised and on the meta device: parameter and cache bytes equal
    to the byte, the cache 16 times the reference's cache specs' (ROADMAP
    queue 3), and the card's peak over one decode step at least the bytes
    held across it."""
    import dataclasses

    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun, serve
    from repro_torch.launch.mesh import make_production_mesh

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2)
    sh = SHAPES["decode_32k"]
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        want = dryrun._cell_costs(dryrun.trace_cell(
            cfg, sh, mesh, opt_flags=("tp1",)))["memory"]
        t = dryrun.trace_cell(cfg, sh, mesh, opt_flags=("tp1",), device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t.step()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    got = {"parameters": sum(p.numel() * p.element_size()
                             for p in t.model.parameters()),
           "cache": sum(x.numel() * x.element_size()
                        for x in dryrun._tensors(t.held["cache"]))}
    assert got == {k: want[k] for k in got}
    assert t.model.tp.size == 1 and not transformer.sharded_leaves(t.model)
    kv = sum(c[k].numel() * c[k].element_size()
             for c in t.held["cache"]["layers"] for k in ("k", "v"))
    whole = 2 * 2 * sh.batch * cfg.n_kv_heads * sh.seq * cfg.hd * 2
    assert kv * 16 == whole                 # the rank's 8 of 128 streams
    # the reference's spec of a whole leaf splits it over both axes: the
    # rank holds 16 times its bytes
    spec = serve.cache_spec_for((sh.batch, cfg.n_kv_heads, sh.seq, cfg.hd),
                                16, 16, "data")
    assert {"data", "model"} <= set(spec), spec
    held = want["parameters"] + want["cache"] + want["inputs"]
    assert peak >= held, (peak, held)
    print(f"peak on the card {peak} B, the meta trace's "
          f"{want['total_per_device']} B: ratio "
          f"{peak / want['total_per_device']:.4f}")
