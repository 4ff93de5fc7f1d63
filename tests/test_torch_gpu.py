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
