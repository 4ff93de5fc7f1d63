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
float32 GEMV agrees within the registry's rtol = atol = 1e-4; bfloat16
GEMV, compared in float32, within 2e-2, one bfloat16 rounding step being
2^-8 of the value.
"""
import pytest
import torch

from repro_torch.kernels import gemv as kgemv
from repro_torch.kernels import histogram as khist
from repro_torch.kernels import ops
from repro_torch.kernels import reduce as kred
from repro_torch.kernels import scan as kscan

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
    assert ops.launch_counts() == {"reduce_sum": 1, "scan_inclusive": 1,
                                   "histogram": 1, "gemv": 1}
    with pytest.raises(TypeError):
        ops.reduce_sum(x.to(torch.int64))
    with pytest.raises(ValueError):
        kred.reduce_sum(x.cpu().to(dev).t(), block=128)
