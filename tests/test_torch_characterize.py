"""Port parity: ``repro_torch.core.characterize`` and the async transfers
against ``repro.core.characterize`` / ``repro.core.transfer``.

Each sweep runs in both packages with the same arguments on a 1-bank grid
(the reference's one in-process device, the port's ``device="cpu"``).  The
rows must have the same keys and the same sizes: ``nbytes``, ``elements``,
``size``, ``block``, ``banks``, ``ranks`` and the bytes behind every rate
(a rate times its seconds, to 1e-9 relative: the one division and
multiplication of float64 each side).  Times are not compared.  The async
transfers must return the same arrays (exact) and record kinds and bytes.
"""
import numpy as np
import pytest
import torch

from repro.core import characterize as jch
from repro.core import make_rank_grid as jrank_grid
from repro.core import transfer as jtx
from repro_torch.core import characterize as tch
from repro_torch.core import transfer as ttx
from repro_torch.core.banked import make_bank_grid, make_rank_grid

# the whole suite runs in 6 pytest workers on 8 cores: two intra-op threads
# a worker keep these modules from starving the reference's timing-gated tests
torch.set_num_threads(2)

CPU = "cpu"


@pytest.fixture(scope="module")
def tgrid():
    return make_bank_grid(1, device=CPU)


def same_rows(j_rows, t_rows, exact=(), rates=()):
    """Same keys, equal ``exact`` fields, equal bytes behind ``rates``
    (pairs of (rate key, seconds key, scale))."""
    j_rows = j_rows if isinstance(j_rows, list) else [j_rows]
    t_rows = t_rows if isinstance(t_rows, list) else [t_rows]
    assert len(j_rows) == len(t_rows)
    for j, t in zip(j_rows, t_rows):
        assert list(t) == list(j)
        for k in exact:
            assert t[k] == j[k], (k, t[k], j[k])
        for rate, sec, unit in rates:
            assert t[rate] * t[sec] * unit == pytest.approx(
                j[rate] * j[sec] * unit, rel=1e-9), rate


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
@pytest.mark.parametrize("dtype", ["int32", "int64", "float", "double"])
def test_arith_throughput_rows(op, dtype):
    kw = dict(lanes=4, n=1 << 12, reps=1)
    same_rows(jch.arith_throughput(op, dtype, **kw),
              tch.arith_throughput(op, dtype, device=CPU, **kw),
              exact=("op", "dtype", "lanes"), rates=[("mops", "seconds", 1)])


@pytest.mark.parametrize("which", ["copy", "add", "scale", "triad"])
def test_stream_wram_bytes_follow_the_narrowed_itemsize(which):
    j = jch.stream_wram(which, n=1 << 12, reps=1)
    t = tch.stream_wram(which, n=1 << 12, reps=1, device=CPU)
    same_rows(j, t, exact=("stream",), rates=[("mbps", "seconds", 1e6)])
    per = {"copy": 2, "add": 3, "scale": 2, "triad": 3}[which]
    assert t["mbps"] * t["seconds"] * 1e6 == pytest.approx((1 << 12) * per * 4)


def test_dma_latency_sweep_and_fit():
    sizes = (8, 128, 2048)
    j = jch.dma_latency_sweep(sizes, reps=1)
    t = tch.dma_latency_sweep(sizes, reps=1, device=CPU)
    same_rows(j, t, exact=("size",), rates=[("mbps", "seconds", 1e6)])
    rows = [{"size": s, "seconds": (77 + 0.5 * s) / 350e6} for s in sizes]
    assert tch.fit_dma_model(rows, 350e6) == jch.fit_dma_model(rows, 350e6)


@pytest.mark.parametrize("which", ["copy-dma", "copy", "add", "scale", "triad"])
@pytest.mark.parametrize("block", [64, 1024])
def test_stream_mram_rows(which, block):
    j = jch.stream_mram(which, n=1 << 13, block=block, reps=1)
    t = tch.stream_mram(which, n=1 << 13, block=block, reps=1, device=CPU)
    same_rows(j, t, exact=("stream", "block"),
              rates=[("mbps", "seconds", 1e6)])


def test_stream_mram_refuses_an_unknown_stream():
    with pytest.raises(ValueError):
        tch.stream_mram("nope", n=1 << 10, device=CPU)


@pytest.mark.parametrize("mode", ["coarse", "fine", "random"])
@pytest.mark.parametrize("stride", [1, 4])
def test_strided_bandwidth_rows(mode, stride):
    j = jch.strided_bandwidth(stride, mode, n=1 << 12, reps=1)
    t = tch.strided_bandwidth(stride, mode, n=1 << 12, reps=1, device=CPU)
    same_rows(j, t, exact=("stride", "mode"),
              rates=[("effective_mbps", "seconds", 1e6),
                     ("raw_mbps", "seconds", 1e6)])


@pytest.mark.parametrize("dtype", ["int32", "float", "double"])
def test_intensity_sweep_rows(dtype):
    j = jch.intensity_sweep(3, dtype, n=1 << 12, reps=1)
    t = tch.intensity_sweep(3, dtype, n=1 << 12, reps=1, device=CPU)
    same_rows(j, t, exact=("op_per_byte", "dtype"),
              rates=[("mops", "seconds", 1)])


def test_push_pull_sweep_rows(bank_grid, tgrid):
    nb = (1 << 12, 1 << 14)
    same_rows(jch.push_pull_sweep(bank_grid, nbytes=nb, reps=1),
              tch.push_pull_sweep(tgrid, nbytes=nb, reps=1),
              exact=("nbytes",))


def test_op_throughput_sweep_rows(bank_grid, tgrid):
    kw = dict(dtypes=("int32", "int64", "float", "double"),
              nbytes=(1 << 10, 1 << 12), reps=1)
    same_rows(jch.op_throughput_sweep(bank_grid, **kw),
              tch.op_throughput_sweep(tgrid, **kw),
              exact=("op", "dtype", "elements", "nbytes"),
              rates=[("mops", "seconds", 1)])


def test_bank_compute_sweep_rows(bank_grid, tgrid):
    nb = (1 << 12, 1 << 14)
    same_rows(jch.bank_compute_sweep(bank_grid, nbytes=nb, reps=1),
              tch.bank_compute_sweep(tgrid, nbytes=nb, reps=1),
              exact=("nbytes",))


def test_rank_parallel_sweep_rows():
    j = jch.rank_parallel_sweep(jrank_grid(1, 1), nbytes=1 << 14, reps=1)
    t = tch.rank_parallel_sweep(make_rank_grid(1, 1, device=CPU),
                                nbytes=1 << 14, reps=1)
    same_rows(j, t, exact=("ranks", "banks", "nbytes"),
              rates=[("push_gbps", "push_s", 1e9),
                     ("pull_gbps", "pull_s", 1e9)])


def test_rank_parallel_sweep_over_ranks_and_refusal():
    g = make_rank_grid(4, 2, device=CPU)
    rows = tch.rank_parallel_sweep(g, nbytes=1 << 14, reps=1)
    assert [(r["ranks"], r["banks"]) for r in rows] == [(1, 2), (2, 4),
                                                          (4, 8)]
    assert {r["nbytes"] for r in rows} == {1 << 14}
    with pytest.raises(ValueError, match="RankGrid"):
        tch.rank_parallel_sweep(make_bank_grid(2, device=CPU),
                                rank_counts=[2], nbytes=1 << 12, reps=1)


def test_transfer_sweep_rows(bank_grid, tgrid):
    same_rows(jch.transfer_sweep(bank_grid, mb_per_bank=1),
              tch.transfer_sweep(tgrid, mb_per_bank=1),
              exact=("kind", "banks", "nbytes"))


# -- the async transfers ----------------------------------------------------------

def test_push_parallel_async_and_pull_async(bank_grid, tgrid, rng):
    x = rng.integers(0, 99, (1, 256)).astype(np.int32)
    jdev, jrec = jtx.push_parallel_async(bank_grid, x)
    tdev, trec = ttx.push_parallel_async(tgrid, x)
    assert (trec.kind, trec.nbytes) == (jrec.kind, jrec.nbytes) == (
        "cpu_dpu_async", x.nbytes)
    jhost, jrec = jtx.pull_async(jdev)()
    thost, trec = ttx.pull_async(tdev, tgrid)()
    np.testing.assert_array_equal(thost, jhost)
    np.testing.assert_array_equal(thost, x)
    assert (trec.kind, trec.nbytes) == (jrec.kind, jrec.nbytes) == (
        "dpu_cpu_async", x.nbytes)
    host, _ = ttx.pull_async(tdev)()             # no grid given
    np.testing.assert_array_equal(host, x)


def test_rank_async_transfers(rng):
    jg, tg = jrank_grid(1, 1), make_rank_grid(1, 1, device=CPU)
    per_rank = [rng.normal(size=(1, 64)).astype(np.float32)]
    jdevs, jrec = jtx.push_ranks_async(jg, per_rank)
    tdevs, trec = ttx.push_ranks_async(tg, per_rank)
    assert (trec.kind, trec.nbytes) == (jrec.kind, jrec.nbytes) == (
        "cpu_dpu_rank_async", per_rank[0].nbytes)
    jhost, jrec = jtx.pull_ranks_async(jdevs)()
    thost, trec = ttx.pull_ranks_async(tdevs, tg)()
    for a, b in zip(thost, jhost):
        np.testing.assert_array_equal(a, b)
    assert (trec.kind, trec.nbytes) == (jrec.kind, jrec.nbytes) == (
        "dpu_cpu_rank_async", per_rank[0].nbytes)
    with pytest.raises(ValueError, match="payloads for 1 ranks"):
        ttx.push_ranks_async(tg, per_rank * 2)


def test_rank_async_transfers_over_four_ranks(rng):
    g = make_rank_grid(4, 2, device=CPU)
    per_rank = [rng.integers(0, 9, (2, 8)).astype(np.int64) for _ in range(4)]
    devs, rec = ttx.push_ranks_async(g, per_rank)
    assert rec.nbytes == sum(x.nbytes for x in per_rank)
    assert all(d.dtype == torch.int32 for d in devs)   # narrowed as to_banks
    host, rec = ttx.pull_ranks_async(devs, g)()
    for h, x in zip(host, per_rank):
        np.testing.assert_array_equal(h, x.astype(np.int32))
    assert rec.nbytes == sum(h.nbytes for h in host)
