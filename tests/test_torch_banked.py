"""Port parity: the bank model, transfer engine and chunk helpers of
``repro_torch`` against ``repro.core`` / ``repro.prim.common``.

Host-side helpers must be byte-equal to the reference's; every exchange, in
``host`` and ``fabric`` mode, must equal the reference's same mode; the
bank-local phases must be bank-local (perturbing one bank moves only that
bank's output).  The port runs on ``device="cpu"``; the reference on its
one CPU device.
"""
import ast
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (both packages live in this test process)
import numpy as np
import pytest
import torch

from repro.core import transfer as jtx
from repro.prim import common as jcommon
from repro_torch.core import banked as tbanked
from repro_torch.core import make_bank_grid, make_rank_grid
from repro_torch.core import transfer as ttx
from repro_torch.kernels import ops as tops
from repro_torch.prim import bfs as tbfs
from repro_torch.prim import common as tcommon
from repro_torch.prim import nw as tnw
from repro_torch.prim.registry import REGISTRY as TREG

# the whole suite runs in 6 pytest workers on 8 cores: two intra-op threads
# a worker keep these modules from starving the reference's timing-gated tests
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
R = np.random.default_rng(11)


def cpu_grid(n_banks: int):
    return make_bank_grid(n_banks, device="cpu")


def same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


# -- host-side layout and chunk helpers: byte-equal ---------------------------

@pytest.mark.parametrize("shape,n_banks,fill", [
    ((37,), 4, 0), ((64, 3), 8, -1), ((5,), 8, 0), ((1000,), 1, 0),
    ((30, 2, 2), 7, 3)])
def test_pad_chunks_byte_equal(shape, n_banks, fill):
    x = R.integers(-50, 50, shape).astype(np.int32)
    a, na = tcommon.pad_chunks(x, n_banks, fill)
    b, nb = jcommon.pad_chunks(x, n_banks, fill)
    assert na == nb
    same_bytes(a, b)


@pytest.mark.parametrize("shape,n_chunks,axis", [
    ((100,), 3, 0), ((7,), 4, 0), ((6, 10), 3, 1), ((9, 4), 1, 0)])
def test_split_chunks_byte_equal(shape, n_chunks, axis):
    x = R.normal(size=shape).astype(np.float32)
    a, na = ttx.split_chunks(x, n_chunks, axis)
    b, nb = jtx.split_chunks(x, n_chunks, axis)
    assert na == nb and len(a) == len(b)
    for ca, cb in zip(a, b):
        same_bytes(ca, cb)


@pytest.mark.parametrize("n_ranks,n_chunks", [(1, 3), (2, 2), (4, 1)])
def test_split_chunks_ranked_byte_equal(n_ranks, n_chunks):
    x = R.integers(0, 9, 101).astype(np.int32)
    a, na = ttx.split_chunks_ranked(x, n_ranks, n_chunks)
    b, nb = jtx.split_chunks_ranked(x, n_ranks, n_chunks)
    assert na == nb
    assert [len(g) for g in a] == [len(g) for g in b]
    for ga, gb in zip(a, b):
        for ca, cb in zip(ga, gb):
            same_bytes(ca, cb)


def test_split_chunks_rejects_bad_counts():
    with pytest.raises(ValueError):
        ttx.split_chunks(np.arange(4), 0)
    with pytest.raises(ValueError):
        ttx.split_chunks_ranked(np.arange(4), 0, 1)


@pytest.mark.parametrize("shape,n_banks,axis", [
    ((37,), 4, 0), ((10, 6), 4, 1), ((5, 7, 3), 2, 1), ((8,), 8, 0)])
def test_to_banked_from_banked_byte_equal(shape, n_banks, axis):
    x = R.normal(size=shape).astype(np.float32)
    a, na = ttx.to_banked(x, n_banks, axis)
    b, nb = jtx.to_banked(x, n_banks, axis)
    assert na == nb
    same_bytes(a, b)
    same_bytes(ttx.from_banked(a, na, axis), jtx.from_banked(b, nb, axis))
    same_bytes(ttx.from_banked(a, na, axis), x)


@pytest.mark.parametrize("name", sorted(TREG))
def test_tree_nbytes_matches_reference(name):
    args = TREG[name].make_args(np.random.default_rng(3), scale=1)
    assert ttx.tree_nbytes(args) == jtx.tree_nbytes(args)
    assert TREG[name].arg_nbytes(args) == jtx.tree_nbytes(args)


def test_tree_nbytes_nested():
    tree = {"w": np.zeros((4, 3), np.float32), "b": [np.zeros(5, np.int64),
                                                     torch.zeros(2)]}
    assert ttx.tree_nbytes(tree) == 48 + 40 + 8


# -- placement: to_banks narrows as jax.device_put does ----------------------

@pytest.mark.parametrize("x", [
    np.array([2**40 + 5, -3, 7], np.int64),
    np.array([1.5, 2.0**-30, 0.1], np.float64),
    np.array([2**63 + 1, 4], np.uint64),
    np.array([True, False]),
    np.array([1, -2], np.int16),
    np.array([3, 4], np.int32),
], ids=["int64", "float64", "uint64", "bool", "int16", "int32"])
def test_to_banks_narrows_like_device_put(bank_grid, x):
    want = np.asarray(bank_grid.to_banks(x))
    for put in (cpu_grid(1).to_banks, cpu_grid(1).broadcast):
        got = put(x)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        same_bytes(got.numpy(), want)


def test_from_banks_round_trip_and_serial():
    g = cpu_grid(4)
    x = R.integers(0, 99, (4, 5)).astype(np.int32)
    same_bytes(g.from_banks(g.to_banks(x)), x)
    parts = g.serial_to_banks(list(x))
    assert len(parts) == 4
    for p, row in zip(parts, x):
        same_bytes(p.numpy(), row)


# -- exchanges: host and fabric equal the reference's host mode ---------------

@pytest.mark.parametrize("via", ["host", "fabric"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_exchange_sum_matches_reference(bank_grid, via, dtype):
    parts = (R.integers(-99, 99, (1, 6)) if dtype == np.int32
             else R.normal(size=(1, 6))).astype(dtype)
    want = np.asarray(bank_grid.exchange_sum(bank_grid.to_banks(parts),
                                             via="host"))
    g = cpu_grid(1)
    got = g.from_banks(g.exchange_sum(g.to_banks(parts), via=via))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("via", ["host", "fabric"])
def test_exchange_scan_matches_reference(bank_grid, via):
    tot = np.array([17], np.int32)
    want = np.asarray(bank_grid.exchange_scan(bank_grid.to_banks(tot),
                                              via="host"))
    g = cpu_grid(1)
    got = g.exchange_scan(g.to_banks(tot), via=via)
    same_bytes(got.numpy(), want)


@pytest.mark.parametrize("via", ["host", "fabric"])
def test_exchange_union_and_concat_match_reference(bank_grid, via):
    """Each mode against the reference's same mode, on shape, dtype and
    bytes: the host mode gives the flat union, the fabric mode one bank's
    block shape, (1, w) here."""
    bits = R.integers(0, 2**30, (1, 5)).astype(np.int32)
    g = cpu_grid(1)
    want_u = np.asarray(bank_grid.exchange_union(bank_grid.to_banks(bits),
                                                 via=via))
    got_u = g.exchange_union(g.to_banks(bits), via=via)
    same_bytes(got_u.numpy(), want_u)
    assert want_u.shape == ((5,) if via == "host" else (1, 5))
    want_c = np.asarray(bank_grid.exchange_concat(bank_grid.to_banks(bits),
                                                  via="host"))
    got_c = g.from_banks(g.exchange_concat(g.to_banks(bits), via=via))
    same_bytes(got_c, want_c)


@pytest.mark.parametrize("n_banks", [3, 8])
def test_exchanges_host_equals_fabric_across_banks(n_banks):
    """At several banks (the reference runs one bank in-process): both
    modes give the reference's host-mode formulas, and the int64 host scan
    comes back as int32 as it does through device_put."""
    g = cpu_grid(n_banks)
    tot = R.integers(0, 1000, n_banks).astype(np.int32)
    excl = np.concatenate([[0], np.cumsum(tot)[:-1]]).astype(np.int32)
    for via in ("host", "fabric"):
        got = g.exchange_scan(g.to_banks(tot), via=via)
        same_bytes(got.numpy(), excl)
    parts = R.integers(-9, 9, (n_banks, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        g.from_banks(g.exchange_sum(g.to_banks(parts), via="fabric")),
        parts.sum(axis=0))
    np.testing.assert_array_equal(
        g.exchange_sum(g.to_banks(parts), via="host"), parts.sum(axis=0))
    bits = R.integers(0, 2**20, (n_banks, 3)).astype(np.int32)
    want = np.bitwise_or.reduce(bits, axis=0)
    same_bytes(g.exchange_union(g.to_banks(bits), via="host").numpy(), want)
    same_bytes(g.exchange_union(g.to_banks(bits), via="fabric").numpy(),
               want[None])


# -- transfer records ------------------------------------------------------------

def test_transfer_records_match_reference(bank_grid):
    g = cpu_grid(1)
    buf = np.arange(64, dtype=np.int64).reshape(1, -1)
    for fn in ("push_parallel", "push_broadcast"):
        _, want = getattr(jtx, fn)(bank_grid, buf)
        dev, got = getattr(ttx, fn)(g, buf)
        assert (got.kind, got.nbytes) == (want.kind, want.nbytes)
        assert got.seconds >= 0 and got.bandwidth > 0
    dev, _ = ttx.push_parallel(g, buf)
    host, rec = ttx.pull_parallel(g, dev)
    _, want = jtx.pull_parallel(bank_grid, bank_grid.to_banks(buf))
    assert (rec.kind, rec.nbytes) == (want.kind, want.nbytes)
    same_bytes(host, np.asarray(bank_grid.to_banks(buf)))
    chunks = [np.arange(8, dtype=np.int32)]
    outs, rec = ttx.push_serial(g, chunks)
    _, want = jtx.push_serial(bank_grid, chunks)
    assert (rec.kind, rec.nbytes) == (want.kind, want.nbytes)
    hosts, rec = ttx.pull_serial(g, outs)
    _, want = jtx.pull_serial(bank_grid, [bank_grid.to_banks(chunks[0])])
    assert (rec.kind, rec.nbytes) == (want.kind, want.nbytes)
    same_bytes(hosts[0], chunks[0])


# -- bank locality: the port's stand-in for assert_collective_free -------------

def _phases():
    """name -> (make input (banks, ...) int/float array, bank-local fn)."""
    grid = cpu_grid(8)
    ch = {n: TREG[n].chunked for n in TREG}
    ints = lambda: R.integers(-20, 300, (8, 300)).astype(np.int32)  # noqa: E731
    full = torch.full((8,), 300, dtype=torch.int32)   # every slot valid
    return grid, {
        "ops.reduce_sum": (ints, tops.reduce_sum),
        "ops.scan_inclusive": (ints, tops.scan_inclusive),
        "ops.scan_exclusive": (ints, tops.scan_exclusive),
        "ops.histogram": (ints, lambda x: tops.histogram(x, 256)),
        "ops.gemv": (lambda: R.normal(size=(8, 16, 64)).astype(np.float32),
                     lambda a: tops.gemv(a, torch.ones(64))),
        "RED.compute": (ints, lambda x: ch["RED"].compute(grid, {}, x)),
        "SCAN.compute": (ints, lambda x: ch["SCAN"].compute(grid, {}, x)),
        "HST.compute": (ints, lambda x: ch["HST"].compute(
            grid, {"nbins": 256}, x)),
        "GEMV.compute": (lambda: R.normal(size=(8, 16, 64)).astype(np.float32),
                         lambda a: ch["GEMV"].compute(
                             grid, {"dx": torch.ones(64)}, a)),
        # vals and cols of one bank move together: cols are the float
        # slots' integer parts, so the perturbation moves both
        "ops.spmv_ell": (lambda: R.normal(size=(8, 16, 6)).astype(np.float32),
                         lambda v: tops.spmv_ell(v, _spmv_cols(v),
                                                 torch.arange(40.0))),
        "SpMV.compute": (lambda: R.normal(size=(8, 16, 6)).astype(np.float32),
                         lambda v: ch["SpMV"].compute(
                             grid, {"dx": torch.arange(40.0)},
                             (v, _spmv_cols(v)))),
        "VA.compute": (ints, lambda x: ch["VA"].compute(grid, {}, (x, x))),
        # all odd, so the perturbed bank keeps nothing: its count moves
        "SEL.compute": (lambda: ints() * 2 + 1,
                        lambda x: ch["SEL"].compute(grid, {}, (x, full))),
        # first value 5, last 0: the perturbed bank starts with 1, its
        # previous value, so its count moves
        "UNI.compute": (_uni_rows, lambda x: ch["UNI"].compute(
            grid, {}, (x, torch.ones(8, dtype=torch.int32), full))),
        "BS.compute": (ints, lambda q: ch["BS"].compute(
            grid, {"darr": torch.arange(0, 1000, 3, dtype=torch.int32)}, q)),
        "TS.compute": (lambda: R.normal(size=(8, 100)).astype(np.float32),
                       lambda sb: ch["TS"].compute(
                           grid, {"dq": torch.linspace(-1, 1, 16) ** 3}, sb)),
        "MLP.compute": (lambda: R.normal(size=(8, 16, 64)).astype(np.float32),
                        lambda w: ch["MLP"].compute(
                            grid, {"dh": torch.ones(64)}, w)),
        # 8 of TRNS's N' rows, one a bank, each of M' = 2 tiles of m = 8
        "TRNS.compute": (lambda: R.normal(size=(8, 16, 8)).astype(np.float32),
                         lambda x: ch["TRNS"].compute(
                             grid, {"m": 8, "n": 8}, x)),
        # one block a bank: top, left, corner, then the two 32-base pieces
        "nw.nw_blocks": (lambda: R.integers(-40, 40, (8, 129)).astype(np.int32),
                         lambda x: tnw.nw_blocks(
                             x[:, :32], x[:, 32:64], x[:, 64],
                             x[:, 65:97] % 4, x[:, 97:] % 4)),
        # 30 owned rows of 4 neighbours a bank; every vertex in the
        # frontier, none visited
        "bfs.expand": (lambda: R.integers(-1, 240, (8, 30, 4)).astype(np.int32),
                       lambda a: tbfs.expand(
                           a.clamp(-1, 239), torch.ones(240, dtype=torch.uint8),
                           torch.zeros(240, dtype=torch.uint8),
                           torch.arange(8, dtype=torch.int32) * 30)),
    }


def _uni_rows():
    x = R.integers(0, 4, (8, 300)).astype(np.int32)
    x[:, 0], x[:, -1] = 5, 0
    return x


def _spmv_cols(v: torch.Tensor) -> torch.Tensor:
    """ELL columns in [-1, 44) from a bank's values: -1 pads, 40 and past
    read the last x."""
    return (v * 10).to(torch.int32).clamp(-1, 43)


@pytest.mark.parametrize("phase", sorted(_phases()[1]))
@pytest.mark.parametrize("bank", [0, 5, 7])
def test_bank_local_phase_reads_only_its_bank(phase, bank):
    grid, phases = _phases()
    make, fn = phases[phase]
    x = make()
    y = x.copy()
    y[bank] = y[bank][::-1] * 3 + 1
    outs_x = fn(grid.to_banks(x))
    outs_y = fn(grid.to_banks(y))
    outs_x = outs_x if isinstance(outs_x, tuple) else (outs_x,)
    outs_y = outs_y if isinstance(outs_y, tuple) else (outs_y,)
    for ox, oy in zip(outs_x, outs_y):
        assert ox.shape[0] == 8
        moved = [b for b in range(8) if not torch.equal(ox[b], oy[b])]
        assert moved == [bank], (phase, moved)


# -- grids -------------------------------------------------------------------------

def test_make_bank_grid_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_bank_grid(4)
    with pytest.raises(RuntimeError):
        make_rank_grid(2, 2)
    g = make_bank_grid(4, device="cpu")
    assert g.n_banks == 4 and g.device == torch.device("cpu")


@pytest.mark.parametrize("env,n_banks,want_ranks", [
    ("2", 8, 2), ("2", 3, 1), ("junk", 8, 1), ("", 8, 1), ("4", 4, 4)])
def test_env_ranks_fallback(monkeypatch, env, n_banks, want_ranks):
    monkeypatch.setenv(tbanked.RANKS_ENV, env)
    g = make_bank_grid(n_banks, device="cpu")
    assert g.n_banks == n_banks
    assert getattr(g, "n_ranks", 1) == want_ranks
    assert isinstance(g, tbanked.RankGrid) == (want_ranks > 1)


def test_rank_grid_views_and_validation():
    g = make_rank_grid(4, 2, device="cpu")
    assert (g.n_ranks, g.banks_per_rank, g.n_banks) == (4, 2, 8)
    assert len(g.rank_views) == 4 and g.rank_view(3).n_banks == 2
    assert g.rank_view(1) is g.rank_views[1]
    # the views compare equal: their rank index does not key
    assert [v.rank for v in g.rank_views] == [0, 1, 2, 3]
    assert g.rank_view(0) == g.rank_view(3)
    assert g.streams is None and g.rank_view(2).streams is None   # CPU
    with pytest.raises(ValueError):
        make_bank_grid(6, ranks=4, device="cpu")
    with pytest.raises(ValueError):
        make_rank_grid(0, device="cpu")


# -- the port stands alone ----------------------------------------------------------

def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_port_source_imports_no_jax_or_repro(path):
    bad = [m for m in _imports(ROOT / path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, (path, bad)


def test_import_loads_no_jax_or_repro_and_grid_needs_cuda():
    code = ("import sys, torch\n"
            "import repro_torch, repro_torch.prim.registry, repro_torch.pim\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "torch.cuda.is_available = lambda: False\n"
            "for open_ in (repro_torch.make_bank_grid, repro_torch.pim.session):\n"
            "    try:\n"
            "        open_()\n"
            "    except RuntimeError:\n"
            "        print('RAISED')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("RAISED") == 2
