#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain PyTorch
version at the PrIM suite's shapes and times it, drives the suite's banked
path (GEMV, SpMV, HST, RED, SCAN) through the registry at 2,048 banks,
checks every result against ``ref()``, shows that the suite went through
the kernels, and then drives the same workloads through the session
façade, ``repro_torch.pim.session(ranks=32, banks_per_rank=64)``: ``run``,
``map``, ``pin`` with warm hits, a two-tenant serving block and a trace
export, every result checked with the registry's comparator.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them.  The last
line is ``{"ok": true, "device": {...}}``; the line before it is the card's
name and power limit from ``nvidia-smi``, and the one before that a JSON
``{"kernels": [...]}`` with each kernel's launches on the suite path, its
error against its plain version, and its times beside its bound.
"""
import functools
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: HBM3 bandwidth, and the float32 rate outside the
# tensor cores (the int32 adds of RED / SCAN / HST are counted at it too;
# the data sheet lists no int32 rate).  Every kernel here is far below the
# ridge point, so its bound is the bytes.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

SUITE = ((2048, 1024), (1, 64))     # (banks, make_args scale)
# the kernels' shapes on the suite's 2,048-bank run: RED / SCAN / HST hold
# 65536 * 1024 int32 values, 32,768 per bank; GEMV 256 rows of 256 per
# bank; SpMV 256 ELL rows of k = 8 per bank over an x of 256
BANKS, PER, ROWS, COLS = 2048, 32768, 256, 256
SPMV_K, SPMV_LARGE_ROWS = 8, 4096   # and a per-bank height past the L2
TIMED_ITERS = 20
# the session phase: the suite's 2,048 banks as 32 ranks of 64 DPUs
RANKS, BANKS_PER_RANK = 32, 64
TRACE = os.path.join(ROOT, "build", "repro_torch", "chip_smoke_trace.json")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = TIMED_ITERS) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, nops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check(name: str, got: torch.Tensor, want: torch.Tensor, allowed) -> float:
    """Max |got - want| in float32; every element must be within
    ``allowed`` of ``want`` (0: exact)."""
    assert got.shape == want.shape and got.dtype == want.dtype, (
        name, got.shape, want.shape, got.dtype, want.dtype)
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all(), name
    err = (g - w).abs()
    worst = float(err.max())
    assert bool((err <= allowed).all()), (
        f"{name}: max abs error {worst} over what is allowed")
    print(f"  check {name:28s} max_abs_err={worst:.3e}")
    return worst


def rel(want: torch.Tensor, tol: float) -> torch.Tensor:
    """tol * (1 + |want|): rtol = atol = tol."""
    return tol * (1 + want.float().abs())


def random_ell(banks: int, rows: int, k: int, n: int, g, dev):
    """Seeded ELL on the device (``csr_to_ell``'s Python loop is too slow
    for millions of rows): row r keeps ``count[r] ~ U{0..k}`` distinct
    sorted columns, ``cols = -1`` and ``vals = 0`` in the padded slots.
    Columns are ``(base + j * step) % n`` with an odd step and a
    power-of-two n, so the k of a row are distinct.  Returns vals, cols
    (banks, rows, k) and the (rows, k) mask of stored entries."""
    r = banks * rows
    count = torch.randint(0, k + 1, (r, 1), generator=g, device=dev)
    base = torch.randint(0, n, (r, 1), generator=g, device=dev)
    step = torch.randint(0, n // 2, (r, 1), generator=g, device=dev) * 2 + 1
    cols = ((base + step * torch.arange(k, device=dev)) % n).sort(1).values
    keep = torch.arange(k, device=dev) < count
    vals = torch.randn((r, k), generator=g, device=dev)
    vals = torch.where(keep, vals, 0.0)
    cols = torch.where(keep, cols, -1).to(torch.int32)
    return vals.view(banks, rows, k), cols.view(banks, rows, k), keep


def spmv_case(name: str, rows: int, n: int, g, dev, tol=1e-4) -> dict:
    """One timed spmv_ell case at (2048, rows, k): the kernel, its plain
    version, and cuSPARSE's CSR product over the same stored entries
    (built outside the timed window).  Bytes: all of cols, the stored
    vals, x, y; operations: 2 per stored entry."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import spmv as kspmv

    vals, cols, keep = random_ell(BANKS, rows, SPMV_K, n, g, dev)
    x = torch.randn(n, generator=g, device=dev)
    nnz = int(keep.sum())
    crow = torch.zeros(BANKS * rows + 1, dtype=torch.int32, device=dev)
    crow[1:] = keep.sum(1).cumsum(0)
    with warnings.catch_warnings():       # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        csr = torch.sparse_csr_tensor(crow, cols.view(-1, SPMV_K)[keep],
                                      vals.view(-1, SPMV_K)[keep],
                                      size=(BANKS * rows, n))
        csr @ x
    flat = lambda t: t.view(-1, SPMV_K)  # noqa: E731
    return dict(
        name=name, source="src/repro_torch/csrc/spmv.cu",
        replaces="src/repro/kernels/spmv.py:19",
        kernel=lambda: ops.spmv_ell(vals, cols, x),
        plain=lambda: kspmv.plain(flat(vals), flat(cols), x).view(BANKS, rows),
        library=lambda: csr @ x,
        nbytes=cols.nbytes + nnz * 4 + x.nbytes + BANKS * rows * 4,
        nops=2 * nnz, tol=tol)


def kernel_phase(dev) -> list[dict]:
    """Each kernel at the suite's 2,048-bank shapes: the error against its
    plain version on the same inputs, and its times.  spmv_ell is also
    timed at 4,096 rows per bank, whose bytes leave the L2."""
    from repro_torch.kernels import gemv as kgemv
    from repro_torch.kernels import histogram as khist
    from repro_torch.kernels import ops
    from repro_torch.kernels import reduce as kred
    from repro_torch.kernels import scan as kscan
    from repro_torch.kernels import spmv as kspmv

    g = torch.Generator(device=dev).manual_seed(0)
    banks, per, nbins, block = BANKS, PER, 256, 4096
    x = torch.randint(0, 99, (banks, per), generator=g, device=dev,
                      dtype=torch.int32)
    xs = torch.randint(0, 9, (banks, per), generator=g, device=dev,
                       dtype=torch.int32)
    px = torch.randint(0, nbins, (banks, per), generator=g, device=dev,
                       dtype=torch.int32)
    a = torch.randn((banks, ROWS, COLS), generator=g, device=dev)
    v = torch.randn(COLS, generator=g, device=dev)
    bank_off = (torch.arange(banks, device=dev, dtype=torch.int32)
                * nbins)[:, None]

    # Float and edge-case checks, not timed.  Float tolerances: the kernel
    # adds in another order than the plain version, and a float32 sum's
    # rounding error scales with the magnitudes added, so sums and prefix
    # sums may differ by 1e-6 (about 16 float32 epsilons) times the sum of
    # |x| over the same prefix; GEMV float32 by the registry's rtol = atol =
    # 1e-4; bfloat16 GEMV, compared in float32, by 2e-2, one output
    # rounding step being 2^-8 of the value.
    xf = torch.randn((banks, per), generator=g, device=dev)
    check("reduce_sum f32", ops.reduce_sum(xf), kred.plain(xf, block),
          1e-6 * xf.abs().sum(-1))
    check("scan_inclusive f32", ops.scan_inclusive(xf),
          kscan.plain(xf, block), 1e-6 * xf.abs().cumsum(-1))
    pw = torch.randint(-8, nbins + 8, (banks, per), generator=g, device=dev,
                       dtype=torch.int32)
    check("histogram clipped", ops.histogram(pw, nbins),
          khist.plain(pw, nbins, block), 0)
    ab, vb = a.to(torch.bfloat16), v.to(torch.bfloat16)
    want = kgemv.plain(ab.reshape(-1, COLS), vb).reshape(banks, ROWS)
    check("gemv bf16", ops.gemv(ab, vb), want, rel(want, 2e-2))
    ragged = x[:7, :1000].contiguous()
    check("reduce_sum ragged", ops.reduce_sum(ragged),
          ragged.sum(-1, dtype=torch.int32), 0)
    check("scan_inclusive ragged", ops.scan_inclusive(ragged),
          ragged.cumsum(-1, dtype=torch.int32), 0)
    wrap = torch.full((1, 4096), 1 << 20, device=dev, dtype=torch.int32)
    check("reduce_sum int32 wrap", ops.reduce_sum(wrap),
          kred.plain(wrap, block), 0)
    # spmv_ell: float32 at rtol = atol = 1e-4 (another order of adds, and
    # the kernel fuses multiply and add); bfloat16 compared in float32 at
    # 2e-2 like GEMV.  The ragged case has rows that are no multiple of the
    # row block, k = 5 (no vector loads), columns at and past n (which read
    # x[n-1]) and inf in padded slots (skipped, so the result is finite).
    sv, sc, _ = random_ell(BANKS, ROWS, SPMV_K, COLS, g, dev)
    sx = torch.randn(COLS, generator=g, device=dev)
    want = kspmv.plain(sv.view(-1, SPMV_K), sc.view(-1, SPMV_K),
                       sx).view(BANKS, ROWS)
    check("spmv_ell f32", ops.spmv_ell(sv, sc, sx), want, rel(want, 1e-4))
    sb = sv.to(torch.bfloat16)
    want = kspmv.plain(sb.view(-1, SPMV_K), sc.view(-1, SPMV_K),
                       sx).view(BANKS, ROWS)
    check("spmv_ell bf16", ops.spmv_ell(sb, sc, sx), want, rel(want, 2e-2))
    rc = torch.randint(-1, COLS + 4, (3, 1000, 5), generator=g, device=dev,
                       dtype=torch.int32)
    rv = torch.randn((3, 1000, 5), generator=g, device=dev)
    rv = torch.where(rc < 0, float("inf"), rv)
    want = kspmv.plain(rv.view(-1, 5), rc.view(-1, 5), sx).view(3, 1000)
    check("spmv_ell ragged, cols>=n, inf pad", ops.spmv_ell(rv, rc, sx),
          want, rel(want, 1e-4))

    cases = [
        dict(name="reduce_sum", source="src/repro_torch/csrc/reduce.cu",
             replaces="src/repro/kernels/reduce.py:20",
             kernel=lambda: ops.reduce_sum(x),
             plain=lambda: kred.plain(x, block),
             library=lambda: torch.sum(x, dim=-1, dtype=torch.int32),
             nbytes=x.nbytes + banks * 4, nops=x.numel(), tol=0),
        dict(name="scan_inclusive", source="src/repro_torch/csrc/scan.cu",
             replaces="src/repro/kernels/scan.py:20",
             kernel=lambda: ops.scan_inclusive(xs),
             plain=lambda: kscan.plain(xs, block),
             library=lambda: torch.cumsum(xs, dim=-1, dtype=torch.int32),
             nbytes=2 * xs.nbytes, nops=xs.numel(), tol=0),
        dict(name="histogram", source="src/repro_torch/csrc/histogram.cu",
             replaces="src/repro/kernels/histogram.py:20",
             kernel=lambda: ops.histogram(px, nbins),
             plain=lambda: khist.plain(px, nbins, block),
             library=lambda: torch.bincount(
                 (px.clamp(0, nbins - 1) + bank_off).view(-1),
                 minlength=banks * nbins),
             nbytes=px.nbytes + banks * nbins * 4, nops=px.numel(), tol=0),
        dict(name="gemv", source="src/repro_torch/csrc/gemv.cu",
             replaces="src/repro/kernels/gemv.py:20",
             kernel=lambda: ops.gemv(a, v),
             plain=lambda: kgemv.plain(a.view(-1, COLS), v).view(banks, ROWS),
             library=lambda: torch.mv(a.view(-1, COLS), v),
             nbytes=a.nbytes + v.nbytes + banks * ROWS * 4,
             nops=2 * a.numel(), tol=1e-4),
        spmv_case("spmv_ell", ROWS, COLS, g, dev),
    ]
    rows = [timed(c) for c in cases]
    # the same kernel at 4,096 rows per bank, past the 50 MB L2; its numbers
    # ride in the spmv_ell row
    large = timed(spmv_case("spmv_ell", SPMV_LARGE_ROWS, COLS, g, dev))
    rows[-1][f"at_{SPMV_LARGE_ROWS}_rows_per_bank"] = {
        k: large[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}
    return rows


def timed(c: dict) -> dict:
    """Check one case against its plain version, then time kernel, plain
    version and library call; one row of the kernels line."""
    want = c["plain"]()
    err = check(c["name"], c["kernel"](), want,
                rel(want, c["tol"]) if c["tol"] else 0)
    ms, plain_ms, lib_ms = (cuda_ms(c["kernel"]), cuda_ms(c["plain"]),
                            cuda_ms(c["library"]))
    bound_ms, bound_by = bound(c["nbytes"], c["nops"])
    print(f"  {c['name']:15s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
          f"  library {lib_ms:.4f} ms  bound {bound_ms:.4f} ms "
          f"({bound_by}, {c['nbytes'] / 1e6:.1f} MB)")
    return {"name": c["name"], "route": "cuda", "source": c["source"],
            "replaces": c["replaces"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def phase_row(label: str, t) -> str:
    return (f"{label:14s} {t.cpu_dpu * 1e3:9.3f}m {t.dpu * 1e3:9.3f}m "
            f"{t.inter_dpu * 1e3:9.3f}m {t.dpu_cpu * 1e3:9.3f}m "
            f"{t.total * 1e3:9.3f}m")


PHASE_HEAD = (f"{'bench':14s} {'cpu_dpu':>10s} {'dpu':>10s} {'inter':>10s} "
              f"{'dpu_cpu':>10s} {'total':>10s}")


def suite_phase(args_2048: dict) -> tuple[dict[str, int], dict]:
    """The PrIM suite's banked path through the registry, as
    examples/prim_suite.py drives the reference.  Returns the kernels'
    launch counts from this run alone and the 2,048-bank rows' phase
    times; fills ``args_2048`` with the 2,048-bank arguments."""
    from repro_torch import make_bank_grid
    from repro_torch.kernels import ops
    from repro_torch.prim.registry import REGISTRY

    serialized = {}
    ops.reset_launch_counts()
    for banks, scale in SUITE:
        grid = make_bank_grid(banks)
        rng = np.random.default_rng(0)
        print(f"{PHASE_HEAD}   ({banks} banks, scale {scale})")
        for entry in REGISTRY.values():
            args = entry.make_args(rng, scale=scale)
            if banks == BANKS:
                args_2048[entry.name] = args
            gold = entry.ref(*args)
            variants = dict(entry.run_variants())
            if entry.name in ("GEMV", "SpMV"):
                variants[f"{entry.name}-kernel"] = functools.partial(
                    entry.pim, use_kernel=True)
            for label, fn in variants.items():
                out, t = fn(grid, *args)
                entry.compare(out, gold)
                print(phase_row(label, t) + "   ok")
                if banks == BANKS:
                    serialized.setdefault(entry.name, (label, t))
    return ops.launch_counts(), serialized


def served(rec) -> str:
    """A session request's wall time: its phase buckets are host time
    summed over the rank threads that served it, as in the reference."""
    return (f"   wall {rec.service_s * 1e3:9.3f}m  ({rec.n_ranks} ranks x "
            f"{rec.n_chunks} chunks{', hit' if rec.cache_hit else ''})")


def flat_session_phase(args_2048: dict) -> None:
    """The same workloads through a flat 2,048-bank session (one rank, one
    stream set): cold, then warm where the operand is resident."""
    from repro_torch import pim

    print(f"flat session: {BANKS} banks, 1 rank")
    print(PHASE_HEAD)
    with pim.session(banks=BANKS) as s:
        for name, entry in pim.registry().items():
            args = args_2048[name]
            for leg in ("cold", "warm") if entry.resident else ("cold",):
                entry.compare(s.submit(name, *args).result(timeout=300),
                              entry.ref(*args))
                rec = s.telemetry.records[-1]
                print(phase_row(f"{name} {leg}", rec.phases) + served(rec))


def session_phase(args_2048: dict, serialized: dict) -> dict[str, int]:
    """The session façade over 32 ranks of 64 banks: ``run`` of each
    workload against its registry comparator, ``map``, ``pin`` with warm
    hits that scatter nothing, a two-tenant serving block, and a trace
    export.  Returns the kernels' launch counts from this phase (the
    chunked phases use the plain oracles, as the reference's do)."""
    from repro_torch import pim
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    print(f"session: {RANKS} ranks x {BANKS_PER_RANK} banks; pipelined "
          f"(session.run) beside serialized (suite pim, first variant)")
    print(PHASE_HEAD)
    s = pim.session(ranks=RANKS, banks_per_rank=BANKS_PER_RANK, trace=True)
    reg = pim.registry()
    try:
        for name, entry in reg.items():
            args = args_2048[name]
            out = s.run(name, *args)
            entry.compare(out, entry.ref(*args))
            rec = s.telemetry.records[-1]
            label, ser = serialized[name]
            print(phase_row(f"{name} pipelined", rec.phases) + served(rec))
            print(phase_row(f"{label} serial", ser))
        rng = np.random.default_rng(1)
        reds = [reg["RED"].make_args(rng, scale=256) for _ in range(4)]
        for out, args in zip(s.map("RED", reds), reds):
            reg["RED"].compare(out, reg["RED"].ref(*args))
        print("map: 4 RED requests ok")
        spans = s.tracer.spans
        for name in ("GEMV", "SpMV"):
            s.pin(name, *args_2048[name])
            pushed = sum(sp.name == "scatter" for sp in spans)
            cached = sum(sp.name == "scatter:cached" for sp in spans)
            for _ in range(2):
                out = s.run(name, *args_2048[name])
                reg[name].compare(out, reg[name].ref(*args_2048[name]))
                rec = s.telemetry.records[-1]
                assert rec.cache_hit, (name, "warm run missed the cache")
                print(phase_row(f"{name} warm", rec.phases) + served(rec))
            assert sum(sp.name == "scatter" for sp in spans) == pushed, (
                f"a warm {name} request scattered a chunk")
            assert sum(sp.name == "scatter:cached" for sp in spans) > cached
        cache = s.stats()["cache"]
        print(f"cache: {cache}")
        assert cache["hits"] > 0, cache
        path = s.trace_export(TRACE)
    finally:
        s.close()
    with open(path) as f:
        names = {ev["name"] for ev in json.load(f)["traceEvents"]}
    missing = {"scatter", "compute", "retrieve", "merge"} - names
    assert not missing, f"trace lacks {missing}"
    print(f"trace: {len(names)} span names, {os.path.getsize(path)} bytes")

    hst = [reg["HST"].make_args(rng, scale=64) for _ in range(4)]
    red = [reg["RED"].make_args(rng, scale=64) for _ in range(4)]
    with pim.session(ranks=RANKS, banks_per_rank=BANKS_PER_RANK,
                     tenants={"gold": 2.0, "free": 1.0}) as srv:
        reqs = []
        for h, r in zip(hst, red):
            reqs.append(("HST", h, srv.submit(
                "HST", *h, options=pim.RequestOptions(tenant="gold"))))
            reqs.append(("RED", r, srv.submit(
                "RED", *r, options=pim.RequestOptions(tenant="free"))))
        for name, args, req in reqs:
            reg[name].compare(req.result(timeout=60), reg[name].ref(*args))
        tenants = srv.stats()["tenants"]
    done = {t: tenants[t]["completed"] for t in ("gold", "free")}
    assert done == {"gold": 4, "free": 4}, tenants
    print(f"serving: 8 submits over tenants gold:free = 2:1 ok {done}")
    return ops.launch_counts()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import cuda_lib

    name, smi = torch.cuda.get_device_name(0), smi_line()
    print(f"device: {name}  ({smi}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    paths, log = cuda_lib.build()
    cuda_lib.library()
    print(f"build: {time.perf_counter() - t0:.2f} s, one nvcc per source -> "
          + ", ".join(os.path.relpath(p, ROOT) for p in paths))
    for line in log.splitlines():
        if line.startswith("==") or "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    print("kernels (2,048 banks; against the plain PyTorch version):")
    rows = kernel_phase(torch.device("cuda", 0))
    args_2048: dict = {}
    t0 = time.perf_counter()
    counts, serialized = suite_phase(args_2048)
    print(f"suite: {time.perf_counter() - t0:.2f} s; launches {counts}")
    for r in rows:
        r["launches"] = counts[r["name"]]
    missing = [r["name"] for r in rows if r["launches"] <= 0]
    assert not missing, f"the suite launched no {missing}"
    assert sorted(counts) == sorted(r["name"] for r in rows), counts
    t0 = time.perf_counter()
    session_counts = session_phase(args_2048, serialized)
    print(f"session: {time.perf_counter() - t0:.2f} s; launches "
          f"{session_counts} (the chunked phases run the plain oracles)")
    t0 = time.perf_counter()
    flat_session_phase(args_2048)
    print(f"flat session: {time.perf_counter() - t0:.2f} s")

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
