#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain PyTorch
version at the PrIM suite's shapes and times it, drives the suite's banked
path (GEMV, HST, RED, SCAN) through the registry at 2,048 banks, checks
every result against ``ref()``, and shows that the suite went through the
kernels.

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
# 65536 * 1024 int32 values, 32,768 per bank; GEMV 256 rows of 256 per bank
BANKS, PER, ROWS, COLS = 2048, 32768, 256, 256
TIMED_ITERS = 20


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


def kernel_phase(dev) -> list[dict]:
    """Each kernel at the suite's 2,048-bank shapes: the error against its
    plain version on the same inputs, and its times."""
    from repro_torch.kernels import gemv as kgemv
    from repro_torch.kernels import histogram as khist
    from repro_torch.kernels import ops
    from repro_torch.kernels import reduce as kred
    from repro_torch.kernels import scan as kscan

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
    ]
    rows = []
    for c in cases:
        want = c["plain"]()
        err = check(c["name"], c["kernel"](), want,
                    rel(want, c["tol"]) if c["tol"] else 0)
        ms, plain_ms, lib_ms = (cuda_ms(c["kernel"]), cuda_ms(c["plain"]),
                                cuda_ms(c["library"]))
        bound_ms, bound_by = bound(c["nbytes"], c["nops"])
        print(f"  {c['name']:15s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
              f"  library {lib_ms:.4f} ms  bound {bound_ms:.4f} ms "
              f"({bound_by})")
        rows.append({"name": c["name"], "route": "cuda", "source": c["source"],
                     "replaces": c["replaces"], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms})
    return rows


def suite_phase() -> dict[str, int]:
    """The PrIM suite's banked path through the registry, as
    examples/prim_suite.py drives the reference; returns the kernels'
    launch counts from this run alone."""
    from repro_torch import make_bank_grid
    from repro_torch.kernels import ops
    from repro_torch.prim.registry import REGISTRY

    ops.reset_launch_counts()
    for banks, scale in SUITE:
        grid = make_bank_grid(banks)
        rng = np.random.default_rng(0)
        print(f"{'bench':12s} {'cpu_dpu':>10s} {'dpu':>10s} {'inter':>10s} "
              f"{'dpu_cpu':>10s} {'total':>10s}   ({banks} banks, "
              f"scale {scale})")
        for entry in REGISTRY.values():
            args = entry.make_args(rng, scale=scale)
            gold = entry.ref(*args)
            variants = dict(entry.run_variants())
            if entry.name == "GEMV":
                variants["GEMV-kernel"] = functools.partial(entry.pim,
                                                            use_kernel=True)
            for label, fn in variants.items():
                out, t = fn(grid, *args)
                entry.compare(out, gold)
                print(f"{label:12s} {t.cpu_dpu * 1e3:9.3f}m {t.dpu * 1e3:9.3f}m "
                      f"{t.inter_dpu * 1e3:9.3f}m {t.dpu_cpu * 1e3:9.3f}m "
                      f"{t.total * 1e3:9.3f}m   ok")
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
    path, log = cuda_lib.build()
    cuda_lib.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(path, ROOT)}")
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    print("kernels (2,048 banks; against the plain PyTorch version):")
    rows = kernel_phase(torch.device("cuda", 0))
    counts = suite_phase()
    for r in rows:
        r["launches"] = counts[r["name"]]
    missing = [r["name"] for r in rows if r["launches"] <= 0]
    assert not missing, f"the suite launched no {missing}"
    assert sorted(counts) == sorted(r["name"] for r in rows), counts

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
