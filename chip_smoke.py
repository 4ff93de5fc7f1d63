#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain PyTorch
version at the shapes its path gives it and times it, drives the suite's
banked path (all 16 PrIM workloads of the registry) at 2,048 banks and at
1 bank, checks every result against ``ref()``, shows that the suite went
through the kernels, and then drives the same workloads through the
session façade, ``repro_torch.pim.session(ranks=32, banks_per_rank=64)``:
``run`` of all 16, ``map``, ``pin`` with warm hits (GEMV, SpMV and MLP
scatter nothing; BS skips its broadcast but scatters its queries), a
two-tenant serving block and a trace export, and then a flat 2,048-bank
session, every result checked with the registry's comparator.  NW runs at
scale 32 and TRNS on 64 banks in the 2,048-bank leg (``suite_plan``).
Then the tune phase: the paper's characterization sweeps on the flat
2,048 banks (one line a sweep, the fitted stage models and CostModel, the
measured HBM rate beside the data sheet's), and ``pim.session(...)
.autotune`` on the suite's scale-1024 arguments — the 14 pipelineable
workloads (TRNS on 64 banks), the cost-model pre-filter on GEMV / RED /
SpMV, and the rank count over 32 ranks — each plan held to tuned >=
default and each served result to ``ref()``.  Then the LM
serving stack on TinyLlama 1.1B at its published width (seeded weights):
the prefill ``transformer.forward(use_kernel=True)`` through the
``flash_attention`` kernel, checked against the plain forward and timed,
teacher-forced ``decode_step`` against the prefill logits, and
``greedy_generate`` on the card against the ``DecodeEngine`` on a flat
session, token for token.  Then the MoE family on DeepSeek-MoE 16B at its
published width: float32 at 4 layers (kernel against plain forward, and
decode against prefill at a capacity factor that drops nothing), bfloat16
at all 28 layers (the prefill through ``moe_gmm`` and ``flash_attention``,
timed beside the plain forward, its dropped pairs and the top-k sets the
two forwards route differently) and ``greedy_generate``.  Last the hybrid
family on Jamba 1.5 Large at full width cut to 2 layers (one card holds
11.9 B of its 397.5 B parameters): the same legs, its prefill through
``ssd_scan``, ``moe_gmm`` and ``flash_attention`` in one forward.  For
the two bfloat16 MoE prefills it prints a ``torch.profiler`` breakdown of
one forward: the top device operations and the device's busy share.

    python3 chip_smoke.py [--build | --only PHASE[,PHASE...]]

Needs one CUDA device and ``nvcc``; exits non-zero without them.  The
build prints each kernel's ``-Xptxas -v`` summary (registers, spills,
static shared memory); ``--build`` stops there, the first and short call
after a kernel changes.  ``--only kernels,hybrid`` runs those of PHASES
alone, e.g. to time a parent commit's kernels in the same call
(``--only tune`` makes the suite's arguments itself).  The last
line is ``{"ok": true, "device": {...}}``; the line before it is the card's
name and power limit from ``nvidia-smi``, and the one before that a JSON
``{"kernels": [...]}`` with each kernel's launches in the tune phase
(``tune_launches``) and on its path (``launches``: the suite;
for flash_attention one TinyLlama prefill forward, for moe_gmm one
DeepSeek-MoE forward, for ssd_scan one forward of the Jamba cut), its
error against its plain version, and its times beside its bound: ``ms``
(CUDA events around back-to-back calls of the wrapper) and ``device_ms``
(the device operations those calls launched, from ``torch.profiler``), the
same two for the library call, the CUDA launches of the port's kernels per
wrapper call, and for the short rows (reduce_sum at 2,048 banks and at 1
bank, gemv, scan at 1 bank, spmv_ell at 256 rows per bank,
flash_attention at TinyLlama's shape) min / median / max over REPEATS
measurements, each time over the repeats whose profile recorded it (their
count beside it).  gemv's row says whether it loses to ``torch.mv`` by
more than the two rows' spread, on the device times when VERDICT_MIN
repeats of both rows have them.
"""
import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: HBM3 bandwidth, and the float32 rate outside the
# tensor cores (the int32 adds of RED / SCAN / HST are counted at it too;
# the data sheet lists no int32 rate).  Every kernel here is far below the
# ridge point, so its bound is the bytes.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# ... and its dense bfloat16 tensor-core rate, the bound of attention's
# operations (the flash_attention rows are bfloat16)
BF16_TC_OPS_PER_S = 989e12

SUITE = ((2048, 1024), (1, 64))     # (banks, make_args scale)
# NW in every leg and phase: 2,048 bases a sequence, a 2,049^2 int32 score
# matrix in 127 block diagonals.  Its ref() is an O(m n) Python loop, and
# at scale 1024 the host's score matrix alone would be 17 GB.
NW_SCALE = 32
# TRNS in the 2,048-bank leg: make_args fixes N = 512, so N' = 64 rows of
# tiles, and the reference's assertion asks N' to divide across the banks
TRNS_BANKS = 64
TRNS_NP = 512 // 8
# the kernels' shapes on the suite's 2,048-bank run: RED / SCAN / HST hold
# 65536 * 1024 int32 values, 32,768 per bank; GEMV 256 rows of 256 per
# bank; SpMV 256 ELL rows of k = 8 per bank over an x of 256
BANKS, PER, ROWS, COLS = 2048, 32768, 256, 256
SPMV_K, SPMV_LARGE_ROWS = 8, 4096   # and a per-bank height past the L2
# the suite's 1-bank run: SCAN on 65536 * 64 values in one bank, the
# longest chain of tiles on the main path
SCAN_ONE_BANK = 65536 * SUITE[1][1]
TIMED_ITERS = 20
REPEATS = 5                         # measurements of each short row
VERDICT_MIN = 3                     # gemv's verdict on device times from
                                    # this many repeats of both rows
# the suite's 1-bank GEMV: 32,768 rows of 256 (make_args at scale 64)
GEMV_ONE_BANK_ROWS = 32768
# the session phase: the suite's 2,048 banks as 32 ranks of 64 DPUs
RANKS, BANKS_PER_RANK = 32, 64
TRACE = os.path.join(ROOT, "build", "repro_torch", "chip_smoke_trace.json")
# the LM phase: TinyLlama 1.1B (configs/tinyllama_1_1b.py:FULL) prefill of
# 2,048 tokens, and the H2O-Danube3 attention shape as a second kernel row
LM_ARCH, PREFILL = "tinyllama-1.1b", 2048
DANUBE = dict(H=32, KVH=8, S=8192, D=120, window=4096)
CONSIST = 32                        # teacher-forced decode tokens
DECODE_STREAMS, DECODE_PROMPT, DECODE_NEW = 2, 8, 8
DECODE_BANKS = 256                  # flat session: one rank, 8 GB budget
# the MoE phase: DeepSeek-MoE 16B (configs/deepseek_moe_16b.py:FULL); its
# float32 legs at 4 layers (the dense layer 0 and 3 MoE layers, ~9 GB: all
# 28 in float32 are 65.5 GB and leave no room for a plain forward)
MOE_ARCH, MOE_F32_LAYERS = "deepseek-moe-16b", 4
# the hybrid phase: Jamba 1.5 Large (configs/jamba_1_5_large_398b.py:FULL)
# at full width cut to 2 layers, attention + MoE and Mamba + dense: 11.9 B
# parameters (47.6 GB in float32, 23.8 GB in bfloat16) of its 397.5 B
HYBRID_ARCH, HYBRID_LAYERS = "jamba-1.5-large-398b", 2
BIG_ITERS = 3                       # timed launches of the largest rows
# the tune phase: characterization on the flat 2,048 banks, then the
# autotuner on the suite's scale-1024 arguments: 13 workloads on a flat
# 2,048-bank session, TRNS on 64 banks (its N' = 64), the constructor's
# autotune= on 64 banks at scale 64, a cost-model leg and a ranked leg
TUNE_SCALE, TUNE_REPS = 1024, 2
COST_TUNE = ("GEMV", "RED", "SpMV")
RANK_TUNE = ("GEMV", "RED", "SpMV")
# stream_wram and rank_parallel_sweep at sizes past the card's 50 MB L2
# (the reference's defaults, 4 MB, would time the L2)
STREAM_N = 1 << 28                  # int32 elements: 1 GiB an array
RANK_SWEEP_BYTES = 1 << 28
TRANSFER_MB_PER_BANK = 1            # transfer_sweep: 2 GiB over 2,048 banks
# the phases, in order; ``--only a,b`` runs those alone (the session phase
# needs the suite's arguments; the tune phase makes them itself when the
# suite did not run)
PHASES = ("kernels", "suite", "session", "tune", "lm", "moe", "hybrid")
# a forward's device time spent in each kernel of the port: the part of the
# CUDA kernels' names that marks them
SHARES = {"flash_attention": "flash_", "moe_gmm": "gmm_", "ssd_scan": "ssd_"}


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name cut to its own name and template numbers:
    ``flash_bf16_k<64,128>``."""
    i = mangled.find("_ZN")
    if i < 0:
        return mangled
    i, parts = i + 3, []
    while i < len(mangled) and mangled[i].isdigit():   # <length><name> ...
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    if not parts:
        return mangled
    args = (re.findall(r"Li(\d+)E", mangled[i:mangled.find("EE", i) + 2])
            if mangled[i:i + 1] == "I" else [])
    return parts[-1] + (f"<{','.join(args)}>" if args else "")


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel of the compilers' ``-Xptxas -v`` output: the
    source, the kernel (its mangled name cut to the base name and template
    numbers), its registers, spills and shared memory, and any
    performance note ptxas gave."""
    out, name = [], "?"
    for line in log.splitlines():
        if line.startswith("=="):
            out.append(line.strip())
        elif "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
        elif "bytes stack frame" in line:
            spill = line.strip()
        elif "Used" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
        elif "Potential Performance Loss" in line or "warning" in line:
            out.append(line.strip())
    return out


def cuda_ms(fn, iters: int = TIMED_ITERS) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls between two
    CUDA events, after warm-up: the device's time when the device is the
    slower side, the host's when each call's host work is longer."""
    for _ in range(min(3, iters)):
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


def device_ops(prof) -> list[tuple[float, int, str]]:
    """(device ms, count, name) of each device operation (kernel, memset,
    copy) in a profile: operations that ran on the device only, never the
    host operations that launched them, whose self device time would count
    the same work twice."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((us / 1e3, e.count, e.key))
    return rows


def device_ms(fn, iters: int = TIMED_ITERS,
              ops_seen: list | None = None) -> float | None:
    """Device time of one call of ``fn``: the sum of the device time of
    every device operation that ``iters`` calls launched, under
    ``torch.profiler``, over ``iters``, after a warm-up call.  Every call
    launches the same operations, so each count is a multiple of
    ``iters``; a profile where one is not has lost records (an H100 run
    without this check read a row below its bound), and one that records
    no device time at all has lost every record: either is taken again, up
    to 3 attempts, each printed.  None when no attempt gives a whole
    profile: a lossy one reads low, so its time is left out.  ``ops_seen``
    receives the operations of the whole profile (``device_ops``) and is
    left as it was when there is none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            rows = device_ops(prof)
        lost = [(n, name) for _, n, name in rows if n % iters]
        if rows and not lost:
            if ops_seen is not None:
                ops_seen[:] = rows
            return sum(r[0] for r in rows) / iters
        print("    profiler: " + (f"counts {lost} are no multiple of {iters} "
                                  f"calls" if rows else "no device time "
                                  "recorded") + f" (attempt {attempt + 1})")
    print("    profiler: no whole profile in 3 attempts: device time left out")
    return None


def own_launches(ops_seen: list, iters: int) -> float | None:
    """Launches of the port's own kernels per call in a ``device_ms``
    profile of ``iters`` calls: every device operation but PyTorch's
    (``at::``: the fills of ``torch.zeros``) and memsets or copies."""
    if not ops_seen:
        return None
    own = sum(n for _, n, name in ops_seen if "at::" not in name
              and not name.startswith(("Memset", "Memcpy")))
    return own / iters


def bound(nbytes: int, nops: int,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
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


def spmv_case(name: str, rows: int, n: int, g, dev, tol=1e-4,
              repeats: int = 1) -> dict:
    """One timed spmv_ell case at (2048, rows, k): the kernel, its plain
    version, and cuSPARSE's CSR product over the same stored entries
    (built outside the timed window).  Bytes: all of cols, the stored
    vals, x, y; operations: 2 per stored entry.  ``read_once``: vals and
    cols each read once by ``torch.sum``, the device time any ELL kernel
    that reads both whole would need."""
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
        nops=2 * nnz, tol=tol, repeats=repeats,
        read_once=lambda: (torch.sum(cols, dtype=torch.int32),
                           torch.sum(vals)))


def kernel_phase(dev) -> list[dict]:
    """Each kernel at the suite's 2,048-bank shapes: the error against its
    plain version on the same inputs, and its times.  reduce_sum, gemv and
    scan_inclusive are also timed at the suite's 1-bank shape, spmv_ell at
    4,096 rows per bank, whose bytes leave the L2."""
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
    first = ops.reduce_sum(xf)
    check("reduce_sum f32", first, kred.plain(xf, block),
          1e-6 * xf.abs().sum(-1))
    assert all(torch.equal(ops.reduce_sum(xf), first) for _ in range(2)), (
        "reduce_sum f32 differs between calls")
    print("  check reduce_sum f32 3 calls          bit for bit equal")
    check("scan_inclusive f32", ops.scan_inclusive(xf),
          kscan.plain(xf, block), 1e-6 * xf.abs().cumsum(-1))
    check("scan_exclusive f32", ops.scan_exclusive(xf),
          kscan.plain(xf, block) - xf, 1e-6 * xf.abs().cumsum(-1))
    x1f = torch.randn((1, SCAN_ONE_BANK), generator=g, device=dev)
    check("scan_inclusive f32 1 bank", ops.scan_inclusive(x1f),
          kscan.plain(x1f, block), 1e-6 * x1f.abs().cumsum(-1))
    del x1f
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
             nbytes=x.nbytes + banks * 4, nops=x.numel(), tol=0,
             repeats=REPEATS),
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
             nops=2 * a.numel(), tol=1e-4, repeats=REPEATS,
             read_once=lambda: torch.sum(a)),
        spmv_case("spmv_ell", ROWS, COLS, g, dev, repeats=REPEATS),
    ]
    rows = [timed(c) for c in cases]
    # reduce_sum at the suite's 1-bank shape, beside torch.sum
    x1 = torch.randint(0, 99, (1, SCAN_ONE_BANK), generator=g, device=dev,
                       dtype=torch.int32)
    rows[0]["at_1_bank_4194304"] = dict_of(timed(dict(
        cases[0], kernel=lambda: ops.reduce_sum(x1),
        plain=lambda: kred.plain(x1, block),
        library=lambda: torch.sum(x1, dim=-1, dtype=torch.int32),
        nbytes=x1.nbytes + 4, nops=x1.numel())))
    del x1
    # gemv at the suite's 1-bank shape, beside torch.mv
    a1 = torch.randn((1, GEMV_ONE_BANK_ROWS, COLS), generator=g, device=dev)
    gemv = next(r for r in rows if r["name"] == "gemv")
    gemv["at_1_bank_32768_rows"] = dict_of(timed(dict(
        cases[3], kernel=lambda: ops.gemv(a1, v),
        plain=lambda: kgemv.plain(a1.view(-1, COLS), v).view(1, -1),
        library=lambda: torch.mv(a1.view(-1, COLS), v),
        nbytes=a1.nbytes + v.nbytes + GEMV_ONE_BANK_ROWS * 4,
        nops=2 * a1.numel(), read_once=lambda: torch.sum(a1))))
    gemv["at_1_bank_32768_rows"]["note"] = (
        "A's 33.5 MB fit the 50 MB L2, so back-to-back calls may run under "
        "the HBM bound: the share of the bound is not read")
    del a1
    gemv_verdict(gemv)
    # scan_inclusive at the suite's 1-bank shape, and the exclusive scan
    # the suite calls (ops.scan_exclusive) at 2,048 banks; both ride in the
    # scan_inclusive row
    x1 = torch.randint(0, 9, (1, SCAN_ONE_BANK), generator=g, device=dev,
                       dtype=torch.int32)
    scan = next(r for r in rows if r["name"] == "scan_inclusive")
    scan["at_1_bank_4194304"] = dict_of(timed(dict(
        cases[1], kernel=lambda: ops.scan_inclusive(x1),
        plain=lambda: kscan.plain(x1, block),
        library=lambda: torch.cumsum(x1, dim=-1, dtype=torch.int32),
        nbytes=2 * x1.nbytes, nops=x1.numel(), repeats=REPEATS)))
    scan["exclusive_at_2048_banks"] = dict_of(timed(dict(
        cases[1], kernel=lambda: ops.scan_exclusive(xs),
        plain=lambda: kscan.plain(xs, block) - xs,
        library=lambda: torch.cumsum(xs, dim=-1, dtype=torch.int32) - xs)))
    del x1
    # the same kernel at 4,096 rows per bank, past the 50 MB L2; its numbers
    # ride in the spmv_ell row
    large = timed(spmv_case("spmv_ell", SPMV_LARGE_ROWS, COLS, g, dev))
    rows[-1][f"at_{SPMV_LARGE_ROWS}_rows_per_bank"] = dict_of(large)
    rows.append(flash_rows(g, dev))
    rows.append(gmm_rows(g, dev))
    rows.append(ssd_rows(g, dev))
    return rows


def gemv_verdict(row: dict) -> None:
    """Whether gemv loses to torch.mv by more than the two rows' spread
    (max - min over REPEATS measurements), on the device times when at
    least VERDICT_MIN of the repeats of both rows have them, else on the
    event times; kept in the row with the times it used."""
    sp = row["spread"]
    k, lib = (("device_ms", "library_device_ms")
              if min(row["device_ms_n"], row["library_device_ms_n"])
              >= VERDICT_MIN else ("ms", "library_ms"))
    gap = sp[k][1] - sp[lib][1]
    spread = (sp[k][2] - sp[k][0]) + (sp[lib][2] - sp[lib][0])
    row["verdict"] = (
        "slower than torch.mv beyond the spread: first for the next redesign"
        if gap > spread else
        "no slower than torch.mv within spread; left alone (rule 2)")
    row["verdict_on"] = (f"{k} ({row.get(k + '_n', REPEATS)} of {REPEATS} "
                         f"repeats), {lib} ({row.get(lib + '_n', REPEATS)} of "
                         f"{REPEATS})")
    print(f"  gemv vs torch.mv ({row['verdict_on']}): median gap {gap:.4f} "
          f"ms, spread {spread:.4f} ms: {row['verdict']}")


def dict_of(row: dict) -> dict:
    """A row's numbers, to ride in another row of the same kernel."""
    return {k: row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "library_device_ms", "device_ms_n",
                                "library_device_ms_n", "read_once_device_ms",
                                "cuda_launches_per_call", "spread")
            if k in row}


def live_pairs(S: int, T: int, window) -> int:
    """(q, k) pairs a causal mask leaves live: query i at i + (T - S) sees
    keys in (qpos - window, qpos] within [0, T)."""
    qpos = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(T - 1, qpos)
    lo = np.maximum(0, qpos - window + 1) if window is not None else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_case(name: str, B, H, KVH, S, T, D, window, g, dev) -> dict:
    """One timed flash_attention case in bfloat16, causal: the kernel, its
    plain version, and ``scaled_dot_product_attention`` (``is_causal`` at
    S = T, an explicit boolean mask for the window).  Operations: 4 D per
    live (q, k) pair and head; bytes: q, k, v and o once.  Tolerance
    4e-3 * (1 + |o|): the kernel rounds P once to bfloat16 before the P V
    product (in float32's 24 bits, as three bfloat16 terms, on the tiles
    that cross the diagonal, the window edge or T, which hold every key of
    the rows that see few keys), and both round a float32 output to
    bfloat16, so an output may land one bfloat16 step (2^-8 |o|) away, and
    no further."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops

    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((B, H, S, D), (B, KVH, T, D), (B, KVH, T, D)))
    if window is None:
        lib = functools.partial(F.scaled_dot_product_attention, q, k, v,
                                is_causal=True, enable_gqa=True)
    else:
        qpos = torch.arange(S, device=dev)[:, None] + (T - S)
        kpos = torch.arange(T, device=dev)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        lib = functools.partial(F.scaled_dot_product_attention, q, k, v,
                                attn_mask=mask, enable_gqa=True)
    return dict(
        name=name, source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:27",
        kernel=lambda: ops.attention(q, k, v, causal=True, window=window),
        plain=lambda: kfa.plain(q, k, v, causal=True, window=window),
        library=lib, nbytes=2 * q.nbytes + k.nbytes + v.nbytes,
        nops=4 * B * H * D * live_pairs(S, T, window),
        ops_per_s=BF16_TC_OPS_PER_S, tol=4e-3)


def flash_rows(g, dev) -> dict:
    """flash_attention: small correctness cases (not timed), at the
    reference's kernel-test tolerances (rtol = atol = 2e-3 float32, 2e-2
    bfloat16), then the TinyLlama prefill shape, the H2O-Danube3 shape,
    and the prefill shapes of DeepSeek-MoE (16 heads of 128) and the Jamba
    cut (64 query / 8 key-value heads of 128), timed, at 4e-3
    (``flash_case``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops

    for label, (B, H, KVH, S, T, D, causal, window, dtype) in {
            "f32 GQA causal": (2, 8, 2, 300, 300, 64, True, None,
                               torch.float32),
            "S != T, not causal": (1, 4, 4, 96, 160, 64, False, None,
                                   torch.bfloat16),
            "causal S > T": (1, 4, 2, 200, 72, 64, True, None, torch.float32),
            "window 16": (1, 4, 2, 500, 500, 128, True, 16, torch.bfloat16),
            "MQA": (1, 8, 1, 256, 256, 120, True, None, torch.bfloat16),
            "head dim 160": (1, 3, 3, 200, 200, 160, True, None,
                             torch.float32)}.items():
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((B, H, S, D), (B, KVH, T, D), (B, KVH, T, D)))
        got = ops.attention(q, k, v, causal=causal, window=window)
        want = kfa.plain(q, k, v, causal=causal, window=window)
        check(f"flash_attention {label}", got, want,
              rel(want, 2e-3 if dtype == torch.float32 else 2e-2))
        if causal and S > T:
            assert bool((got[:, :, :S - T] == 0).all()), "masked rows not 0"

    cfg = get_config(LM_ARCH)
    row = timed(dict(flash_case("flash_attention", 1, cfg.n_heads,
                                cfg.n_kv_heads, PREFILL, PREFILL, cfg.hd,
                                cfg.window, g, dev), repeats=REPEATS))
    d = DANUBE
    large = timed(flash_case("flash_attention", 1, d["H"], d["KVH"], d["S"],
                             d["S"], d["D"], d["window"], g, dev))
    row["at_h2o_danube3_8192_window_4096"] = dict_of(large)
    ds = get_config(MOE_ARCH)
    moe = timed(flash_case("flash_attention", 1, ds.n_heads, ds.n_kv_heads,
                           PREFILL, PREFILL, ds.hd, ds.window, g, dev))
    row["at_deepseek_moe_16b_prefill"] = dict_of(moe)
    jb = get_config(HYBRID_ARCH)
    hybrid = timed(flash_case("flash_attention", 1, jb.n_heads, jb.n_kv_heads,
                              PREFILL, PREFILL, jb.hd, jb.window, g, dev))
    row["at_jamba_cut_prefill"] = dict_of(hybrid)
    torch.cuda.empty_cache()
    return row


def gmm_case(E: int, C: int, d: int, f: int, g, dev,
             iters: int = TIMED_ITERS) -> dict:
    """One timed moe_gmm case in bfloat16: x (E, C, d) unit normals, w
    (E, d, f) scaled by d^-0.5 as the model's init scales it, counts
    seeded in [ceil(0.8 C), C] with expert 0 at 0.  Bytes: the weights of
    the experts with a live row, the live rows of x, all of y (dead rows
    are written as zeros) and the counts; operations: 2 d f per live row,
    at the bfloat16 tensor-core rate.  Tolerance 8e-3 * (1 + |y|): both
    round float32 sums that differ in their last bits to bfloat16, one
    step being at most 2^-7 of the value.  The library call is
    ``torch.bmm`` of the same operands: the whole product, without the
    row mask."""
    from repro_torch.kernels import moe_gmm as kgmm
    from repro_torch.kernels import ops

    x = torch.randn((E, C, d), generator=g, device=dev, dtype=torch.bfloat16)
    w = torch.randn((E, d, f), generator=g, device=dev,
                    dtype=torch.bfloat16).mul_(d ** -0.5)
    cnt = torch.randint(-(-4 * C // 5), C + 1, (E,), generator=g, device=dev,
                        dtype=torch.int32)
    cnt[0] = 0
    live = int(cnt.clamp(0, C).sum())
    experts = int((cnt > 0).sum())
    return dict(
        name="moe_gmm", source="src/repro_torch/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm.py:21",
        kernel=lambda: ops.moe_gmm(x, w, cnt),
        plain=lambda: kgmm.plain(x, w, cnt),
        library=lambda: torch.bmm(x, w),
        nbytes=2 * (experts * d * f + live * d + E * C * f) + 4 * E,
        nops=2 * live * d * f, ops_per_s=BF16_TC_OPS_PER_S, tol=8e-3,
        iters=iters)


def gmm_rows(g, dev) -> dict:
    """moe_gmm at DeepSeek-MoE's prefill shapes (64 experts, capacity 240
    at 2,048 tokens: up (64, 240, 2048) x (64, 2048, 2816), down (64, 240,
    1408) x (64, 1408, 2048)) and the Jamba cut's up and down projections
    (16 experts, capacity 320: (16, 320, 8192) x (16, 8192, 49152), 12.9 GB
    of bfloat16 weights, whose plain version makes a 25.8 GB float32 copy,
    and (16, 320, 24576) x (16, 24576, 8192); each built alone and
    freed).  Small cases first, at the reference's
    kernel-test tolerances: float32 at 1e-3, a C that is no multiple of
    the row tile, odd d and f (no 16-byte loads), counts 0 and C."""
    from repro_torch.kernels import moe_gmm as kgmm
    from repro_torch.kernels import ops

    for label, (E, C, d, f, dtype) in {
            "f32 ragged counts": (4, 100, 200, 300, torch.float32),
            "bf16 odd d, f": (3, 37, 13, 9, torch.bfloat16),
            "bf16 C not a tile": (8, 240, 512, 320, torch.bfloat16)}.items():
        x = torch.randn((E, C, d), generator=g, device=dev).to(dtype)
        w = torch.randn((E, d, f), generator=g, device=dev).to(dtype)
        cnt = torch.randint(0, C + 1, (E,), generator=g, device=dev,
                            dtype=torch.int32)
        cnt[0], cnt[1] = 0, C
        want = kgmm.plain(x, w, cnt)
        check(f"moe_gmm {label}", ops.moe_gmm(x, w, cnt), want,
              rel(want, 1e-3 if dtype == torch.float32 else 5e-2))
    row = timed(gmm_case(64, 240, 2048, 2816, g, dev))
    row["at_deepseek_down"] = dict_of(timed(gmm_case(64, 240, 1408, 2048,
                                                     g, dev)))
    torch.cuda.empty_cache()
    row["at_jamba_up"] = dict_of(timed(gmm_case(16, 320, 8192, 49152, g, dev,
                                                iters=BIG_ITERS)))
    torch.cuda.empty_cache()
    row["at_jamba_down"] = dict_of(timed(gmm_case(16, 320, 24576, 8192, g,
                                                  dev, iters=BIG_ITERS)))
    torch.cuda.empty_cache()
    return row


def ssd_case(dtype, g, dev, B=1, S=PREFILL, H=256, P=64, N=16,
             L=128) -> dict:
    """One timed ssd_scan case at the Jamba cut's shape (d 8192, expand 2,
    head dim 64: H 256; state 16; chunk 128): x, b, c in ``dtype``, a
    float32 in [0.3, 1).  The kernel against the sequential plain version
    on y and the final h (5e-3, the reference's chunked-vs-sequential
    tolerance; y at 2e-2 in bfloat16, both rounding to bfloat16), after a
    check against the chunked form in plain PyTorch.  Bytes: x, a, b, c
    read once, y and h written once; operations per (b, h, chunk): the
    L (L + 1) / 2 pairs t >= s of C B^T (2 N each) and of the masked
    product with X (2 P each), C h0 and the state update (2 L N P each),
    at the tensor-core rate for bfloat16 inputs and the float32 rate
    otherwise.  No one PyTorch call computes the scan."""
    from repro_torch.kernels import mamba_scan as kmamba
    from repro_torch.kernels import ops

    x = torch.randn((B, S, H, P), generator=g, device=dev).to(dtype)
    a = torch.rand((B, S, H), generator=g, device=dev) * 0.7 + 0.3
    b = torch.randn((B, S, N), generator=g, device=dev).to(dtype)
    c = torch.randn((B, S, N), generator=g, device=dev).to(dtype)
    y, h = ops.ssd_scan(x, a, b, c, chunk=L)
    cy, ch = kmamba.chunked(x, a, b, c, L)
    bf16 = dtype == torch.bfloat16
    check(f"ssd_scan {str(dtype)[6:]} vs chunked y", y, cy,
          rel(cy, 2e-2 if bf16 else 1e-3))
    check(f"ssd_scan {str(dtype)[6:]} vs chunked h", h, ch, rel(ch, 1e-3))
    del y, h, cy, ch

    def final_h(got, want):
        """Check the final states; the row's error is y's."""
        check(f"ssd_scan {str(dtype)[6:]} final h", got[1], want[1],
              rel(want[1], 5e-3))
        return got[0], want[0]

    n = -(-S // L)
    return dict(
        name="ssd_scan", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/mamba_scan.py:26",
        kernel=lambda: ops.ssd_scan(x, a, b, c, chunk=L),
        plain=lambda: kmamba.plain(x, a, b, c), library=None, check=final_h,
        nbytes=2 * x.nbytes + a.nbytes + b.nbytes + c.nbytes + B * H * N * P * 4,
        nops=B * H * n * (L * (L + 1) * (N + P) + 4 * L * N * P),
        ops_per_s=BF16_TC_OPS_PER_S if bf16 else F32_OPS_PER_S,
        tol=2e-2 if bf16 else 5e-3, iters=BIG_ITERS)


def ssd_rows(g, dev) -> dict:
    row = timed(ssd_case(torch.bfloat16, g, dev))
    row["at_float32"] = dict_of(timed(ssd_case(torch.float32, g, dev)))
    torch.cuda.empty_cache()
    return row


def fmt(t) -> str:
    return "-" if t is None else f"{t:.4f}"


def timed(c: dict) -> dict:
    """Check one case against its plain version, then time kernel, plain
    version and library call (``library`` None: no one PyTorch call
    computes the function); one row of the kernels line.  ``ms`` is
    ``cuda_ms``, ``device_ms`` the device operations of the same calls
    under the profiler (``device_ms()``), for the kernel's wrapper and the
    library call.  A case with ``repeats`` measures kernel and library that
    many times and keeps the medians, with min / median / max under
    ``spread``; a repeat whose profile gave no device time is left out of
    that time's median and spread, and ``<time>_n`` counts the repeats
    each time has.  A case's ``check`` (optional) compares further
    outputs, e.g. a second result; its ``read_once`` (optional) reads the
    operands once, a plain read whose device time (``read_once_device_ms``)
    is a yardstick beside the kernel's."""
    want = c["plain"]()
    got = c["kernel"]()
    if "check" in c:
        got, want = c["check"](got, want)
    err = check(c["name"], got, want, rel(want, c["tol"]) if c["tol"] else 0)
    del got, want
    iters = c.get("iters", TIMED_ITERS)
    lib = c["library"]
    runs = {"ms": [], "device_ms": [], "library_ms": [],
            "library_device_ms": []}
    seen: list = []
    for _ in range(c.get("repeats", 1)):
        runs["ms"].append(cuda_ms(c["kernel"], iters))
        runs["device_ms"].append(device_ms(c["kernel"], iters, seen))
        runs["library_ms"].append(cuda_ms(lib, iters) if lib else None)
        runs["library_device_ms"].append(device_ms(lib, iters) if lib
                                         else None)
    plain_ms = cuda_ms(c["plain"], iters)
    bound_ms, bound_by = bound(c["nbytes"], c["nops"],
                               c.get("ops_per_s", F32_OPS_PER_S))
    got = {k: [t for t in v if t is not None] for k, v in runs.items()}
    times = {k: float(np.median(v)) if v else None for k, v in got.items()}
    launches = own_launches(seen, iters)
    print(f"  {c['name']:15s} kernel {fmt(times['ms'])} ms (device "
          f"{fmt(times['device_ms'])})  plain {plain_ms:.4f} ms  library "
          f"{fmt(times['library_ms'])} ms (device "
          f"{fmt(times['library_device_ms'])})  bound {bound_ms:.4f} ms "
          f"({bound_by}, {c['nbytes'] / 1e6:.1f} MB)")
    print("    device operations of the kernel's calls: " + "; ".join(
        f"{name[:60]} x{n} {t:.4f} ms" for t, n, name in sorted(seen,
                                                                reverse=True)))
    print(f"    CUDA launches of the port's kernels per wrapper call: "
          f"{fmt(launches)}")
    row = {"name": c["name"], "route": "cuda", "source": c["source"],
           "replaces": c["replaces"], "max_abs_err": err, "ms": times["ms"],
           "device_ms": times["device_ms"], "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": times["library_ms"],
           "library_device_ms": times["library_device_ms"],
           "device_ms_n": len(got["device_ms"]),
           "library_device_ms_n": len(got["library_device_ms"]),
           "cuda_launches_per_call": launches}
    if "read_once" in c:
        row["read_once_device_ms"] = device_ms(c["read_once"], iters)
        print(f"    read the operands once (torch.sum): device "
              f"{fmt(row['read_once_device_ms'])} ms")
    if c.get("repeats", 1) > 1:
        row["spread"] = {k: [min(v), float(np.median(v)), max(v)]
                         for k, v in got.items() if v}
        print(f"    {len(runs['ms'])} repeats, min / median / max: "
              + "; ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v)
                          + f" (n {len(got[k])})"
                          for k, v in row["spread"].items()))
    return row


def phase_row(label: str, t) -> str:
    return (f"{label:14s} {t.cpu_dpu * 1e3:9.3f}m {t.dpu * 1e3:9.3f}m "
            f"{t.inter_dpu * 1e3:9.3f}m {t.dpu_cpu * 1e3:9.3f}m "
            f"{t.total * 1e3:9.3f}m")


PHASE_HEAD = (f"{'bench':14s} {'cpu_dpu':>10s} {'dpu':>10s} {'inter':>10s} "
              f"{'dpu_cpu':>10s} {'total':>10s}")


def suite_plan(banks: int, scale: int, names) -> dict[str, tuple[int, int]]:
    """Each workload's (banks, make_args scale) in the leg of ``banks`` at
    ``scale``: the leg's own, but for NW (NW_SCALE) and TRNS (at most
    TRNS_BANKS banks)."""
    plan = {name: (banks, scale) for name in names}
    plan["NW"] = (banks, NW_SCALE)
    plan["TRNS"] = (min(banks, TRNS_BANKS), scale)
    return plan


def suite_phase(args_2048: dict) -> tuple[dict[str, int], dict]:
    """The PrIM suite's banked path through the registry, as
    examples/prim_suite.py drives the reference, at each leg of SUITE.
    Returns the kernels' launch counts from this run alone and the
    2,048-bank rows' phase times; fills ``args_2048`` with the 2,048-bank
    leg's (arguments, ref() output) of every workload."""
    from repro_torch import make_bank_grid
    from repro_torch.kernels import ops
    from repro_torch.prim.registry import REGISTRY

    serialized = {}
    ops.reset_launch_counts()
    for banks, scale in SUITE:
        plan = suite_plan(banks, scale, REGISTRY)
        grids = {}
        rng = np.random.default_rng(0)
        print(f"{PHASE_HEAD}   ({banks} banks, scale {scale})")
        for entry in REGISTRY.values():
            b, sc = plan[entry.name]
            grid = grids.setdefault(b, make_bank_grid(b))
            args = entry.make_args(rng, scale=sc)
            t0 = time.perf_counter()
            gold = entry.ref(*args)
            t_ref = time.perf_counter() - t0
            if banks == BANKS:
                args_2048[entry.name] = (args, gold)
            variants = dict(entry.run_variants())
            if entry.name in ("GEMV", "SpMV"):
                variants[f"{entry.name}-kernel"] = functools.partial(
                    entry.pim, use_kernel=True)
            where = "" if (b, sc) == (banks, scale) else (
                f" ({b} banks, scale {sc})")
            for label, fn in variants.items():
                # the first call pays one-off costs (cuBLAS handles, the
                # lazy loading of each new device kernel): the row is the
                # second call's, the first's total printed beside it
                cold = fn(grid, *args)[1].total
                out, t = fn(grid, *args)
                entry.compare(out, gold)
                print(phase_row(label, t) + f"   ok  cold {cold * 1e3:.3f}m"
                      f"  ref {t_ref:.2f}s{where}")
                if banks == BANKS:
                    serialized.setdefault(entry.name, (label, t))
        del grids
    return ops.launch_counts(), serialized


def served(rec) -> str:
    """A session request's wall time: its phase buckets are host time
    summed over the rank threads that served it, as in the reference."""
    return (f"   wall {rec.service_s * 1e3:9.3f}m  ({rec.n_ranks} ranks x "
            f"{rec.n_chunks} chunks{', hit' if rec.cache_hit else ''})")


def refuses_trns(s, args) -> None:
    """TRNS on more banks than its N' rows: the reference's assertion,
    raised through the session's future.  Any other outcome fails."""
    req = s.submit("TRNS", *args)
    try:
        req.result(timeout=300)
    except AssertionError as e:
        assert "N' must divide across banks" in str(e), e
        print(f"TRNS on {s.n_banks} banks: AssertionError({e}) as the "
              f"reference's (N' = {TRNS_NP})")
        return
    raise AssertionError(f"TRNS ran on {s.n_banks} banks with N' = {TRNS_NP}")


def flat_session_phase(args_2048: dict) -> None:
    """The same workloads through a flat 2,048-bank session (one rank, one
    stream set): cold, then warm where the operand is resident.  TRNS's
    N' = 64 does not divide across 2,048 banks: it must raise the
    reference's assertion."""
    from repro_torch import pim

    print(f"flat session: {BANKS} banks, 1 rank")
    print(PHASE_HEAD)
    with pim.session(banks=BANKS) as s:
        for name, entry in pim.registry().items():
            args, gold = args_2048[name]
            if name == "TRNS":
                refuses_trns(s, args)
                continue
            for leg in ("cold", "warm") if entry.resident else ("cold",):
                entry.compare(s.submit(name, *args).result(timeout=300), gold)
                rec = s.telemetry.records[-1]
                assert rec.cache_hit == (leg == "warm"), (name, leg)
                print(phase_row(f"{name} {leg}", rec.phases) + served(rec))


def warm_runs(s, entry, args, gold) -> None:
    """``pin``, then two warm ``run``s of a resident workload.  A
    chunk-resident operand (GEMV, SpMV, MLP) scatters nothing; BS's sorted
    array lives in the resident meta: its queries still scatter, and each
    warm request emits one ``scatter:cached`` span for the broadcast it
    skips."""
    name, spans = entry.name, s.tracer.spans
    s.pin(name, *args)
    pushed = sum(sp.name == "scatter" for sp in spans)
    cached = sum(sp.name == "scatter:cached" for sp in spans)
    chunks = 0
    for _ in range(2):
        entry.compare(s.run(name, *args), gold)
        rec = s.telemetry.records[-1]
        assert rec.cache_hit, (name, "warm run missed the cache")
        chunks += rec.n_ranks * rec.n_chunks
        print(phase_row(f"{name} warm", rec.phases) + served(rec))
    pushed = sum(sp.name == "scatter" for sp in spans) - pushed
    cached = sum(sp.name == "scatter:cached" for sp in spans) - cached
    if entry.chunked.meta_resident:
        assert pushed == chunks, (name, "query chunks", pushed, chunks)
        assert cached == 2, (name, "a warm request broadcast again", cached)
    else:
        assert pushed == 0, f"a warm {name} request scattered a chunk"
        assert cached == chunks, (name, cached, chunks)
    print(f"{name} warm: {pushed} chunk scatters, {cached} cached spans")


def session_phase(args_2048: dict, serialized: dict) -> dict[str, int]:
    """The session façade over 32 ranks of 64 banks: ``run`` of each
    workload against its registry comparator (NW and BFS fall back to
    their serialized ``pim()``; TRNS runs on the 64-bank rank views),
    ``map``, ``pin`` with warm hits, a two-tenant serving block, and a
    trace export.  Returns the kernels' launch counts from this phase (the
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
            args, gold = args_2048[name]
            out = s.run(name, *args)
            entry.compare(out, gold)
            rec = s.telemetry.records[-1]
            label, ser = serialized[name]
            kind = "pipelined" if entry.pipelineable else "fallback"
            print(phase_row(f"{name} {kind}", rec.phases) + served(rec))
            print(phase_row(f"{label} serial", ser))
        rng = np.random.default_rng(1)
        reds = [reg["RED"].make_args(rng, scale=256) for _ in range(4)]
        for out, args in zip(s.map("RED", reds), reds):
            reg["RED"].compare(out, reg["RED"].ref(*args))
        print("map: 4 RED requests ok")
        for name in ("GEMV", "SpMV", "MLP", "BS"):
            warm_runs(s, reg[name], *args_2048[name])
        cache = s.stats()["cache"]
        print(f"cache: {cache}")
        assert cache["hits"] >= 8, cache
        path = s.trace_export(TRACE)
    finally:
        s.close()
    with open(path) as f:
        names = {ev["name"] for ev in json.load(f)["traceEvents"]}
    missing = {"scatter", "compute", "retrieve", "merge", "serialized"} - names
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


def tune_args(args_2048: dict) -> dict:
    """The suite's 2,048-bank (arguments, ref() output) of the pipelineable
    workloads: those the suite phase filled in ``args_2048``, or made the
    same way (one seeded generator over the registry in its order, at
    each workload's scale in ``suite_plan``)."""
    from repro_torch.prim.registry import REGISTRY

    if not args_2048:
        rng = np.random.default_rng(0)
        for name, (_, sc) in suite_plan(*SUITE[0], REGISTRY).items():
            entry = REGISTRY[name]
            args = entry.make_args(rng, scale=sc)
            if entry.pipelineable:
                args_2048[name] = (args, entry.ref(*args))
    return {n: v for n, v in args_2048.items()
            if REGISTRY[n].pipelineable}


def characterize_phase():
    """The paper's §3 characterization on the flat 2,048 banks of the card,
    one line a sweep; returns the flat grid and the fitted CostModel."""
    from repro_torch import make_bank_grid, make_rank_grid
    from repro_torch.core import characterize as ch
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.perfmodel import GpuModel
    from repro_torch.runtime.autotune import calibrate

    grid = make_bank_grid(BANKS)

    def show(label, rows, keys):
        rows = rows if isinstance(rows, list) else [rows]
        print(f"  {label}: " + "; ".join(
            " ".join(f"{k}={r[k]:.6g}" if isinstance(r[k], float)
                     else f"{k}={r[k]}" for k in keys) for r in rows))

    show("push_pull_sweep", ch.push_pull_sweep(grid),
         ("nbytes", "push_s", "pull_s"))
    show("bank_compute_sweep", ch.bank_compute_sweep(grid),
         ("nbytes", "compute_s"))
    show("op_throughput_sweep", ch.op_throughput_sweep(grid),
         ("op", "dtype", "elements", "seconds", "mops"))
    stream = [ch.stream_wram(w, n=STREAM_N, device=grid.device)
              for w in ("copy", "add", "scale", "triad")]
    show(f"stream_wram (n = {STREAM_N})", stream, ("stream", "mbps",
                                                   "seconds"))
    show(f"transfer_sweep ({TRANSFER_MB_PER_BANK} MB a bank)",
         ch.transfer_sweep(grid, mb_per_bank=TRANSFER_MB_PER_BANK),
         ("kind", "nbytes", "gbps"))
    show(f"rank_parallel_sweep ({RANKS} x {BANKS_PER_RANK}, "
         f"{RANK_SWEEP_BYTES} bytes)",
         ch.rank_parallel_sweep(make_rank_grid(RANKS, BANKS_PER_RANK),
                                nbytes=RANK_SWEEP_BYTES),
         ("ranks", "push_gbps", "pull_gbps"))
    stages = calibrate(grid)
    print("  StageFits: " + "; ".join(
        f"{k} alpha {v.alpha_s * 1e6:.3f} us, {v.bytes_per_s / 1e9:.3f} GB/s"
        for k, v in stages.items()))
    cm = CostModel.calibrate(grid)
    print(f"  CostModel: push {cm.push.bytes_per_s / 1e9:.3f} GB/s + "
          f"{cm.push.setup_s * 1e6:.3f} us, pull "
          f"{cm.pull.bytes_per_s / 1e9:.3f} GB/s + "
          f"{cm.pull.setup_s * 1e6:.3f} us, dispatch "
          f"{cm.dispatch_s * 1e6:.3f} us; per op (ps): " + ", ".join(
              f"{op}:{dt} {c.per_op_s * 1e12:.4f}"
              for (op, dt), c in sorted(cm.ops.items())))
    measured = GpuModel.from_stream_rows(stream)
    print(f"  GpuModel: HBM {measured.hbm_bw / 1e12:.4f} TB/s measured "
          f"(stream_wram) against the data sheet's "
          f"{GpuModel().hbm_bw / 1e12:.2f} TB/s")
    return grid, cm


def plan_line(name: str, plan, prof) -> str:
    """A tuned plan: its adopted counts, the probed times, the model's
    predictions, and the stage fits of its workload profile."""
    m = " ".join(f"{c}:{t * 1e3:.3f}" for c, t in sorted(plan.measured_s.items()))
    r = " ".join(f"{c}:{t * 1e3:.3f}"
                 for c, t in sorted(plan.rank_measured_s.items()))
    fits = " ".join(f"{k} {f.alpha_s * 1e6:.1f} us + {f.bytes_per_s / 1e9:.4g}"
                    f" GB/s" for k, f in (("push", prof.push),
                                          ("compute", prof.compute),
                                          ("pull", prof.pull)))
    return (f"  {name:7s} n_chunks {plan.n_chunks} (warm "
            f"{plan.warm_n_chunks}) batch {plan.max_batch_requests} "
            f"ranks {plan.n_ranks}; measured ms {{{m}}}"
            + (f" ranks ms {{{r}}}" if r else "")
            + f"; predicted serialized {plan.predicted_serialized_s * 1e3:.3f}"
            f" pipelined {plan.predicted_pipelined_s * 1e3:.3f} warm "
            f"{plan.warm_predicted_pipelined_s * 1e3:.3f} ms; fits {fits}")


def check_tuned(s, result, args: dict) -> list[float]:
    """Print each tuned plan, hold it to the tuned >= default invariant
    (a probed plan's time at its adopted chunk count is no more than at
    DEFAULT_N_CHUNKS, which is always probed), then serve each workload
    once on ``s`` and hold the result to ``ref()`` with the registry's
    comparator, printing the plan's predicted overlap beside the achieved
    one (the measured serialized baseline over the request's wall time).
    Returns the cost model's accuracy ratios (predicted over measured
    stage seconds, or the inverse, whichever is >= 1) of the plans that
    carry its stage predictions."""
    from repro_torch import pim
    from repro_torch.runtime.autotune import DEFAULT_N_CHUNKS

    ratios = []
    for name, plan in result.plans.items():
        print(plan_line(name, plan, result.profiles[name]))
        m = plan.measured_s
        if m:
            assert DEFAULT_N_CHUNKS in m, (name, "default not probed", m)
            assert m[plan.n_chunks] <= m[DEFAULT_N_CHUNKS], (
                f"{name}: adopted {plan.n_chunks} chunks measured "
                f"{m[plan.n_chunks]} s, over the default's "
                f"{m[DEFAULT_N_CHUNKS]} s")
    for name, plan in result.plans.items():
        entry = pim.registry()[name]
        a, gold = args[name]
        entry.compare(s.run(name, *a), gold)
        rec = s.telemetry.records[-1]
        assert rec.tuned, name
        rec.serialized_s = plan.predicted_serialized_s
        line = (f"  {name:7s} served ok: predicted overlap "
                f"{plan.predicted_overlap:.3f}, achieved "
                f"{rec.overlap_speedup:.3f} (wall "
                f"{rec.service_s * 1e3:.3f} ms, {rec.n_ranks} ranks x "
                f"{rec.n_chunks} chunks)")
        if plan.predicted_stage_s:
            meas = rec.phases.cpu_dpu + rec.phases.dpu + rec.phases.dpu_cpu
            pred = sum(plan.predicted_stage_s.values())
            ratios.append(max(pred / max(meas, 1e-9), meas / max(pred, 1e-9)))
            line += (f"; stages predicted {pred * 1e3:.3f} ms, measured "
                     f"{meas * 1e3:.3f} ms")
        print(line)
    return ratios


def tune_phase(args_2048: dict) -> dict[str, int]:
    """Characterization, then ``pim.session(...).autotune`` on the card:
    the 13 pipelineable workloads on a flat 2,048-bank session and TRNS
    on 64 banks at scale 1024, probed; the constructor's ``autotune=`` on
    64 banks; GEMV / RED / SpMV with the calibrated CostModel (a session
    without the resident cache, so the cold path the model prices runs);
    and GEMV / RED / SpMV over 32 ranks of 64 banks, the rank count probed
    over the 6 divisors of 32.  Every tuned plan is held to tuned >=
    default and every served result to ``ref()``.  Returns the kernels'
    launch counts from this phase."""
    from repro_torch import pim
    from repro_torch.core.costmodel import geomean_ratio
    from repro_torch.kernels import ops
    from repro_torch.runtime.autotune import rank_candidates

    args = tune_args(args_2048)
    pipe = list(args)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    print(f"characterization: {BANKS} banks")
    _, cm = characterize_phase()
    print(f"characterization: {time.perf_counter() - t0:.2f} s")
    flat = [n for n in pipe if n != "TRNS"]
    for banks, names in ((BANKS, flat), (TRNS_BANKS, ["TRNS"])):
        with pim.session(banks=banks) as s:
            t0 = time.perf_counter()
            result = s.autotune(names, scale=TUNE_SCALE, reps=TUNE_REPS,
                                probe=True)
            print(f"tuned {len(names)} on {banks} banks at scale "
                  f"{TUNE_SCALE}: {time.perf_counter() - t0:.2f} s")
            check_tuned(s, result, args)
    with pim.session(banks=TRNS_BANKS, autotune={"scale": 64, "reps": 1,
                                                 "probe": False}) as s:
        assert set(s.plans) == set(pipe), sorted(s.plans)
        print(f"session(banks={TRNS_BANKS}, autotune=...): plans for "
              f"{len(s.plans)} workloads")
    with pim.session(banks=BANKS, resident=False) as s:
        result = s.autotune(COST_TUNE, scale=TUNE_SCALE, reps=TUNE_REPS,
                            probe=True, cost_model=cm)
        for name, plan in result.plans.items():
            model = " ".join(f"{c}:{t * 1e3:.3f}" for c, t
                             in sorted(plan.model_candidate_s.items()))
            print(f"  {name:7s} model_candidate_s ms {{{model}}}; probed "
                  f"{sorted(plan.measured_s)}")
        ratios = check_tuned(s, result, args)
        print(f"cost model: geomean of predicted over measured stage "
              f"seconds {geomean_ratio(ratios):.3f} over {len(ratios)}")
    with pim.session(ranks=RANKS, banks_per_rank=BANKS_PER_RANK) as s:
        t0 = time.perf_counter()
        result = s.autotune(RANK_TUNE, scale=TUNE_SCALE, reps=TUNE_REPS,
                            probe=True)
        print(f"tuned {len(RANK_TUNE)} on {RANKS} x {BANKS_PER_RANK}: "
              f"{time.perf_counter() - t0:.2f} s")
        for name, plan in result.plans.items():
            assert sorted(plan.rank_measured_s) == rank_candidates(RANKS), (
                name, plan.rank_measured_s)
        check_tuned(s, result, args)
    return ops.launch_counts()


def host_ms(fn, iters: int = 3) -> float:
    """Mean host-clock time of ``fn`` (work that ends in a synchronize),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def device_breakdown(fn, ms: float, top: int = 8) -> None:
    """One call of ``fn`` (a forward) under ``torch.profiler``: the device
    operations (kernels, copies, memsets) with the most device time, and
    the device's busy share, their sum over ``ms`` (the same forward's
    unprofiled host-clock time).  Says so when the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "clears events at the end of each cycle"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = device_ops(prof)
    if not rows:
        print("  profiler: no device time recorded")
        return
    busy = sum(r[0] for r in rows)
    print(f"  profiler: device busy {busy:.3f} ms of a {ms:.2f} ms forward "
          f"({busy / ms:.1%}) in {sum(r[1] for r in rows)} device operations;"
          f" top {top} by device time:")
    for t, n, name in sorted(rows, reverse=True)[:top]:
        print(f"    {t:9.3f} ms {t / busy:6.1%} x{n:<5d} {name[:100]}")
    for kernel, mark in SHARES.items():
        own = [(t, n) for t, n, name in rows if mark in name]
        if own:
            t = sum(r[0] for r in own)
            print(f"    {kernel}: {t:.3f} ms ({t / busy:.1%} of the device "
                  f"time) in {sum(r[1] for r in own)} launches")


def prefill_phase(model, dev) -> int:
    """TinyLlama FULL, seeded weights, one prefill of PREFILL tokens:
    ``forward(use_kernel=True)`` of the float32 ``model`` against
    ``use_kernel=False``
    (rtol = atol = 1e-3: attention's float32 sums in another order, through
    22 layers), then at the config's own bfloat16, timed beside the plain
    forward, with its error and the share of positions whose argmax
    agrees.  Returns flash_attention's launches in one forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    full = get_config(LM_ARCH)
    toks = torch.randint(0, full.vocab, (1, PREFILL), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    cfg = dataclasses.replace(full, dtype=torch.float32)
    print(f"prefill: {full.name} ({full.total_params() / 1e9:.3f} B params,"
          f" {full.n_layers} layers, d_model {full.d_model}, heads "
          f"{full.n_heads} / {full.n_kv_heads}, head dim {full.hd}), "
          f"tokens (1, {PREFILL})")
    with torch.no_grad():
        ops.reset_launch_counts()
        got, _ = transformer.forward(model, cfg, toks, use_kernel=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        launches = counts["flash_attention"]
        assert launches == full.n_layers, (
            f"{launches} flash_attention launches in one forward, "
            f"want {full.n_layers}")
        assert sum(counts.values()) == launches, counts
        want, _ = transformer.forward(model, cfg, toks, use_kernel=False)
        check("forward f32 kernel vs plain", got, want, rel(want, 1e-3))
        del got, want
        torch.cuda.empty_cache()

        bf16 = transformer.init(full, seed=0, device=dev)
        got, _ = transformer.forward(bf16, full, toks, use_kernel=True)
        want, _ = transformer.forward(bf16, full, toks, use_kernel=False)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        err = float((got.float() - want.float()).abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        ms = host_ms(lambda: transformer.forward(bf16, full, toks,
                                                 use_kernel=True))
        plain_ms = host_ms(lambda: transformer.forward(bf16, full, toks,
                                                       use_kernel=False))
    print(f"  forward bf16: kernel {ms:.2f} ms ({PREFILL / ms * 1e3:.0f} "
          f"tokens/s), plain {plain_ms:.2f} ms; max |kernel - plain| "
          f"{err:.3e}, argmax agrees at {agree:.4f} of positions; "
          f"{launches} flash launches per forward")
    del bf16, got, want
    torch.cuda.empty_cache()
    return launches


def consistency_phase(model, dev) -> None:
    """The reference's prefill / decode check (tests/test_models.py) at
    full width on the float32 ``model``: teacher-forced ``decode_step`` over CONSIST
    tokens reproduces ``forward(use_kernel=True)``'s logits at the
    reference's rtol = atol = 2e-2."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab, (1, CONSIST), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    with torch.no_grad():
        full, _ = transformer.forward(model, cfg, toks, use_kernel=True)
        cache = transformer.init_cache(model, cfg, 1, CONSIST)
        outs = []
        for i in range(CONSIST):
            lt, cache = transformer.decode_step(model, cfg, toks[:, i:i + 1],
                                                cache)
            outs.append(lt)
    check(f"decode vs prefill ({CONSIST} tok)", torch.cat(outs, 1), full,
          rel(full, 2e-2))


def decode_phase(model, dev) -> None:
    """Greedy decode of the float32 TinyLlama FULL ``model``, DECODE_STREAMS
    streams:
    ``greedy_generate`` on the card and ``DecodeEngine`` on a flat session
    of DECODE_BANKS banks (its host half on the CPU) must give the same
    tokens.  Prints the smallest top-1 / top-2 logit gap at the generated
    positions, so that a mismatch can be told from a near tie (a mismatch
    fails either way), both token rates, the engine's pin time, and the
    weight bytes its warm steps scattered (0)."""
    from repro_torch import pim
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype=torch.float32)
    prompt = torch.randint(0, cfg.vocab, (DECODE_STREAMS, DECODE_PROMPT),
                           device=dev, dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(5))
    steps = DECODE_PROMPT + DECODE_NEW - 1
    t0 = time.perf_counter()
    want = serve.greedy_generate(model, cfg, prompt, DECODE_NEW)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    with torch.no_grad():           # the logit gaps along greedy's tokens
        cache = transformer.init_cache(model, cfg, DECODE_STREAMS, steps + 1)
        gap = float("inf")
        for i in range(steps):
            logits, cache = transformer.decode_step(model, cfg,
                                                    want[:, i:i + 1], cache)
            if i + 1 >= DECODE_PROMPT:
                top = logits[:, -1].topk(2, dim=-1).values
                gap = min(gap, float((top[:, 0] - top[:, 1]).min()))
    print(f"decode: greedy_generate {DECODE_STREAMS} x ({DECODE_PROMPT} + "
          f"{DECODE_NEW}) tokens in {greedy_s:.2f} s "
          f"({DECODE_STREAMS * DECODE_NEW / greedy_s:.1f} new tokens/s incl. "
          f"prefill steps); smallest top-1 / top-2 logit gap {gap:.4e}")
    with pim.session(banks=DECODE_BANKS, trace=True) as s:
        eng = pim.DecodeEngine(model, cfg, session=s)
        pushed = sum(sp.name == "scatter" for sp in s.tracer.spans)
        got = eng.generate(want[:, :DECODE_PROMPT].cpu().numpy(), DECODE_NEW)
        warm_scatter = sum(sp.args["bytes"] for sp in s.tracer.spans
                           if sp.name == "scatter")
        cached = sum(sp.args["bytes"] for sp in s.tracer.spans
                     if sp.name == "scatter:cached")
        rep = eng.report()
    assert (got == want.cpu().numpy()).all(), (
        f"DecodeEngine tokens {got.tolist()} != greedy_generate "
        f"{want.cpu().tolist()} (smallest logit gap {gap:.4e})")
    assert pushed == 0 and warm_scatter == 0 and cached > 0, (
        pushed, warm_scatter, cached)
    print(f"  DecodeEngine ({DECODE_BANKS} banks, 1 rank): tokens identical "
          f"to greedy_generate; pin {rep['setup_s']:.2f} s; prefill "
          f"{rep['prefill_s']:.2f} s; {rep['tokens_per_s']:.2f} tokens/s over"
          f" {rep['new_tokens']} new tokens; warm steps scattered "
          f"{warm_scatter} weight bytes ({cached / 1e9:.2f} GB served from "
          f"the banks); host {rep['host_s']:.2f} s, pim "
          + ", ".join(f"{k} {v:.2f} s" for k, v in rep["pim_s"].items()))


@contextlib.contextmanager
def routing_log():
    """Record, for every ``moe.apply`` call, each token's top-k experts
    (sorted) and the pairs past the expert capacity
    (``moe.apply.routing``)."""
    from repro_torch.models import moe

    moe.apply.routing = []
    try:
        yield moe.apply.routing
    finally:
        moe.apply.routing = None


def routed_apart(a: list, b: list) -> int:
    """(token, layer) pairs whose top-k sets differ between two logs."""
    return sum(int((ta != tb).any(-1).sum()) for (ta, _), (tb, _) in zip(a, b))


def expected_launches(model) -> dict[str, int]:
    """Kernel launches of one forward(use_kernel=True): flash_attention per
    attention layer, moe_gmm twice per MoE layer, ssd_scan per Mamba
    layer."""
    descs = [blk.desc for blk in model.layers]
    return {"flash_attention": sum(d["mixer"] == "attn" for d in descs),
            "moe_gmm": 2 * sum(d["ffn"] == "moe" for d in descs),
            "ssd_scan": sum(d["mixer"] == "mamba" for d in descs)}


def counted_forward(model, cfg, toks) -> dict[str, int]:
    """One ``forward(use_kernel=True)`` with every count set to 0 just
    before it: the launches of the path, checked against the layer
    plan."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    want = expected_launches(model)
    ops.reset_launch_counts()
    transformer.forward(model, cfg, toks, use_kernel=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert {k: counts[k] for k in want} == want, (counts, want)
    assert sum(counts.values()) == sum(want.values()), counts
    return want


def family_phase(arch: str, f32_layers: int, bf16_layers: int, tol: float,
                 dev) -> dict[str, int]:
    """One model family at its published width, seeded weights, prefill of
    PREFILL tokens:

    - float32 at ``f32_layers``: ``forward(use_kernel=True)`` against the
      plain forward within ``tol`` (rtol = atol), with the (token, layer)
      top-k sets the two route differently; teacher-forced ``decode_step``
      over CONSIST tokens against the kernel prefill at the reference's
      rtol = atol = 2e-2, at capacity factor E / K, where no pair drops
      (decode routes B tokens at a time, capacity 8, and never drops);
    - bfloat16 at ``bf16_layers``: the prefill's launches from one
      counted forward (returned), its time with the kernels and plain
      (mean of 3 after a warm-up), the device operations of one forward
      with the kernels under ``torch.profiler`` and the device's busy
      share of it, the max logit difference and argmax
      agreement of the two, the pairs past capacity and the top-k sets
      routed differently; then ``greedy_generate``, DECODE_STREAMS x
      (DECODE_PROMPT + DECODE_NEW) tokens.
    """
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import moe, transformer

    full = get_config(arch)
    gen = torch.Generator(device=dev)
    toks = torch.randint(0, full.vocab, (1, PREFILL), device=dev,
                         generator=gen.manual_seed(1))
    cfg = dataclasses.replace(full, n_layers=f32_layers, dtype=torch.float32)
    print(f"{arch}: {full.total_params() / 1e9:.2f} B params at {full.n_layers}"
          f" layers; d_model {full.d_model}, heads {full.n_heads} / "
          f"{full.n_kv_heads}, {full.moe_experts} experts top-"
          f"{full.moe_top_k}, d_ff {full.d_ff}; float32 at {f32_layers} "
          f"layers ({cfg.total_params() / 1e9:.2f} B), bfloat16 at "
          f"{bf16_layers} ({dataclasses.replace(full, n_layers=bf16_layers).total_params() / 1e9:.2f} B)")
    with torch.no_grad():
        model = transformer.init(cfg, seed=0, device=dev)
        print(f"  float32 plan: {[tuple(b.desc.values())[:2] for b in model.layers]}")
        print(f"  float32 launches per forward: {counted_forward(model, cfg, toks)}")
        with routing_log() as klog:
            got, aux = transformer.forward(model, cfg, toks, use_kernel=True)
        with routing_log() as plog:
            want, paux = transformer.forward(model, cfg, toks)
        print(f"  float32 top-k sets routed apart: {routed_apart(klog, plog)} "
              f"of {sum(len(t) for t, _ in klog)} (token, layer); pairs past "
              f"capacity {sum(d for _, d in klog)}; aux {float(aux):.6f} / "
              f"{float(paux):.6f}")
        check(f"{arch} f32 kernel vs plain", got, want, rel(want, tol))
        del got, want
        free = dataclasses.replace(cfg, moe_capacity_factor=cfg.moe_experts
                                   / cfg.moe_top_k)
        assert moe._capacity(free, CONSIST) >= CONSIST
        ctoks = toks[:, :CONSIST]
        prefill, _ = transformer.forward(model, free, ctoks, use_kernel=True)
        cache = transformer.init_cache(model, free, 1, CONSIST)
        outs = []
        for i in range(CONSIST):
            lt, cache = transformer.decode_step(model, free,
                                                ctoks[:, i:i + 1], cache)
            outs.append(lt)
        check(f"{arch} decode vs prefill", torch.cat(outs, 1), prefill,
              rel(prefill, 2e-2))
        del model, prefill, outs, cache
        torch.cuda.empty_cache()

        cfg = dataclasses.replace(full, n_layers=bf16_layers)
        model = transformer.init(cfg, seed=0, device=dev)
        counts = counted_forward(model, cfg, toks)
        with routing_log() as klog:
            got, _ = transformer.forward(model, cfg, toks, use_kernel=True)
        with routing_log() as plog:
            want, _ = transformer.forward(model, cfg, toks)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        err = float((got.float() - want.float()).abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        apart = routed_apart(klog, plog)
        dropped = [d for _, d in klog]
        del got, want
        ms = host_ms(lambda: transformer.forward(model, cfg, toks,
                                                 use_kernel=True))
        plain_ms = host_ms(lambda: transformer.forward(model, cfg, toks))
        device_breakdown(lambda: transformer.forward(model, cfg, toks,
                                                     use_kernel=True), ms)
        print(f"  forward bf16, {bf16_layers} layers: kernel {ms:.2f} ms "
              f"({PREFILL / ms * 1e3:.0f} tokens/s), plain {plain_ms:.2f} ms;"
              f" max |kernel - plain| {err:.3e}, argmax agrees at "
              f"{agree:.4f} of positions; top-k sets routed apart {apart} of"
              f" {sum(len(t) for t, _ in klog)} (token, layer); pairs past "
              f"capacity {sum(dropped)} of {PREFILL * cfg.moe_top_k * len(dropped)}"
              f" (per MoE layer {dropped}); launches per forward {counts}")
        prompt = torch.randint(0, cfg.vocab, (DECODE_STREAMS, DECODE_PROMPT),
                               device=dev, dtype=torch.int32,
                               generator=gen.manual_seed(5))
        t0 = time.perf_counter()
        tokens = serve.greedy_generate(model, cfg, prompt, DECODE_NEW)
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0
    assert tokens.shape == (DECODE_STREAMS, DECODE_PROMPT + DECODE_NEW)
    print(f"  greedy_generate bf16 {DECODE_STREAMS} x ({DECODE_PROMPT} + "
          f"{DECODE_NEW}) tokens in {greedy_s:.2f} s: {tokens.tolist()}")
    del model, tokens
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import cuda_lib

    argv = sys.argv[1:]
    only = (set(argv[argv.index("--only") + 1].split(","))
            if "--only" in argv else None)
    assert only is None or only <= set(PHASES), f"--only takes {PHASES}"
    run = lambda phase: only is None or phase in only  # noqa: E731
    kind, smi = torch.cuda.get_device_name(0), smi_line()
    print(f"device: {kind}  ({smi}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    paths, log = cuda_lib.build()
    cuda_lib.library()
    print(f"build: {time.perf_counter() - t0:.2f} s, one nvcc per source -> "
          + ", ".join(os.path.relpath(p, ROOT) for p in paths))
    for line in ptxas_summary(log):
        print(f"  ptxas: {line}")
    if "--build" in argv:
        return 0

    dev = torch.device("cuda", 0)
    rows: list[dict] = []
    if run("kernels"):
        print("kernels (2,048 banks; against the plain PyTorch version):")
        rows = kernel_phase(dev)
    row = {r["name"]: r for r in rows}
    if run("suite"):
        args_2048: dict = {}
        t0 = time.perf_counter()
        counts, serialized = suite_phase(args_2048)
        print(f"suite: {time.perf_counter() - t0:.2f} s; launches {counts}")
        # every kernel has a row; each row's launches come from the path
        # that runs it: the suite's five kernels from the suite,
        # flash_attention from one TinyLlama prefill forward, moe_gmm from
        # one DeepSeek-MoE forward, ssd_scan from one forward of the Jamba
        # cut (phases below)
        assert not rows or sorted(counts) == sorted(row), counts
        for name, r in row.items():
            r["launches"] = counts[name]
        for kernel in ("flash_attention", "moe_gmm", "ssd_scan"):
            assert counts[kernel] == 0, counts
        if run("session"):
            t0 = time.perf_counter()
            session_counts = session_phase(args_2048, serialized)
            print(f"session: {time.perf_counter() - t0:.2f} s; launches "
                  f"{session_counts} (the chunked phases run the plain "
                  f"oracles)")
            t0 = time.perf_counter()
            flat_session_phase(args_2048)
            print(f"flat session: {time.perf_counter() - t0:.2f} s")
        del serialized
    else:
        args_2048 = {}
    if run("tune"):
        t0 = time.perf_counter()
        tune_counts = tune_phase(args_2048)
        print(f"tune: {time.perf_counter() - t0:.2f} s; launches "
              f"{tune_counts}")
        for name, r in row.items():
            r["tune_launches"] = tune_counts[name]
    del args_2048

    from repro_torch.configs import get_config
    if run("lm"):
        t0 = time.perf_counter()
        # one seeded float32 TinyLlama for the three LM legs; only the bf16
        # timing leg of prefill_phase builds its own
        from repro_torch.models import transformer
        model = transformer.init(
            dataclasses.replace(get_config(LM_ARCH), dtype=torch.float32),
            seed=0, device=dev)
        launches = prefill_phase(model, dev)
        if "flash_attention" in row:
            row["flash_attention"]["launches"] = launches
        consistency_phase(model, dev)
        print(f"prefill + consistency: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        decode_phase(model, dev)
        print(f"decode: {time.perf_counter() - t0:.2f} s")
        del model
        torch.cuda.empty_cache()
    if run("moe"):
        t0 = time.perf_counter()
        counts = family_phase(MOE_ARCH, MOE_F32_LAYERS,
                              get_config(MOE_ARCH).n_layers, 1e-3, dev)
        if "moe_gmm" in row:
            row["moe_gmm"]["launches"] = counts["moe_gmm"]
        print(f"moe: {time.perf_counter() - t0:.2f} s")
    if run("hybrid"):
        t0 = time.perf_counter()
        counts = family_phase(HYBRID_ARCH, HYBRID_LAYERS, HYBRID_LAYERS, 5e-3,
                              dev)
        if "ssd_scan" in row:
            row["ssd_scan"]["launches"] = counts["ssd_scan"]
        print(f"hybrid: {time.perf_counter() - t0:.2f} s")
    for r in rows:
        print(f"  {r['name']:15s} {r.get('launches', '-')} wrapper launches "
              f"on its path; {fmt(r['cuda_launches_per_call'])} CUDA "
              f"launches per wrapper call")
    if only is None:
        missing = [r["name"] for r in rows if r["launches"] <= 0]
        assert not missing, f"the main path launched no {missing}"

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
