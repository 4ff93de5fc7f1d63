"""Analytical performance models — the PyTorch counterpart of
``repro.core.perfmodel``.

1. ``DpuModel`` / ``DpuSystemModel`` — the UPMEM DPU and system model of
   the paper (§2-3): Eqs. 1-4 with the paper's measured constants, and a
   full system of ``n_dpus`` DPUs behind the host bus.  Pure Python,
   copied from the reference, as are :func:`fit_affine` (the least-squares
   fit of the autotuner's stage models), :func:`mram_capacity_bytes` (the
   residency budget) and the analytic ``min_hbm_bytes_*`` /
   ``model_flops_*`` counts.

2. ``GpuModel`` — the roofline target of the port, in place of the
   reference's TPU model: one NVIDIA H100 SXM from its data sheet (HBM3
   at 3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s
   dense bfloat16, NVLink at 900 GB/s), or with the HBM rate that
   ``characterize.stream_wram`` measured on the card
   (:meth:`GpuModel.from_stream_rows`).  ``RooflineTerms`` keeps the
   reference's three terms over it:
     compute term    = FLOPs / (chips * peak_flops)
     memory term     = bytes / (chips * hbm_bw)
     collective term = collective_bytes / (chips * link_bw)

The residency budget stays the reference's MRAM model, not the card's
memory: 64 MB per bank with half reserved, so 2,048 banks budget 64 GiB,
which fits the H100's 80 GB.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping


def fit_affine(xs, ys) -> tuple[float, float]:
    """Least-squares fit of y = alpha + beta * x (the shape of the paper's
    Eq. 3, reused by the autotuner's stage fits — DESIGN.md §8)."""
    n = len(xs)
    sx = sum(xs); sy = sum(ys)
    sxx = sum(x * x for x in xs)
    sxy = sum(x * y for x, y in zip(xs, ys))
    denom = n * sxx - sx * sx
    if denom == 0:
        return (sy / n if n else 0.0), 0.0
    beta = (n * sxy - sx * sy) / denom
    alpha = (sy - beta * sx) / n
    return alpha, beta


# ---------------------------------------------------------------------------
# UPMEM DPU model (paper §3)
# ---------------------------------------------------------------------------

#: Instructions in the streaming read-modify-write loop per op/dtype
#: (paper §3.1.2; Listing 1 has 6 instructions for int32 add).
#: Values are the per-operation instruction counts *inside the 6-instruction
#: streaming loop skeleton* (addr calc, load, OP..., store, index, branch):
#: n = 5 + op_instructions.
STREAM_LOOP_OVERHEAD = 5
OP_INSTRUCTIONS: Mapping[tuple[str, str], int] = {
    # (op, dtype) -> instructions for the arithmetic op itself
    ("add", "int32"): 1, ("sub", "int32"): 1,
    ("add", "int64"): 2, ("sub", "int64"): 2,     # add + addc
    ("mul", "int32"): 32, ("div", "int32"): 32,   # mul_step/div_step worst case
    ("mul", "int64"): 123, ("div", "int64"): 191, # __muldi3 / __divdi3
    ("add", "float"): 66, ("sub", "float"): 71,   # library emulation (fitted to
    ("mul", "float"): 178, ("div", "float"): 1025,#  paper Fig.4 measurements)
    ("add", "double"): 100, ("sub", "double"): 107,
    ("mul", "double"): 655, ("div", "double"): 2183,
}


@dataclasses.dataclass(frozen=True)
class DpuModel:
    """Analytical model of one UPMEM DPU + its MRAM bank (paper §2-3)."""

    freq_hz: float = 350e6           # 2,556-DPU system; 267e6 for the 640-DPU one
    pipeline_depth: int = 14
    dispatch_gap: int = 11           # cycles between same-thread instructions
    n_hw_threads: int = 24
    wram_bytes: int = 64 * 1024
    mram_bytes: int = 64 * 1024 * 1024
    iram_instr: int = 4096
    alpha_read: float = 77.0         # DMA fixed cost, cycles (paper §3.2.1)
    alpha_write: float = 61.0
    beta: float = 0.5                # DMA cycles per byte
    dma_max: int = 2048              # max bytes per mram_read/write
    dma_min: int = 8

    # -- Eq. 1 -------------------------------------------------------------
    def loop_instructions(self, op: str, dtype: str) -> int:
        # 64-bit loads/stores are single ld/sd instructions (paper §3.1.2:
        # the int64 add loop is the 6-instruction int32 loop + one addc).
        return STREAM_LOOP_OVERHEAD + OP_INSTRUCTIONS[(op, dtype)]

    def arith_throughput(self, op: str, dtype: str, tasklets: int = 16) -> float:
        """Operations/second for the §3.1 streaming microbenchmark (Eq. 1),
        including the sub-11-tasklet pipeline underutilization regime."""
        n = self.loop_instructions(op, dtype)
        full = self.freq_hz / n
        fill = min(tasklets, self.dispatch_gap) / self.dispatch_gap
        return full * fill

    # -- Eq. 2 -------------------------------------------------------------
    def wram_bandwidth(self, bytes_per_iter: int, instrs_per_iter: int,
                       tasklets: int = 16) -> float:
        fill = min(tasklets, self.dispatch_gap) / self.dispatch_gap
        return bytes_per_iter * self.freq_hz / instrs_per_iter * fill

    def wram_stream(self, which: str, tasklets: int = 16) -> float:
        """STREAM (COPY/ADD/SCALE/TRIAD) WRAM bandwidth, 64-bit elements."""
        table = {          # (bytes moved, instructions) per element, unrolled
            "copy": (16, 2),              # ld + sd
            "add": (24, 5),               # 2 ld + add + addc + sd
            "scale": (16, 2 + 123),       # ld + mul(lib) + sd
            "triad": (24, 3 + 123 + 2),   # 2 ld + mul + add/addc + sd
        }
        b, n = table[which]
        return self.wram_bandwidth(b, n, tasklets)

    # -- Eq. 3/4 -----------------------------------------------------------
    def mram_latency_cycles(self, size: int, write: bool = False) -> float:
        a = self.alpha_write if write else self.alpha_read
        return a + self.beta * size

    def mram_bandwidth(self, size: int, write: bool = False) -> float:
        return size * self.freq_hz / self.mram_latency_cycles(size, write)

    @property
    def mram_peak_bandwidth(self) -> float:
        """beta^-1 bytes/cycle * f  (= 700 MB/s at 350 MHz)."""
        return self.freq_hz / self.beta

    # -- §3.3 roofline -----------------------------------------------------
    def attainable_throughput(self, op: str, dtype: str,
                              op_per_byte: float, tasklets: int = 16) -> float:
        """min(compute roof, memory roof) at a given operational intensity.

        The compute roof is Eq.1; the memory roof is MRAM streaming bandwidth
        times the operational intensity. Saturation point = where they cross
        (paper: 1/4 OP/B for int32 add)."""
        compute = self.arith_throughput(op, dtype, tasklets)
        # streaming MRAM bw effectively saturates at ~2 in-flight transfers
        mem_bw = self.mram_bandwidth(1024) * min(tasklets, 2) / 2
        return min(compute, op_per_byte * mem_bw)

    def saturation_intensity(self, op: str, dtype: str) -> float:
        """Operational intensity (op/B) where compute roof meets memory roof."""
        return (self.arith_throughput(op, dtype, 16)
                / self.mram_bandwidth(1024))

    # -- fit (recovers alpha/beta from measured latencies, §3.2.1) ----------
    @staticmethod
    def fit_dma(sizes, cycles) -> tuple[float, float]:
        """Least-squares fit of Eq. 3; returns (alpha, beta)."""
        return fit_affine(sizes, cycles)


def mram_capacity_bytes(n_banks: int, model: DpuModel = DpuModel(),
                        reserve_frac: float = 0.5) -> int:
    """Residency budget for a grid of ``n_banks`` banks (DESIGN.md §12).

    Each bank models one DPU's 64 MB MRAM; ``reserve_frac`` of every bank
    is held back for the operands that still stream per request (chunk
    double-buffers, outputs, broadcast constants), mirroring how UPMEM
    programs slice MRAM between the resident operand and the per-launch
    working set.  The remainder is what the resident-operand cache may
    budget across the whole grid.
    """
    if not 0.0 <= reserve_frac < 1.0:
        raise ValueError(f"reserve_frac must be in [0, 1), got {reserve_frac}")
    return int(n_banks * model.mram_bytes * (1.0 - reserve_frac))


@dataclasses.dataclass(frozen=True)
class DpuSystemModel:
    """A full UPMEM system = n_dpus independent DpuModels + host bus (paper §2.1/3.4)."""

    dpu: DpuModel = DpuModel()
    n_dpus: int = 2556
    dpus_per_rank: int = 64
    # host<->MRAM sustained bandwidths measured in the paper (Fig. 10, 64 DPUs)
    cpu_dpu_bw: float = 6.68e9       # parallel, bytes/s per rank
    dpu_cpu_bw: float = 4.74e9
    broadcast_bw: float = 16.88e9
    serial_bw: float = 0.33e9        # single-DPU copy bandwidth

    @property
    def aggregate_mram_bw(self) -> float:
        return self.n_dpus * self.dpu.mram_bandwidth(2048)

    @property
    def peak_gops(self) -> float:
        """Peak int32-add throughput of all DPUs (paper Table 4: 894.6 GOPS
        counts 1 op/cycle/DPU)."""
        return self.n_dpus * self.dpu.freq_hz

    def transfer_time(self, nbytes: int, kind: str = "parallel",
                      n_dpus: int | None = None) -> float:
        """Host<->banks transfer time (paper §3.4). 'serial' scales with DPU
        count; 'parallel'/'broadcast' use rank-level sustained bandwidth."""
        n = n_dpus or self.n_dpus
        ranks = max(1, math.ceil(n / self.dpus_per_rank))
        if kind == "serial":
            return nbytes / self.serial_bw
        if kind == "parallel":
            return nbytes / (self.cpu_dpu_bw * ranks)
        if kind == "parallel_from":
            return nbytes / (self.dpu_cpu_bw * ranks)
        if kind == "broadcast":
            return nbytes / (self.broadcast_bw * ranks)
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# NVIDIA H100 model (roofline target)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GpuModel:
    """One NVIDIA H100 SXM: the data sheet's dense peaks at its 700 W
    limit, or the HBM rate measured on the card."""

    peak_flops_bf16: float = 989e12   # dense tensor-core FLOP/s
    peak_flops_f32: float = 67e12     # FLOP/s outside the tensor cores
    hbm_bw: float = 3.35e12           # B/s, HBM3
    hbm_bytes: int = 80 * 10**9       # capacity
    link_bw: float = 900e9            # B/s, NVLink (4th generation)

    @property
    def ridge_point(self) -> float:
        """FLOP/B where the card turns compute-bound in bfloat16."""
        return self.peak_flops_bf16 / self.hbm_bw

    @classmethod
    def from_stream_rows(cls, rows, **kwargs) -> "GpuModel":
        """The data sheet's card with ``hbm_bw`` the fastest of
        ``characterize.stream_wram`` rows measured on it (their ``mbps``
        count each element's reads and writes once)."""
        if not rows:
            raise ValueError("from_stream_rows needs stream_wram rows")
        return cls(hbm_bw=max(r["mbps"] for r in rows) * 1e6, **kwargs)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Three-term roofline for one (arch x shape x cards) cell."""

    flops: float                # program FLOPs (all cards)
    hbm_bytes: float            # bytes accessed
    collective_bytes: float     # summed collective operand bytes
    chips: int
    model_flops: float = 0.0    # 6*N*D useful flops (0 if n/a)
    model_bytes: float = 0.0    # analytic minimum HBM traffic (0 if n/a)
    gpu: GpuModel = GpuModel()

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.gpu.peak_flops_bf16)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.gpu.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * self.gpu.link_bw)

    @property
    def bound(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_fraction(self) -> float:
        """MODEL_FLOPS / program FLOPs — catches remat/redundancy waste."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def ideal_time(self) -> float:
        """Best achievable step time: useful flops at peak AND the analytic
        minimum HBM traffic at full bandwidth, whichever binds."""
        return max(self.model_flops / (self.chips * self.gpu.peak_flops_bf16),
                   self.model_bytes / (self.chips * self.gpu.hbm_bw))

    @property
    def roofline_fraction(self) -> float:
        """ideal_time / dominant-term time: how close the program is to the
        roofline for its own useful work."""
        ideal = self.ideal_time
        return ideal / self.t_bound if self.t_bound and ideal else 0.0

    def row(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bound": self.bound,
            "hlo_flops": self.flops,
            "hlo_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "model_bytes": self.model_bytes,
            "useful_flop_frac": self.useful_flop_fraction,
            "useful_byte_frac": (self.model_bytes / self.hbm_bytes
                                 if self.hbm_bytes else 0.0),
            "roofline_frac": self.roofline_fraction,
        }


def min_hbm_bytes_train(cfg, tokens: float) -> float:
    """Analytic minimum HBM traffic for one train step: bf16 params read
    fwd+bwd + written (6·N) + f32 master/m/v read+write (48·N) + one
    activation save/restore per layer boundary (4·tokens·d·L bytes)."""
    n = cfg.total_params()
    act = 4.0 * tokens * cfg.d_model * cfg.n_layers
    return 54.0 * n + act


def min_hbm_bytes_decode(cfg, batch: float, cache_bytes: float) -> float:
    """One decode step: active params read once (2·N_active... all-expert
    worst case is batch-dependent; use active set per token × batch capped by
    total) + the whole cache read + written slice (negligible)."""
    n_read = min(cfg.active_params() * max(batch, 1), cfg.total_params())
    return 2.0 * n_read + cache_bytes


def min_hbm_bytes_prefill(cfg, tokens: float) -> float:
    return 2.0 * cfg.total_params() + 4.0 * tokens * cfg.d_model * cfg.n_layers


def model_flops_train(n_params_active: float, tokens: float) -> float:
    """6*N*D rule for a train step."""
    return 6.0 * n_params_active * tokens


def model_flops_decode(n_params_active: float, tokens: float) -> float:
    """2*N per generated token (forward only)."""
    return 2.0 * n_params_active * tokens
