"""The UPMEM DPU model of the paper (§3) — the ported part of
``repro.core.perfmodel``: :class:`DpuModel` (Eqs. 1-4 with the paper's
measured constants), :func:`mram_capacity_bytes`, the residency budget of
the resident-operand cache, and :func:`fit_affine`, the least-squares fit
the autotuner's stage models use.  Pure Python, copied from the reference.

The residency budget stays the reference's MRAM model, not the card's
memory: 64 MB per bank with half reserved, so 2,048 banks budget 64 GiB,
which fits the H100's 80 GB.  ``DpuSystemModel`` and the TPU roofline
model are not ported.
"""
from __future__ import annotations

import dataclasses
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
