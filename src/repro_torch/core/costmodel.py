"""Compositional instruction-level cost model — the paper's contribution 1
turned predictive (DESIGN.md §15), the PyTorch counterpart of
``repro.core.costmodel``.

The paper characterizes the DPU with microbenchmarks: per-op/per-datatype
pipeline throughput (§3.1, Eq. 1), WRAM/MRAM streaming bandwidth (§3.2),
and asymmetric CPU<->DPU transfer costs with fixed setup overheads (§3.4).
This module composes those measured limits into an analytical model:

* :func:`count_ops` runs a callable under a ``TorchDispatchMode`` and
  tallies element-ops per (op class, canonical dtype) from the aten ops it
  dispatches — the op table is derived from the same callables the
  pipeline executes.  It takes the place of the reference's jaxpr walk,
  with the reference's op classes and counting rules.
* :class:`CostProfile` is one workload's op table + payload bytes
  (``WorkloadEntry.cost_profile`` in ``prim/registry.py`` builds it).
* :class:`CostModel` carries per-(op, dtype) issue+execute costs fitted
  from ``characterize.op_throughput_sweep`` and push/pull transfer
  constants fitted from ``characterize.push_pull_sweep``; ``predict`` maps
  a profile + chunk count to per-stage seconds and a pipeline makespan
  (the same 3-stage recurrence the autotuner solves, DESIGN.md §8), and
  ``predict_plan`` evaluates a TunedPlan directly.
* :class:`EnergyModel` prices the same profile in joules following the
  per-op/per-access energy accounting of arXiv:2110.01709.
* :func:`roofline_rows` emits per-workload analytical roofline rows
  (operational intensity vs compute/transfer roofs).

The fit layer (:meth:`CostModel.fit`) is pure — it consumes measurement
rows, so tests can feed synthetic sweeps and assert determinism — while
:meth:`CostModel.calibrate` runs the real sweeps on a grid.  Everything
below the op counting is copied from the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .perfmodel import OP_INSTRUCTIONS, fit_affine
from .transfer import tree_leaves, tree_map, tree_nbytes

# Floors keeping predictions finite on degenerate fits (a flat two-point
# sweep can yield beta <= 0 on a fast host; same guard as autotune's
# StageFit).
_MIN_PER_OP_S = 1e-15
_MIN_BYTES_PER_S = 1.0

# Comparison/select ops are not in the paper's Fig. 4 table; price them as
# the same-dtype add (1-instruction ALU class on the DPU ISA).
_CMP_FALLBACK_OP = "add"


def geomean_ratio(ratios) -> float:
    """Geometric mean of >=1 accuracy ratios (each >= 1 by construction)."""
    vals = [float(r) for r in ratios]
    if not vals:
        return 1.0
    return float(math.exp(sum(math.log(max(v, 1e-12)) for v in vals) / len(vals)))


# -- op counting on dispatched aten ops ----------------------------------------

#: canonical dtype itemsize used by the what-if dtype rescaling
_ITEMSIZE = {"int32": 4, "int64": 8, "float": 4, "double": 8}

#: elementwise aten op -> op class (one op per output element); the
#: reference's jax primitives under their aten names
_ELEMENTWISE: Mapping[str, str] = {
    "add": "add",
    "sub": "sub",
    "rsub": "sub",
    "neg": "sub",
    "mul": "mul",
    "div": "div",
    "floor_divide": "div",
    "remainder": "div",
    "fmod": "div",
    "pow": "mul",
    "square": "mul",
    "sqrt": "div",
    "rsqrt": "div",
    "exp": "mul",
    "log": "mul",
    "tanh": "mul",
    "sigmoid": "mul",
    "abs": "cmp",
    "sign": "cmp",
    "maximum": "cmp",
    "minimum": "cmp",
    "floor": "cmp",
    "ceil": "cmp",
    "round": "cmp",
    "lt": "cmp",
    "le": "cmp",
    "gt": "cmp",
    "ge": "cmp",
    "eq": "cmp",
    "ne": "cmp",
    "bitwise_and": "cmp",
    "bitwise_or": "cmp",
    "bitwise_xor": "cmp",
    "bitwise_not": "cmp",
    "logical_and": "cmp",
    "logical_or": "cmp",
    "logical_xor": "cmp",
    "logical_not": "cmp",
    "where": "cmp",
    "clamp": "cmp",
    "clamp_min": "cmp",
    "clamp_max": "cmp",
    "silu": "mul",
    "bitwise_left_shift": "add",
    "bitwise_right_shift": "add",
    "__lshift__": "add",
    "__rshift__": "add",
}

#: aten ops that stand for several of the reference's primitives on each
#: element: ``jax.nn.silu`` is ``x * logistic(x)``
_OPS_PER_ELEMENT = {"silu": 2}

#: reduction / scan aten op -> op class (one op per *input* element)
_REDUCTIONS: Mapping[str, str] = {
    "sum": "add",
    "prod": "mul",
    "amax": "cmp",
    "amin": "cmp",
    "any": "cmp",
    "all": "cmp",
    "argmax": "cmp",
    "argmin": "cmp",
    "cumsum": "add",
    "cummax": "cmp",
    "cummin": "cmp",
    "cumprod": "mul",
}

#: aten ops that are a reduction in one overload and elementwise in another
#: (``max.dim`` against ``max.other``)
_REDUCE_OR_PAIRWISE = {"max": "cmp", "min": "cmp"}

#: products: (m, k) x (k, n) → m·n·k muls and m·n·max(k-1, 1) adds, as the
#: reference counts ``dot_general``; the value is the position of the left
#: operand (after a bias, whose add counts once per output element)
_PRODUCTS = {"mm": 0, "mv": 0, "bmm": 0, "dot": 0, "vdot": 0,
             "addmm": 1, "addmv": 1, "baddbmm": 1}


def canon_dtype(dt) -> str:
    """Map any array or tensor dtype onto the paper's four
    characterization dtypes."""
    if isinstance(dt, torch.dtype):
        if dt.is_floating_point or dt.is_complex:
            return "double" if dt.itemsize == 8 else "float"
        if dt == torch.bool:
            return "int32"    # predicate lanes
        return "int64" if dt.itemsize == 8 else "int32"
    dt = np.dtype(dt)
    if dt.kind == "f":
        return "double" if dt.itemsize == 8 else "float"
    if dt.kind in "iu":
        return "int64" if dt.itemsize == 8 else "int32"
    return "int32"  # bool / predicate lanes


def _aten_name(func) -> str:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]                      # in-place form
    return name


def _first_tensor(x):
    for leaf in tree_leaves(x):
        if isinstance(leaf, torch.Tensor):
            return leaf
    return None


class _OpCounter(TorchDispatchMode):
    """Tallies every aten op dispatched under it into ``counts``."""

    def __init__(self):
        super().__init__()
        self.counts: dict = {}

    def _add(self, cls: str, t: torch.Tensor, n: float) -> None:
        key = (cls, canon_dtype(t.dtype))
        self.counts[key] = self.counts.get(key, 0.0) + float(n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = _aten_name(func)
        first = _first_tensor(out)
        if name in _PRODUCTS and first is not None:
            lhs = args[_PRODUCTS[name]]
            k = int(lhs.shape[-1])
            self._add("mul", first, first.numel() * k)
            self._add("add", first, first.numel() * max(k - 1, 1))
            if _PRODUCTS[name]:
                self._add("add", first, first.numel())   # the bias
        elif name in _REDUCTIONS or (name in _REDUCE_OR_PAIRWISE
                                     and func._overloadname != "other"):
            src = args[0]
            cls = _REDUCTIONS.get(name) or _REDUCE_OR_PAIRWISE[name]
            self._add(cls, src, src.numel())
        elif name in _ELEMENTWISE or name in _REDUCE_OR_PAIRWISE:
            if first is not None:
                cls = _ELEMENTWISE.get(name) or _REDUCE_OR_PAIRWISE[name]
                self._add(cls, first,
                          first.numel() * _OPS_PER_ELEMENT.get(name, 1))
        # layout / move / copy / index ops are free in this model
        return out


def count_ops(fn, *args) -> tuple[dict, Any]:
    """(op class, canonical dtype) -> element-op count of ``fn(*args)``,
    and its outputs.

    Every aten op ``fn`` dispatches is tallied: an elementwise op counts
    its output's elements; a reduction or scan its input's; ``mm`` /
    ``mv`` / ``bmm`` (what ``matmul`` becomes) count m·n·k muls and
    m·n·max(k−1, 1) adds, as the reference's ``dot_general``.  Layout
    ops (views, copies, gathers, scatters, concatenations) are free —
    their cost lives in the fitted transfer/issue constants.  Only what
    reaches the dispatcher is seen: work in numpy, or inside a CUDA
    kernel launched through ``ctypes``, is not, so count a phase on CPU
    tensors, where the kernel wrappers run their plain versions.  Under
    a ``FakeTensorMode`` no data is computed."""
    counter = _OpCounter()
    with counter:
        out = fn(*args)
    return counter.counts, out


def _fake_counts(fn, args):
    """:func:`count_ops` with every tensor of ``args`` replaced by a fake
    one of the same shape and dtype, so nothing is computed."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = tree_map(lambda t: mode.from_tensor(t)
                        if isinstance(t, torch.Tensor) else t, args)
        return count_ops(fn, *fake)


# -- per-workload cost profile ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostProfile:
    """One workload's op table + payload bytes at a concrete problem size."""

    workload: str
    bytes_in: int
    bytes_out: int
    op_counts: Mapping[tuple, float]
    n_banks: int
    source: str  # "aten:compute" | "untraced"

    @property
    def total_ops(self) -> float:
        return float(sum(self.op_counts.values()))

    @property
    def traced(self) -> bool:
        return self.source.startswith(("aten:", "jaxpr:"))

    def mean_itemsize(self) -> float:
        """Op-count-weighted element width (what-if dtype scaling base)."""
        total = self.total_ops
        if total <= 0:
            return 4.0
        acc = sum(
            n * _ITEMSIZE.get(dt, 4) for (_, dt), n in self.op_counts.items()
        )
        return acc / total

    def scaled(self, problem_x: float) -> "CostProfile":
        """The same workload at ``problem_x`` times the problem size."""
        return dataclasses.replace(
            self,
            bytes_in=int(self.bytes_in * problem_x),
            bytes_out=int(self.bytes_out * problem_x),
            op_counts={k: v * problem_x for k, v in self.op_counts.items()},
        )

    def retyped(self, dtype: str) -> "CostProfile":
        """The same workload with elements re-typed (e.g. "int8"): payload
        bytes scale by the itemsize ratio and every op is re-priced at the
        canonical dtype (sub-32-bit types price at the int32/float floor —
        the DPU ALU is 32-bit, paper §2.3.1)."""
        canon = canon_dtype(dtype) if dtype not in _ITEMSIZE else dtype
        width = {"int8": 1, "int16": 2, "float16": 2, "bfloat16": 2}.get(
            dtype, _ITEMSIZE.get(canon, 4)
        )
        ratio = width / self.mean_itemsize()
        merged: dict = {}
        for (op, _), n in self.op_counts.items():
            merged[(op, canon)] = merged.get((op, canon), 0.0) + n
        return dataclasses.replace(
            self,
            bytes_in=max(int(self.bytes_in * ratio), 1),
            bytes_out=max(int(self.bytes_out * ratio), 1),
            op_counts=merged,
        )

    def as_dict(self) -> dict:
        return {
            "workload": self.workload,
            "bytes_in": int(self.bytes_in),
            "bytes_out": int(self.bytes_out),
            "n_banks": int(self.n_banks),
            "source": self.source,
            "op_counts": {
                f"{op}:{dt}": float(n) for (op, dt), n in sorted(self.op_counts.items())
            },
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "CostProfile":
        counts = {}
        for key, n in d.get("op_counts", {}).items():
            op, dt = key.split(":", 1)
            counts[(op, dt)] = float(n)
        return cls(
            workload=d["workload"],
            bytes_in=int(d["bytes_in"]),
            bytes_out=int(d["bytes_out"]),
            op_counts=counts,
            n_banks=int(d.get("n_banks", 1)),
            source=d.get("source", "untraced"),
        )


def profile_entry(grid, entry, args) -> CostProfile:
    """Build a :class:`CostProfile` for a registry entry at concrete args.

    Pipelineable workloads count the chunked ``compute`` phase at
    n_chunks=1 (the callable the pipeline runs), so the op table is
    derived from — and cannot drift from — the executed phase.  The phase
    runs on a CPU :class:`~repro_torch.core.banked.BankGrid` of the same
    ``n_banks``: on a CUDA tensor the kernel wrappers launch their kernels
    through ``ctypes``, which no dispatch mode sees, while on the CPU they
    run their plain versions.  ``split`` and ``scatter`` run for real on
    the host; ``compute`` runs on fake tensors of the same shapes
    (``FakeTensorMode``), so no data is computed, as the reference's
    ``make_jaxpr`` computes none.  The reference counts per bank (it
    traces the ``shard_map`` body); the port counts over the whole bank
    axis and divides by ``n_banks``.  Serialized-only workloads (NW, BFS)
    decompose through host loops; they get an explicitly ``untraced``
    profile with an empty op table, as in the reference.
    """
    from .banked import BankGrid

    bytes_in = entry.arg_nbytes(args)
    w = entry.chunked
    if w is not None:
        cpu = (grid if grid.device.type == "cpu"
               else BankGrid(n_banks=grid.n_banks, device=torch.device("cpu")))
        meta, chunks = w.split(cpu, 1, *args)
        bufs = w.scatter(cpu, meta, chunks[0])
        counts, out = _fake_counts(
            lambda m, b: w.compute(cpu, m, b), (meta, bufs))
        return CostProfile(
            workload=entry.name,
            bytes_in=bytes_in,
            bytes_out=tree_nbytes(out),
            op_counts={k: v / grid.n_banks for k, v in counts.items()},
            n_banks=grid.n_banks,
            source="aten:compute",
        )
    out = entry.ref(*args)
    return CostProfile(
        workload=entry.name,
        bytes_in=bytes_in,
        bytes_out=tree_nbytes(out),
        op_counts={},
        n_banks=grid.n_banks,
        source="untraced",
    )


# -- fitted constants ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Affine per-(op, dtype) cost at full grid width: t(n) = issue + n*per_op."""

    issue_s: float
    per_op_s: float


@dataclasses.dataclass(frozen=True)
class TransferCost:
    """Affine transfer cost with a fixed setup overhead (paper Eq. 3 shape)."""

    setup_s: float
    bytes_per_s: float

    def seconds(self, nbytes: float) -> float:
        return self.setup_s + nbytes / max(self.bytes_per_s, _MIN_BYTES_PER_S)


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Per-op/per-access energy table in the spirit of arXiv:2110.01709's
    extended UPMEM characterization: dynamic energy scales with executed
    instructions and bytes moved, plus static power for the banks held
    over the makespan.  Defaults are order-of-magnitude constants for a
    DDR4-PIM-class part; override for other backends."""

    pj_per_instruction: float = 20.0
    pj_per_mram_byte: float = 70.0
    pj_per_transfer_byte: float = 25.0
    static_w_per_bank: float = 0.3

    def joules(
        self,
        instructions: float,
        bytes_moved: float,
        makespan_s: float,
        n_banks: int,
    ) -> float:
        dynamic = (
            instructions * self.pj_per_instruction
            + bytes_moved * (self.pj_per_mram_byte + self.pj_per_transfer_byte)
        ) * 1e-12
        return dynamic + self.static_w_per_bank * n_banks * makespan_s

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "EnergyModel":
        return cls(**{k: float(v) for k, v in d.items()})


@dataclasses.dataclass(frozen=True)
class PlanPrediction:
    """Model output for one (workload, plan) pair — pure arithmetic, no probes."""

    workload: str
    n_chunks: int
    stage_s: Mapping[str, float]  # cpu_dpu / dpu / dpu_cpu totals
    serialized_s: float
    makespan_s: float
    energy_j: float

    def as_dict(self) -> dict:
        return {
            "workload": self.workload,
            "n_chunks": int(self.n_chunks),
            "stage_s": {k: float(v) for k, v in self.stage_s.items()},
            "serialized_s": float(self.serialized_s),
            "makespan_s": float(self.makespan_s),
            "energy_j": float(self.energy_j),
        }


def _instruction_weight(op: str, dtype: str) -> float:
    key = (_CMP_FALLBACK_OP if op == "cmp" else op, dtype)
    return float(OP_INSTRUCTIONS.get(key, 1))


def _fit_transfer(points: list) -> TransferCost:
    alpha, beta = fit_affine([p[0] for p in points], [p[1] for p in points])
    if beta <= 0:
        # flat sweep on a fast host: treat transfer as pure (tiny) setup
        return TransferCost(setup_s=max(alpha, 0.0), bytes_per_s=1e18)
    return TransferCost(setup_s=max(alpha, 0.0), bytes_per_s=1.0 / beta)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Fitted DPU-grid cost model: per-op issue+execute costs per dtype,
    asymmetric push/pull transfer constants, and a dispatch overhead."""

    ops: Mapping[tuple, OpCost]
    push: TransferCost
    pull: TransferCost
    dispatch_s: float
    n_banks: int
    energy: EnergyModel = dataclasses.field(default_factory=EnergyModel)

    # -- construction ---------------------------------------------------------

    @classmethod
    def fit(cls, op_rows, xfer_rows, n_banks: int) -> "CostModel":
        """Pure fit from measurement rows (deterministic given the rows).

        ``op_rows`` come from ``characterize.op_throughput_sweep`` (keys:
        op, dtype, elements, seconds); ``xfer_rows`` from
        ``characterize.push_pull_sweep`` (keys: nbytes, push_s, pull_s).
        """
        groups: dict = {}
        for r in op_rows:
            key = (r["op"], r["dtype"])
            groups.setdefault(key, []).append(
                (float(r["elements"]), float(r["seconds"]))
            )
        ops = {}
        for key, pts in sorted(groups.items()):
            alpha, beta = fit_affine([p[0] for p in pts], [p[1] for p in pts])
            if beta <= 0:
                beta = min(p[1] for p in pts) / max(max(p[0] for p in pts), 1.0)
            ops[key] = OpCost(
                issue_s=max(alpha, 0.0), per_op_s=max(beta, _MIN_PER_OP_S)
            )
        push = _fit_transfer([(r["nbytes"], r["push_s"]) for r in xfer_rows])
        pull = _fit_transfer([(r["nbytes"], r["pull_s"]) for r in xfer_rows])
        issues = sorted(c.issue_s for c in ops.values())
        dispatch = issues[len(issues) // 2] if issues else 0.0
        return cls(
            ops=ops, push=push, pull=pull, dispatch_s=dispatch, n_banks=n_banks
        )

    @classmethod
    def calibrate(
        cls,
        grid,
        *,
        ops=("add", "sub", "mul", "div"),
        dtypes=("int32", "float"),
        op_nbytes=(1 << 16, 1 << 20),
        xfer_nbytes=(1 << 18, 1 << 20, 1 << 22),
        reps: int = 3,
    ) -> "CostModel":
        """Run the characterization sweeps on ``grid`` and fit."""
        from . import characterize

        op_rows = characterize.op_throughput_sweep(
            grid, ops=ops, dtypes=dtypes, nbytes=op_nbytes, reps=reps
        )
        xfer_rows = characterize.push_pull_sweep(
            grid, nbytes=xfer_nbytes, reps=reps
        )
        return cls.fit(op_rows, xfer_rows, n_banks=grid.n_banks)

    # -- pricing --------------------------------------------------------------

    def op_cost(self, op: str, dtype: str) -> OpCost:
        """Measured cost, or an unmeasured (op, dtype) priced by scaling a
        measured sibling with the relative instruction weights of the
        paper's Fig. 4 table (perfmodel.OP_INSTRUCTIONS)."""
        lookup = _CMP_FALLBACK_OP if op == "cmp" else op
        hit = self.ops.get((lookup, dtype))
        if hit is not None:
            return hit
        want = _instruction_weight(op, dtype)
        same_dtype = [(k, c) for k, c in self.ops.items() if k[1] == dtype]
        pool = same_dtype or sorted(self.ops.items())
        if not pool:
            return OpCost(issue_s=0.0, per_op_s=_MIN_PER_OP_S)
        (base_op, base_dt), base = pool[0]
        have = _instruction_weight(base_op, base_dt)
        scale = want / max(have, 1.0)
        return OpCost(
            issue_s=base.issue_s, per_op_s=max(base.per_op_s * scale, _MIN_PER_OP_S)
        )

    def instructions(self, profile: CostProfile) -> float:
        """Executed-instruction estimate (energy accounting input)."""
        return sum(
            n * _instruction_weight(op, dt)
            for (op, dt), n in profile.op_counts.items()
        )

    # -- prediction -----------------------------------------------------------

    def predict(
        self,
        profile: CostProfile,
        n_chunks: int = 1,
        *,
        banks_x: float = 1.0,
        problem_x: float = 1.0,
        xfer_bw_x: float = 1.0,
    ) -> PlanPrediction:
        """Per-stage seconds + 3-stage pipeline makespan for a plan.

        ``banks_x`` scales compute throughput only (more banks split the
        element stream; the host bus bounds transfers, paper §3.4).
        ``xfer_bw_x`` scales transfer bandwidth only (the rank-parallel
        lever, paper §5).  ``problem_x`` scales payload and op counts.
        """
        c = max(int(n_chunks), 1)
        prof = profile if problem_x == 1.0 else profile.scaled(problem_x)
        push_bw = self.push.bytes_per_s * xfer_bw_x
        pull_bw = self.pull.bytes_per_s * xfer_bw_x
        push_c = self.push.setup_s + (prof.bytes_in / c) / max(
            push_bw, _MIN_BYTES_PER_S
        )
        pull_c = self.pull.setup_s + (prof.bytes_out / c) / max(
            pull_bw, _MIN_BYTES_PER_S
        )
        comp_c = self.dispatch_s
        for (op, dt), n in prof.op_counts.items():
            comp_c += (n / c) * self.op_cost(op, dt).per_op_s / max(banks_x, 1e-9)
        stage_s = {
            "cpu_dpu": c * push_c,
            "dpu": c * comp_c,
            "dpu_cpu": c * pull_c,
        }
        serialized = stage_s["cpu_dpu"] + stage_s["dpu"] + stage_s["dpu_cpu"]
        makespan = push_c + comp_c + pull_c + (c - 1) * max(push_c, comp_c, pull_c)
        bytes_moved = prof.bytes_in + prof.bytes_out
        energy = self.energy.joules(
            self.instructions(prof),
            bytes_moved,
            makespan,
            max(int(self.n_banks * banks_x), 1),
        )
        return PlanPrediction(
            workload=prof.workload,
            n_chunks=c,
            stage_s=stage_s,
            serialized_s=serialized,
            makespan_s=makespan,
            energy_j=energy,
        )

    def predict_plan(self, profile: CostProfile, plan) -> PlanPrediction:
        """Evaluate a TunedPlan's chunk count against the model."""
        return self.predict(profile, n_chunks=plan.n_chunks)

    def candidate_predictions(
        self, profile: CostProfile, candidates
    ) -> dict:
        """n_chunks -> predicted makespan seconds (the autotuner pre-filter
        input, DESIGN.md §15)."""
        return {
            int(c): self.predict(profile, n_chunks=c).makespan_s
            for c in candidates
        }

    # -- serialization --------------------------------------------------------

    def as_dict(self) -> dict:
        return {
            "n_banks": int(self.n_banks),
            "dispatch_s": float(self.dispatch_s),
            "push": {
                "setup_s": float(self.push.setup_s),
                "bytes_per_s": float(self.push.bytes_per_s),
            },
            "pull": {
                "setup_s": float(self.pull.setup_s),
                "bytes_per_s": float(self.pull.bytes_per_s),
            },
            "ops": {
                f"{op}:{dt}": {
                    "issue_s": float(c.issue_s),
                    "per_op_s": float(c.per_op_s),
                }
                for (op, dt), c in sorted(self.ops.items())
            },
            "energy": self.energy.as_dict(),
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "CostModel":
        ops = {}
        for key, c in d.get("ops", {}).items():
            op, dt = key.split(":", 1)
            ops[(op, dt)] = OpCost(
                issue_s=float(c["issue_s"]), per_op_s=float(c["per_op_s"])
            )
        return cls(
            ops=ops,
            push=TransferCost(**{k: float(v) for k, v in d["push"].items()}),
            pull=TransferCost(**{k: float(v) for k, v in d["pull"].items()}),
            dispatch_s=float(d.get("dispatch_s", 0.0)),
            n_banks=int(d.get("n_banks", 1)),
            energy=EnergyModel.from_dict(d.get("energy", {})),
        )


# -- analytical roofline ------------------------------------------------------


def roofline_rows(model: CostModel, profiles) -> list:
    """Per-workload analytical roofline rows, the reference's keys.

    The compute roof is the fitted per-op rate at the profile's op mix;
    the transfer roof is operational intensity times the push/pull mixed
    bandwidth; attainable = min(roofs), paper Fig. 9's construction.
    """
    rows = []
    for prof in profiles:
        if prof.total_ops <= 0:
            continue
        bytes_moved = max(prof.bytes_in + prof.bytes_out, 1)
        intensity = prof.total_ops / bytes_moved
        weighted = sum(
            n * model.op_cost(op, dt).per_op_s
            for (op, dt), n in prof.op_counts.items()
        )
        compute_roof = prof.total_ops / max(weighted, _MIN_PER_OP_S)
        xfer_s = prof.bytes_in / max(
            model.push.bytes_per_s, _MIN_BYTES_PER_S
        ) + prof.bytes_out / max(model.pull.bytes_per_s, _MIN_BYTES_PER_S)
        xfer_bw = bytes_moved / max(xfer_s, 1e-12)
        transfer_roof = intensity * xfer_bw
        pred = model.predict(prof, n_chunks=1)
        rows.append(
            {
                "table": "pim_roofline",
                "workload": prof.workload,
                "intensity_op_per_byte": float(intensity),
                "compute_roof_mops": float(compute_roof / 1e6),
                "transfer_roof_mops": float(transfer_roof / 1e6),
                "attainable_mops": float(min(compute_roof, transfer_roof) / 1e6),
                "bound": "compute" if compute_roof <= transfer_roof else "transfer",
                "predicted_mops": float(
                    prof.total_ops / max(pred.makespan_s, 1e-12) / 1e6
                ),
            }
        )
    return rows
