"""Seeded inputs of the PrIM workloads, made on the device and handed to
the program as host arrays (the session takes numpy operands), and the
comparison of the answers with the plain reference.

A workload file under ``workloads/`` names its reference and the bytes of
its output; these classes do the rest.  The work of a request, the bytes
its computation needs, is each input read once and each output written
once, counted from the inputs the benchmark made: the same number
whatever implements the workload."""
from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from harness import answers, spec

_DTYPES = {"int64": torch.int64}


class IntPool:
    """``size`` one-operand integer requests of a workload whose answers
    compare exactly: ``elements`` values of the dataset's ``dtype`` from
    the workload's generator ``values(n, dtype, gen, device)``."""

    def __init__(self, name: str, data: dict, size: int, gen, device,
                 rng: np.random.Generator, values: Callable,
                 out_bytes: Callable, positions: int):
        self.name = name
        self.reference = spec.reference_module(name)
        self.inputs, self.work = [], []
        n = int(data["elements"])
        for _ in range(size):
            x = values(n, _DTYPES[data["dtype"]], gen, device)
            self.work.append(x.numel() * x.element_size() + int(out_bytes(x)))
            self.inputs.append(x.cpu().numpy())
            del x
        self.size = size
        self.pos = answers.positions(n, positions, rng)

    def args(self, j: int) -> tuple:
        return (self.inputs[j],)

    def work_bytes(self, j: int) -> int:
        return self.work[j]

    def resident(self) -> tuple:
        return ()

    def keep(self, j: int, out, whole: bool) -> answers.Kept:
        return answers.keep(j, out, self.pos, whole)

    def check(self, kept: list, device) -> dict:
        refs = {j: self.reference.ref(*self.args(j))
                for j in sorted({k.j for k in kept})}
        return {f"{self.name.lower()}_mismatched":
                answers.mismatches(kept, refs, self.pos)}

    def control(self, j: int, device):
        return self.reference.control(*self.args(j))


class GemvPool:
    """One ``rows`` x ``cols`` matrix, the operand every request shares (a
    session pins it), and ``size`` vectors, one a request in turn.  Entries
    are standard normal float32."""

    def __init__(self, name: str, data: dict, size: int, gen, device,
                 rng: np.random.Generator, positions: int):
        self.name = name
        self.reference = spec.reference_module(name)
        rows, cols = int(data["rows"]), int(data["cols"])
        a = torch.randn((rows, cols), generator=gen, device=device,
                        dtype=torch.float32)
        self.a = a.cpu().numpy()
        del a
        self.xs = torch.randn((size, cols), generator=gen, device=device,
                              dtype=torch.float32).cpu().numpy()
        self.size = size
        self.work = (rows * cols + cols + rows) * 4
        self.pos = answers.positions(rows, positions, rng)
        self._a_tf32 = None
        self._tf32_lock = threading.Lock()

    def args(self, j: int) -> tuple:
        return (self.a, self.xs[j])

    def work_bytes(self, j: int) -> int:
        return self.work

    def resident(self) -> tuple:
        """The positions of the operand every request shares."""
        return (0,)

    def keep(self, j: int, out, whole: bool) -> answers.Kept:
        return answers.keep(j, out, self.pos, whole)

    def check(self, kept: list, device) -> dict:
        """The largest error of an answer's element against the float64
        product, over |A| |x| of its row (float32 rounding reads about
        1e-7, TF32 inputs about 1e-5), and the answers of another shape
        or with an element that is not finite."""
        rows = self.a.shape[0]
        good = [k for k in kept if k.shape == (rows,)
                and np.all(np.isfinite(k.sample))
                and (k.full is None or np.all(np.isfinite(k.full)))]
        worst = 0.0
        for part in ("sample", "full"):
            some = [k for k in good if getattr(k, part) is not None]
            if not some:
                continue
            used = sorted({k.j for k in some})
            col = {j: c for c, j in enumerate(used)}
            y, s = self.reference.product(
                self.a, self.xs[used], device,
                rows=(answers.sampled(rows, self.pos) if part == "sample"
                      else None))
            for k in some:
                c = col[k.j]
                err = np.abs(getattr(k, part) - y[:, c]) / s[:, c]
                worst = max(worst, float(err.max()))
        return {"gemv_scaled_err": worst,
                "gemv_malformed": len(kept) - len(good)}

    def control(self, j: int, device):
        # the clients call this at once: one of them rounds the matrix, the
        # card holds it once
        with self._tf32_lock:
            if self._a_tf32 is None:
                self._a_tf32 = self.reference.tf32(
                    torch.from_numpy(self.a).to(device))
        return self.reference.control(self._a_tf32, self.xs[j])
