"""Bank-local execution model on one CUDA device — the PyTorch counterpart
of ``repro.core.banked``.

UPMEM semantics, as the port maps them onto one GPU:

* A ``BankGrid`` owns ``n_banks`` banks on one ``torch.device``.  A bank is
  one slice of the leading axis of a tensor on that device: the bank-major
  layout that ``pad_chunks`` / ``to_banked`` produce on the host.
* ``bank_local(fn)`` hands ``fn`` the whole ``(banks, ...)`` tensor.  The
  phase functions are written over the bank axis, so each CUDA phase is one
  launch with the bank axis in its grid, never a Python loop over banks.
  Bank row ``b`` of every output depends only on bank row ``b`` of every
  input.  That holds by construction; there is no lowered program to check
  for collectives (the JAX package's ``assert_collective_free``), and the
  port's tests perturb one bank and check that only that bank's output
  moves.
* Inter-bank communication happens only in the explicit ``exchange_*``
  phases, which are the only code that reads across banks:
    ``via="host"``   — D2H, merge in numpy, H2D (the paper's faithful path);
    ``via="fabric"`` — torch ops over the bank axis on the device.

The JAX reference runs with 64-bit types off, so its ``device_put`` narrows
int64 / uint64 / float64 / complex128 host arrays to 32 bits.  ``to_banks``
and ``broadcast`` narrow the same way, which keeps every output dtype equal
to the reference's (SCAN's host offsets arrive as int32, for example).
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import TYPE_CHECKING, Callable, Sequence

import numpy as np
import torch

if TYPE_CHECKING:
    from .streams import RankStreams

#: Environment override for the default rank count: ``make_bank_grid()``
#: upgrades to a :class:`RankGrid` when the bank count divides evenly and
#: stays flat otherwise.
RANKS_ENV = "REPRO_RANKS"

#: what ``jax.device_put`` does to 64-bit host arrays with x64 off
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
           np.dtype(np.float64): np.float32,
           np.dtype(np.complex128): np.complex64}


def _env_ranks() -> int:
    try:
        return int(os.environ.get(RANKS_ENV) or 1)
    except ValueError:
        return 1


def _device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda:0`` and raises
    when there is no CUDA device (the CPU is only ever asked for)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the banks on the CPU")
    return torch.device("cuda", 0)


def make_bank_grid(n_banks: int | None = None, *, ranks: int | None = None,
                   device=None) -> "BankGrid":
    """Grid of ``n_banks`` banks (default 1) on ``device`` (default
    ``cuda:0``).  ``ranks`` (default: the ``REPRO_RANKS`` env var) groups
    the banks into a two-level :class:`RankGrid`; an explicit ``ranks``
    that does not divide the bank count raises, an env-derived one falls
    back to the flat grid."""
    n = n_banks or 1
    dev = _device(device)
    if ranks is None:
        env = _env_ranks()
        ranks = env if env > 1 and n % env == 0 else 1
    if ranks > 1:
        return RankGrid(n_banks=n, device=dev, n_ranks=ranks)
    return BankGrid(n_banks=n, device=dev)


def make_rank_grid(n_ranks: int, banks_per_rank: int = 1, *,
                   device=None) -> "RankGrid":
    """A two-level rank × bank grid: ``n_ranks`` ranks of
    ``banks_per_rank`` banks each."""
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    return RankGrid(n_banks=n_ranks * banks_per_rank,
                    device=_device(device), n_ranks=n_ranks)


def _host(x) -> np.ndarray:
    x = np.asarray(x)
    to = _NARROW.get(x.dtype)
    return np.ascontiguousarray(x.astype(to) if to is not None else x)


@dataclasses.dataclass(frozen=True)
class BankGrid:
    """``n_banks`` banks, each one slice of the leading axis of a tensor on
    ``device``.

    ``rank`` is a rank view's index in its :class:`RankGrid` (0 for a flat
    grid).  It is left out of equality and hashing, so the rank views of
    one grid compare equal and nothing may key per-rank state on a view:
    each view object owns its :attr:`streams` instead."""

    n_banks: int
    device: torch.device
    rank: int = dataclasses.field(default=0, compare=False)

    @functools.cached_property
    def streams(self) -> RankStreams | None:
        """This grid's pipeline streams and pinned staging, created at first
        use; None on the CPU, where every copy is synchronous."""
        if self.device.type != "cuda":
            return None
        from .streams import RankStreams   # streams imports transfer, which
        return RankStreams(self.device)    # imports this module

    # -- data placement ("CPU-DPU transfers", paper §3.4) -------------------
    def _put(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        host = _host(x)
        streams = self.__dict__.get("streams")
        if streams is not None and streams.staging():
            return streams.put(host)         # inside a pipeline scatter stage
        return torch.from_numpy(host).to(self.device)

    def to_banks(self, x) -> torch.Tensor:
        """Parallel CPU→DPU transfer: one H2D copy of the bank-major array
        (leading axis = banks)."""
        return self._put(x)

    def broadcast(self, x) -> torch.Tensor:
        """dpu_broadcast_to: one buffer every bank reads."""
        return self._put(x)

    def from_banks(self, x) -> np.ndarray:
        """Parallel DPU→CPU transfer: one D2H copy of all banks."""
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    def serial_to_banks(self, chunks: Sequence[np.ndarray]):
        """Serial dpu_copy_to: one copy per bank (the Fig.10 contrast, and
        the only option for ragged per-bank buffers)."""
        return [self._put(c) for c in chunks]

    # -- bank-local phase ----------------------------------------------------
    def bank_local(self, fn: Callable) -> Callable:
        """A DPU kernel launch: ``fn`` takes and returns ``(banks, ...)``
        tensors, and bank row ``b`` of its outputs reads only bank row
        ``b`` of its inputs (broadcast operands excepted)."""
        return fn

    # -- exchange phases ("Inter-DPU" step) ----------------------------------
    def exchange_sum(self, x, via: str = "fabric"):
        """RED-style final merge: input (banks, ...) partials -> summed (...)."""
        if via == "host":
            return self.from_banks(x).sum(axis=0)
        return x.sum(dim=0, dtype=x.dtype)

    def exchange_scan(self, bank_totals, via: str = "fabric"):
        """SCAN-SSA/RSS inter-bank step: exclusive scan over per-bank totals,
        one scalar back to each bank, as a (banks,) tensor."""
        if via == "host":
            t = self.from_banks(bank_totals).reshape(self.n_banks)
            excl = np.concatenate([[t.dtype.type(0)], np.cumsum(t)[:-1]])
            return self.to_banks(excl)
        t = bank_totals.reshape(self.n_banks)
        c = torch.cumsum(t, dim=0, dtype=t.dtype)
        return torch.cat([torch.zeros_like(t[:1]), c[:-1]])

    def exchange_union(self, bitvec, via: str = "fabric"):
        """BFS frontier union: OR-reduce the per-bank bit-vectors.  As in
        the reference, the host mode returns the flat union (a broadcast
        vector) and the fabric mode one bank's block shape: ``(1, w)`` for
        a ``(banks, w)`` input, as ``all_gather`` + ``reduce`` under
        ``out_specs=P()`` give it."""
        if via == "host":
            parts = self.from_banks(bitvec).reshape(self.n_banks, -1)
            u = functools.reduce(np.bitwise_or, parts)
            return self.broadcast(u)
        blocks = bitvec.reshape(self.n_banks, bitvec.shape[0] // self.n_banks,
                                *bitvec.shape[1:])
        return functools.reduce(torch.bitwise_or, blocks.unbind(0))

    def exchange_concat(self, x, via: str = "fabric"):
        """SEL/UNI-style merge: the concatenated per-bank results.  On one
        device the (banks, ...) tensor already is that array."""
        if via == "host":
            return self.from_banks(x)
        return x


# ---------------------------------------------------------------------------
# rank hierarchy (DESIGN.md §10)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RankGrid(BankGrid):
    """Two-level rank × bank grid — the real UPMEM topology (DESIGN.md §10).

    It IS-A :class:`BankGrid` over all ``n_ranks * banks_per_rank`` banks —
    the flat view — and :meth:`rank_view` exposes each rank as a flat
    ``BankGrid`` of its own ``banks_per_rank`` banks on the same device.
    """

    n_ranks: int = 1

    def __post_init__(self):
        if self.n_ranks < 1:
            raise ValueError(f"n_ranks must be >= 1, got {self.n_ranks}")
        if self.n_banks % self.n_ranks:
            raise ValueError(f"{self.n_banks} banks do not split into "
                             f"{self.n_ranks} equal ranks")

    @property
    def banks_per_rank(self) -> int:
        return self.n_banks // self.n_ranks

    @functools.cached_property
    def rank_views(self) -> tuple[BankGrid, ...]:
        """One flat ``BankGrid`` per rank (stable objects, cached)."""
        return tuple(BankGrid(n_banks=self.banks_per_rank, device=self.device,
                              rank=r)
                     for r in range(self.n_ranks))

    def rank_view(self, rank: int) -> BankGrid:
        """Rank ``rank`` as an independent flat grid (its "64 DPUs")."""
        return self.rank_views[rank]
