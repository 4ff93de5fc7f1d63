"""Bank-resident operand cache (DESIGN.md §12).

The UPMEM programs behind the paper pay ``dpu_copy_to`` for a workload's
large operand *once* and then reuse it across ``dpu_launch`` calls — the
matrix stays in MRAM.  The follow-up characterization (arXiv:2110.01709)
shows CPU↔DPU transfer dominating whenever that reuse is not exploited.
This module is the port of the reference's translation of the idiom: a
fingerprint-keyed registry of device-resident operands, held in their
bank/rank placement, so a repeated ``session.run()/submit()`` with the
same large operand skips the scatter stage entirely.  Fingerprints are
the reference's sha1s: the same bytes give the same key in both
packages, whether they arrive as a numpy array or as a tensor (hashed
through a CPU copy).

Key pieces:

* :func:`fingerprint` — content hash over the resident operand's bytes
  plus dtype/shape plus the placement spec (bank count, rank count, chunk
  count).  Same data in a different placement is a different entry.
* :class:`ResidentEntry` — one cached operand: per-rank resident metas
  (device constants such as GEMV's broadcast helpers) and per-chunk
  device buffers, filled exactly once under the entry lock.
* :class:`ResidentCache` — LRU over entries, budgeted against the MRAM
  capacity model (:func:`repro_torch.core.perfmodel.mram_capacity_bytes`),
  with pinning as the eviction escape hatch and hit/miss/eviction/
  resident-bytes counters mirrored into
  :class:`~repro_torch.runtime.metrics.Metrics`.
  ``acquire()`` additionally takes an in-flight *lease* on the entry it
  returns; leased entries are never eviction victims, so a warm hit handed
  to a request stays resident until that request retires
  (:meth:`ResidentCache.release`) — a later request's reservation cannot
  pull the buffers out from under a batchmate's ``[None]`` chunk
  placeholders.

Caller-owned mutation caveat: the fingerprint hashes the operand's bytes
*at acquire time*.  Re-submitting a mutated host array therefore misses
(new fingerprint) and re-scatters — stale reads are impossible — but the
cost is a full rehash of the operand per request; hashing is the price of
content addressing.  Callers who guarantee immutability can opt out of
the recurring rehash by wrapping the operand in a :class:`ResidentHandle`
(its precomputed digest stands in for the O(bytes) hash).
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from repro_torch.core.transfer import tree_leaves, tree_map, tree_nbytes

if TYPE_CHECKING:  # annotation-only: avoid importing the workload suite
    from repro_torch.prim.common import ChunkedWorkload

    from .metrics import Metrics


def _host_array(leaf) -> np.ndarray:
    """A leaf's logical bytes as numpy; a tensor through a CPU copy."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def content_digest(value) -> str:
    """sha1 over every array leaf of ``value``: dtype + shape + logical
    bytes.  The placement-independent half of :func:`fingerprint`.

    ``value`` may be any pytree (a dict/list of arrays digests leaf-wise,
    so a whole weight dict hashes in one pass), and any leaf may be a
    :class:`ResidentHandle` — its precomputed digest stands in for that
    leaf's O(bytes) rehash."""
    h = hashlib.sha1()
    for leaf in tree_leaves(
            value, is_leaf=lambda x: isinstance(x, ResidentHandle)):
        if isinstance(leaf, ResidentHandle):
            h.update(leaf.digest.encode())
            continue
        a = _host_array(leaf)
        h.update(a.dtype.str.encode())
        h.update(repr(a.shape).encode())
        h.update(memoryview(np.ascontiguousarray(a)).cast("B"))
    return h.hexdigest()


class ResidentHandle:
    """Opt-in identity token: a resident operand plus its content digest,
    hashed once at construction.

    :func:`fingerprint` rehashes the operand's bytes on every
    ``acquire()`` — the price of content addressing (mutation ⇒ miss,
    never a stale hit).  A caller who guarantees the array is immutable
    while in use wraps it once (``h = ResidentHandle(A)``) and passes the
    handle in the operand's position of a residency-capable workload's
    ``run()``/``submit()``/``map()``/``pin()`` args: the cached digest
    stands in for the O(bytes) rehash, so warm requests cost O(1) host
    work.  The handle fingerprints identically to the raw array it wraps
    (same cache entry either way).  The wrapped value may be a whole
    pytree — a dict/list of arrays digests leaf-wise in the one
    construction pass, so a weight dict pins in one call — and handles
    may also sit *inside* a pytree operand (unwrap and digest are both
    recursive).  Mutating the wrapped array afterwards is caller-owned
    breakage — the stale digest would serve stale resident data.
    """

    __slots__ = ("value", "digest")

    def __init__(self, value):
        self.value = value
        self.digest = content_digest(value)

    def __repr__(self) -> str:
        return f"ResidentHandle({self.digest[:12]})"


def unwrap_handles(args: tuple) -> tuple:
    """Replace :class:`ResidentHandle` wrappers in an argument tuple with
    the values they wrap (workloads never see the token).  Handles may sit
    at the top level or nested anywhere inside a pytree argument (a dict /
    list of arrays — e.g. a whole weight dict wrapped leaf-wise)."""
    return tuple(tree_map(
        lambda x: x.value if isinstance(x, ResidentHandle) else x, a)
        for a in args)


def fingerprint(workload: str, payload, placement: tuple) -> str:
    """Content fingerprint of a resident operand in a placement.

    Hashes the workload name, the placement spec (``(n_banks, n_ranks,
    total_chunks)``) and each payload item's :func:`content_digest`
    (dtype + shape + raw bytes over its array leaves; a
    :class:`ResidentHandle` contributes its precomputed digest instead of
    rehashing).  Two host arrays with equal contents fingerprint
    identically — wrapped or not; any byte, dtype, shape or placement
    difference yields a new key.
    """
    h = hashlib.sha1()
    h.update(workload.encode())
    h.update(repr(tuple(placement)).encode())
    for item in payload:
        d = (item.digest if isinstance(item, ResidentHandle)
             else content_digest(item))
        h.update(d.encode())
    return h.hexdigest()


class ResidentEntry:
    """One resident operand: per-rank metas + per-chunk device buffers.

    Fill protocol (pipeline/session side, all under :attr:`lock` via the
    helpers here):

    * ``set_rank_meta(r, meta)`` — first writer wins; returns the
      authoritative resident meta for rank ``r`` so concurrent fillers
      converge on one set of device constants.
    * ``store(gidx, bufs, landed)`` / ``get(gidx)`` — per-global-chunk
      device buffers, pushed exactly once (callers check ``get`` under
      :attr:`lock` before scattering).  ``landed`` is the CUDA event
      behind the buffers' copy on the storing stream (None when the copy
      was synchronous); ``landed(gidx)`` hands it to a reader on another
      stream set, which waits on it before its compute reads them.

    ``ready`` flips once every rank meta and every expected chunk buffer
    is present; only ready entries serve warm hits.
    """

    def __init__(self, fp: str, workload: str, nbytes: int,
                 placement: tuple, *, pinned: bool = False):
        self.fingerprint = fp
        self.workload = workload
        self.nbytes = nbytes
        self.placement = placement        # (n_banks, n_ranks, total_chunks)
        self.pinned = pinned
        self.leases = 0                   # in-flight acquire() holds; guarded
                                          # by the *cache* lock, not self.lock
        self.released = False             # evicted/cleared: entry is dead
        self.lock = threading.RLock()
        self.ready = False
        # chunk_resident=False ⇒ the operand lives entirely in the rank
        # metas (BS's broadcast array): no per-chunk buffers expected.
        self.chunk_resident = True
        self.expected_ranks = placement[1]
        self.expected_chunks = 0          # set by the first set_rank_meta
        self._metas: dict[int, Any] = {}
        self._bufs: dict[int, Any] = {}
        self._landed: dict[int, Any] = {}

    def set_rank_meta(self, rank: int, meta, *, n_chunks: int) -> Any:
        """Install rank ``rank``'s resident meta (first writer wins) and
        declare how many chunk buffers this entry expects in total
        (``n_chunks``; 0 for meta-only residency).  Returns the
        authoritative meta."""
        with self.lock:
            if self.released:             # dead entry: caller runs standalone
                return meta
            if rank not in self._metas:
                self._metas[rank] = meta
                self.expected_chunks = n_chunks
                self.chunk_resident = n_chunks > 0
                self._maybe_ready()
            return self._metas[rank]

    def rank_meta(self, rank: int):
        with self.lock:
            return self._metas.get(rank)

    def store(self, gidx: int, bufs, landed=None) -> None:
        with self.lock:
            if self.released or gidx in self._bufs:
                return
            self._bufs[gidx] = bufs
            self._landed[gidx] = landed
            self._maybe_ready()

    def get(self, gidx: int):
        with self.lock:
            return self._bufs.get(gidx)

    def landed(self, gidx: int):
        """The event behind chunk ``gidx``'s stored copy (or None)."""
        with self.lock:
            return self._landed.get(gidx)

    def _maybe_ready(self) -> None:
        if (len(self._metas) == self.expected_ranks
                and len(self._bufs) == self.expected_chunks):
            self.ready = True

    def release(self) -> None:
        """Drop device references (eviction / cache clear).  A released
        entry is dead: fillers' ``store``/``set_rank_meta`` become no-ops,
        so a concurrent fill cannot resurrect buffers the cache no longer
        accounts for."""
        with self.lock:
            self.released = True
            self._metas.clear()
            self._bufs.clear()
            self._landed.clear()
            self.ready = False


class ResidentCache:
    """Fingerprint-keyed LRU of bank-resident operands under a byte budget.

    ``budget_bytes`` models the grid's aggregate MRAM capacity
    (:func:`repro_torch.core.perfmodel.mram_capacity_bytes`).  ``acquire``
    either returns a ready entry (hit), an entry being filled (miss —
    caller scatters into it), or ``None`` when the operand cannot be
    made resident (over budget even after evicting every unpinned,
    unleased entry).  Pinned entries are never evicted; neither are
    *leased* entries — ``acquire`` takes an in-flight lease on every
    entry it returns, and the caller drops it with :meth:`release` once
    the request retires, so eviction can never strip buffers a live
    request's warm-hit placeholders still stand for.  A reservation that
    cannot fit within the unpinned, unleased bytes returns ``(None,
    False)`` without evicting anything.
    """

    def __init__(self, budget_bytes: int, metrics: "Metrics | None" = None):
        self.budget_bytes = int(budget_bytes)
        self._metrics = metrics
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, ResidentEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- bookkeeping --------------------------------------------------------

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "resident_bytes":
                        sum(e.nbytes for e in self._entries.values()),
                    "entries": len(self._entries),
                    "budget_bytes": self.budget_bytes}

    def _inc(self, name: str, n: int = 1) -> None:
        if self._metrics is not None:
            self._metrics.inc(f"cache_{name}", n)

    def _set_gauge(self) -> None:
        if self._metrics is not None:
            self._metrics.set_gauge(
                "cache_resident_bytes",
                sum(e.nbytes for e in self._entries.values()))

    # -- core ---------------------------------------------------------------

    def acquire(self, workload: "ChunkedWorkload", args: tuple,
                placement: tuple, *, pin: bool = False):
        """Look up (or reserve) the resident entry for ``args``' resident
        operand under ``placement``.  Returns ``(entry, hit)``:

        * ``(entry, True)`` — ready entry, serve warm.
        * ``(entry, False)`` — entry reserved/being filled, caller fills.
        * ``(None, False)`` — not cacheable under the budget.

        A returned entry carries one in-flight lease; pair every
        non-``None`` return with a :meth:`release` when the request
        retires.
        """
        payload = tuple(args[i] for i in workload.resident_args)
        fp = fingerprint(workload.name, payload, placement)
        nbytes = tree_nbytes(unwrap_handles(payload))
        with self._lock:
            ent = self._entries.get(fp)
            if ent is not None:
                self._entries.move_to_end(fp)
                ent.leases += 1           # in-flight: not an eviction victim
                if pin:
                    ent.pinned = True
                if ent.ready:
                    self.hits += 1
                    self._inc("hits")
                    return ent, True
                self.misses += 1
                self._inc("misses")
                return ent, False
            self.misses += 1
            self._inc("misses")
            if nbytes > self.budget_bytes:
                return None, False
            resident = sum(e.nbytes for e in self._entries.values())
            if resident + nbytes > self.budget_bytes:
                # fit check before touching anything: when the unpinned,
                # unleased entries cannot cover the shortfall, evicting any
                # of them is pure loss — report uncacheable with the cache
                # intact (and the resident-bytes gauge still truthful)
                evictable = sum(e.nbytes for e in self._entries.values()
                                if not e.pinned and not e.leases)
                if resident - evictable + nbytes > self.budget_bytes:
                    return None, False
                while resident + nbytes > self.budget_bytes:
                    victim = next(k for k, e in self._entries.items()
                                  if not e.pinned and not e.leases)
                    resident -= self._entries[victim].nbytes
                    self._entries.pop(victim).release()
                    self.evictions += 1
                    self._inc("evictions")
            ent = ResidentEntry(fp, workload.name, nbytes, placement,
                                pinned=pin)
            ent.leases = 1
            self._entries[fp] = ent
            self._set_gauge()
            return ent, False

    def release(self, entry: "ResidentEntry | None") -> None:
        """Return one :meth:`acquire` lease (``None``-safe, so callers can
        release unconditionally).  Once every in-flight request holding an
        entry has retired it becomes an eviction candidate again."""
        if entry is None:
            return
        with self._lock:
            if entry.leases > 0:
                entry.leases -= 1

    def lookup(self, fp: str) -> ResidentEntry | None:
        with self._lock:
            return self._entries.get(fp)

    def pin(self, fp: str) -> bool:
        with self._lock:
            ent = self._entries.get(fp)
            if ent is None:
                return False
            ent.pinned = True
            return True

    def unpin(self, fp: str) -> bool:
        with self._lock:
            ent = self._entries.get(fp)
            if ent is None:
                return False
            ent.pinned = False
            return True

    def clear(self) -> None:
        """Release every entry (session close): device buffers return to
        the caching allocator once the last reference is dropped."""
        with self._lock:
            for ent in self._entries.values():
                ent.release()
            self._entries.clear()
            self._set_gauge()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
