"""PrIM TS — Time Series Analysis / Matrix Profile (paper §4.7), the
counterpart of ``repro.prim.ts``.

Decomposition: the series is split across banks **with query-length halo
overlap** (the paper: "adding the necessary overlapping"); the query is
replicated; each bank computes z-normalized Euclidean distances for its
slice's subsequence alignments and keeps a local (min, argmin); the host
merges per-bank minima (tiny inter-DPU phase).  Standard deviations are the
population's (``correction=0``), as ``jnp.std``'s; ``torch.argmin`` keeps
the first minimum, as ``jnp.argmin`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.banked import BankGrid
from .common import ChunkedWorkload, PhaseTimer, register_chunked, sync

#: windows of the host's ``ref`` evaluated at once (~32 MB a float32 block)
REF_BLOCK = 1 << 17


def _znorm_np(win: np.ndarray, q: np.ndarray) -> np.ndarray:
    mu = win.mean(axis=1, keepdims=True)
    sd = win.std(axis=1, keepdims=True) + np.float32(1e-12)
    wz = (win - mu) / sd
    return np.sqrt(np.sum((wz - q[None, :]) ** 2, axis=1))


def ref(series: np.ndarray, query: np.ndarray) -> tuple[float, int]:
    """The distances of every window, in blocks of ``REF_BLOCK`` windows so
    the host never holds the whole (windows, m) array; first minimum."""
    series, query = np.asarray(series), np.asarray(query)
    q = (query - query.mean()) / (query.std() + np.float32(1e-12))
    wins = np.lib.stride_tricks.sliding_window_view(series, len(query))
    best, best_idx = np.inf, 0
    for s in range(0, wins.shape[0], REF_BLOCK):
        d = _znorm_np(wins[s:s + REF_BLOCK], q)
        i = int(d.argmin())
        if d[i] < best:
            best, best_idx = d[i], s + i
    return float(best), best_idx


def _znorm_dists(sb: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Distance of the z-normed query to every z-normed window of each
    bank's row: (banks, L) series -> (banks, L - m + 1)."""
    m = query.shape[0]
    q = (query - query.mean()) / (query.std(correction=0) + 1e-12)
    win = sb.unfold(1, m, 1)                           # (banks, n_win, m)
    mu = win.mean(dim=2, keepdim=True)
    sd = win.std(dim=2, keepdim=True, correction=0) + 1e-12
    wz = (win - mu) / sd
    return torch.sqrt(torch.sum((wz - q) ** 2, dim=2))


def _local(sb, qb):
    """Each bank's (min, first argmin); windows reaching into the inf
    padding give nan and count as inf."""
    d = _znorm_dists(sb, qb)
    d = torch.where(torch.isnan(d), torch.inf, d)
    i = torch.argmin(d, dim=1)
    return d.gather(1, i[:, None])[:, 0], i.to(torch.int32)


def pim(grid: BankGrid, series: np.ndarray, query: np.ndarray):
    t = PhaseTimer()
    n_banks = grid.n_banks
    m = len(query)
    with t.phase("cpu_dpu"):
        n = len(series)
        per = -(-n // n_banks)
        # halo: each bank also needs the next m-1 elements
        chunks = np.stack(_halo_chunks(np.asarray(series), n_banks, per,
                                       m - 1, np.inf))
        ds = sync(grid.to_banks(chunks))
        dq = sync(grid.broadcast(np.asarray(query)))

    f = grid.bank_local(_local)
    with t.phase("dpu"):
        dmin, darg = sync(f(ds, dq))
    with t.phase("dpu_cpu"):
        mins = grid.from_banks(dmin).reshape(-1)
        args = grid.from_banks(darg).reshape(-1)
    with t.phase("inter_dpu"):
        b = int(np.argmin(mins))
        result = (float(mins[b]), int(b * per + args[b]))
    return result, t.times


# -- chunked phases (pipelined runtime) --------------------------------------
# The series splits into chunks with the same query-length halo the paper
# adds per DPU (scatter re-applies it per bank inside the chunk); each chunk
# retrieves one (min, local argmin) and merge keeps the first global minimum
# in series order, matching np.argmin tie-breaking.  Halo/tail padding is
# inf, whose windows z-normalize to nan and are masked to inf like pim().

def _halo_chunks(x, n_pieces, per, halo, fill):
    padded = np.concatenate(
        [x, np.full(per * n_pieces + halo - len(x), fill, x.dtype)])
    return [padded[i * per: i * per + per + halo] for i in range(n_pieces)]


def _split(grid, n_chunks, series, query):
    series, query = np.asarray(series), np.asarray(query)
    m = len(query)
    per = -(-len(series) // n_chunks)
    chunks = _halo_chunks(series, n_chunks, per, m - 1, np.inf)
    meta = {"m": m, "per": per, "dq": grid.broadcast(query)}
    return meta, chunks


def _scatter(grid, meta, chunk):
    per_b = -(-meta["per"] // grid.n_banks)
    rows = _halo_chunks(chunk, grid.n_banks, per_b, meta["m"] - 1, np.inf)
    return grid.to_banks(np.stack(rows))


def _compute(grid, meta, ds):
    return grid.bank_local(_local)(ds, meta["dq"])


def _retrieve(grid, meta, outs):
    dmin, darg = outs
    mins = grid.from_banks(dmin).reshape(-1)
    args = grid.from_banks(darg).reshape(-1)
    per_b = -(-meta["per"] // grid.n_banks)
    b = int(np.argmin(mins))
    return float(mins[b]), int(b * per_b + args[b])


def _merge(grid, meta, parts):
    best, best_idx = np.inf, 0
    for k, (mn, arg) in enumerate(parts):
        if mn < best:
            best, best_idx = mn, k * meta["per"] + arg
    return best, best_idx


chunked = register_chunked(ChunkedWorkload(
    "TS", _split, _scatter, _compute, _retrieve, _merge))
