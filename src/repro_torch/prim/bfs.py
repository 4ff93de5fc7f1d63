"""PrIM BFS — Breadth-First Search (paper §4.8), top-down with bit-vector
frontiers; the counterpart of ``repro.prim.bfs``.

Decomposition: vertices (and their neighbor lists, padded-ELL adjacency)
split across banks; each iteration: host broadcasts the current frontier →
banks expand their owned frontier vertices into a local next-frontier
bit-vector → host unions the per-bank next frontiers (the expensive
inter-DPU phase that dominates in the paper, Key Obs. 16) → repeat until
empty.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.banked import BankGrid
from .common import PhaseTimer, pad_chunks, sync


def random_graph(n_vertices: int, avg_deg: int, seed: int = 0):
    """Padded-ELL adjacency: (n, max_deg) neighbor ids, -1 padding."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 2 * avg_deg + 1, size=n_vertices)
    k = int(deg.max())
    adj = np.full((n_vertices, k), -1, np.int32)
    for v in range(n_vertices):
        adj[v, :deg[v]] = rng.choice(n_vertices, size=deg[v], replace=False)
    return adj


def ref(adj: np.ndarray, source: int) -> np.ndarray:
    n = adj.shape[0]
    dist = np.full(n, -1, np.int32)
    dist[source] = 0
    frontier = [source]
    level = 0
    while frontier:
        level += 1
        nxt = set()
        for v in frontier:
            for u in adj[v]:
                if u >= 0 and dist[u] < 0:
                    dist[u] = level
                    nxt.add(int(u))
        frontier = sorted(nxt)
    return dist


def expand(adj_b, frontier, visited, bases):
    """Bank-local frontier expansion.  adj_b: (banks, rows, k) owned rows;
    frontier / visited: (npad,) uint8 global bit-vectors (broadcast);
    bases: (banks,) first owned vertex.  Returns each bank's (banks, npad)
    uint8 next-frontier bit-vector: 1 at every unvisited neighbour of an
    owned frontier vertex."""
    banks, rows, k = adj_b.shape
    npad = frontier.shape[0]
    own = bases[:, None].long() + torch.arange(rows, device=adj_b.device)
    active = frontier[own][:, :, None] > 0             # (banks, rows, 1)
    nbr = adj_b.clamp(min=0).long()
    contrib = (adj_b >= 0) & active & ~(visited[nbr] > 0)
    # a masked set of 1 into the flat (banks * npad) bit-vectors: the
    # other slots go to one spare element past them, which is cut off
    bank = torch.arange(banks, device=adj_b.device)[:, None, None] * npad
    idx = torch.where(contrib, bank + nbr, banks * npad).reshape(-1)
    nxt = torch.zeros(banks * npad + 1, dtype=torch.uint8, device=adj_b.device)
    nxt.index_put_((idx,), torch.ones((), dtype=torch.uint8,
                                      device=adj_b.device))
    return nxt[:-1].view(banks, npad)


def pim(grid: BankGrid, adj: np.ndarray, source: int, max_iters: int = 64):
    t = PhaseTimer()
    n = adj.shape[0]
    n_banks = grid.n_banks
    with t.phase("cpu_dpu"):
        ac, _ = pad_chunks(adj, n_banks, fill=-1)
        rows = ac.shape[1]
        dadj = sync(grid.to_banks(ac))

    npad = rows * n_banks     # bit-vectors padded so every bank's slice exists
    dist = np.full(n, -1, np.int32)
    dist[source] = 0
    visited = np.zeros(npad, np.uint8)
    visited[source] = 1
    frontier = np.zeros(npad, np.uint8)
    frontier[source] = 1

    f_expand = grid.bank_local(expand)
    bases = np.arange(n_banks, dtype=np.int32) * rows

    with t.phase("cpu_dpu"):
        dbases = sync(grid.to_banks(bases))

    level = 0
    for _ in range(max_iters):
        level += 1
        with t.phase("inter_dpu"):
            df = sync(grid.broadcast(frontier))        # frontier broadcast
            dv = sync(grid.broadcast(visited))
        with t.phase("dpu"):
            nxt_parts = sync(f_expand(dadj, df, dv, dbases))
        with t.phase("inter_dpu"):
            parts = grid.from_banks(nxt_parts)         # (banks, npad)
            union = np.bitwise_or.reduce(parts, axis=0)  # host union
            nxt = (union > 0) & (visited == 0)
        if not nxt.any():
            break
        dist[nxt[:n]] = level
        visited[nxt] = 1
        frontier = nxt.astype(np.uint8)
    return dist, t.times
