"""PrIM NW — Needleman-Wunsch global sequence alignment (paper §4.10), the
counterpart of ``repro.prim.nw``.

Decomposition: the (m+1)×(n+1) score matrix is tiled into large 2D blocks;
the host iterates over block anti-diagonals; blocks on one diagonal are
distributed across banks; after each diagonal the host retrieves each
block's last row/column and feeds them to the next diagonal (the inter-DPU
pattern that dominates NW in the paper, Key Obs. 16).

Block kernel: the row-sequential dependency is vectorized with the cummax
trick — row[j] = cummax(t[k] + gap·k) − gap·j — so each block row is one
scan along the row, every block of the diagonal at once.  Scores stay
int32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.banked import BankGrid
from .common import PhaseTimer, sync

MATCH, MISMATCH, GAP = 1, -1, 1    # +1 match, -1 mismatch, -1 per gap


def ref(s1: np.ndarray, s2: np.ndarray) -> np.ndarray:
    """Full DP score matrix S[(m+1),(n+1)] (numpy gold)."""
    m, n = len(s1), len(s2)
    S = np.zeros((m + 1, n + 1), np.int32)
    S[0, :] = -GAP * np.arange(n + 1)
    S[:, 0] = -GAP * np.arange(m + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            sub = MATCH if s1[i - 1] == s2[j - 1] else MISMATCH
            S[i, j] = max(S[i - 1, j - 1] + sub,
                          S[i - 1, j] - GAP, S[i, j - 1] - GAP)
    return S


def nw_blocks(top, left, corner, s1b, s2b):
    """Every (Bx, By) DP block of a diagonal given its boundaries, over a
    leading axis of blocks.  top: (blocks, By), left: (blocks, Bx),
    corner: (blocks,) = S[top-left-1, left-1], s1b: (blocks, Bx),
    s2b: (blocks, By).  Returns (blocks, Bx, By) int32."""
    Bx, By = left.shape[1], top.shape[1]
    ramp = GAP * torch.arange(By + 1, dtype=torch.int32, device=top.device)
    prev = torch.cat([corner[:, None], top], dim=1)   # S[i-1, -1..By-1]
    rows = []
    for i in range(Bx):
        lft = left[:, i:i + 1]
        hit = (s1b[:, i:i + 1] == s2b).to(torch.int32)
        sub = hit * (MATCH - MISMATCH) + MISMATCH
        t = torch.maximum(prev[:, :-1] + sub, prev[:, 1:] - GAP)
        u = torch.cat([lft, t], dim=1) + ramp          # (blocks, By+1)
        row = torch.cummax(u, dim=1).values[:, 1:] - ramp[1:]
        rows.append(row)
        prev = torch.cat([lft, row], dim=1)            # S[i, -1..By-1]
    return torch.stack(rows, dim=1)


def pim(grid: BankGrid, s1: np.ndarray, s2: np.ndarray, block: int = 32):
    """Returns the full score matrix (boundaries exchanged via host each
    block-diagonal, per the paper)."""
    t = PhaseTimer()
    m, n = len(s1), len(s2)
    Bx = By = block
    nbx, nby = -(-m // Bx), -(-n // By)
    mp, np_ = nbx * Bx, nby * By
    s1p = np.concatenate([s1, np.full(mp - m, -1, s1.dtype)])
    s2p = np.concatenate([s2, np.full(np_ - n, -2, s2.dtype)])
    S = np.zeros((mp + 1, np_ + 1), np.int32)
    S[0, :] = -GAP * np.arange(np_ + 1)
    S[:, 0] = -GAP * np.arange(mp + 1)

    n_banks = grid.n_banks

    def compute_blocks(tops, lefts, corners, s1bs, s2bs):
        # each bank's blocks are independent: one call over all of them
        flat = [a.reshape(n_banks * a.shape[1], *a.shape[2:])
                for a in (tops, lefts, corners, s1bs, s2bs)]
        return nw_blocks(*flat).reshape(n_banks, -1, Bx, By)

    f = grid.bank_local(compute_blocks)
    for d in range(nbx + nby - 1):
        cells = [(bi, d - bi) for bi in range(max(0, d - nby + 1),
                                              min(nbx, d + 1))]
        per = -(-len(cells) // n_banks)
        padded = cells + [cells[-1]] * (per * n_banks - len(cells))
        with t.phase("inter_dpu"):
            tops = np.stack([S[bi * Bx, bj * By + 1: bj * By + By + 1]
                             for bi, bj in padded])
            lefts = np.stack([S[bi * Bx + 1: bi * Bx + Bx + 1, bj * By]
                              for bi, bj in padded])
            corners = np.array([S[bi * Bx, bj * By] for bi, bj in padded],
                               np.int32)
            s1bs = np.stack([s1p[bi * Bx: bi * Bx + Bx] for bi, bj in padded])
            s2bs = np.stack([s2p[bj * By: bj * By + By] for bi, bj in padded])
            shape = (n_banks, per)
            dev = [sync(grid.to_banks(a.reshape(shape + a.shape[1:])))
                   for a in (tops, lefts, corners, s1bs, s2bs)]
        with t.phase("dpu"):
            blocks = sync(f(*dev))
        with t.phase("dpu_cpu"):
            host_blocks = grid.from_banks(blocks).reshape(
                (-1, Bx, By))[: len(cells)]
        for (bi, bj), blk in zip(cells, host_blocks):
            S[bi * Bx + 1: bi * Bx + Bx + 1,
              bj * By + 1: bj * By + By + 1] = blk
    return S[: m + 1, : n + 1], t.times
