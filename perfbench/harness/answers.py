"""What a client keeps of each answer, and the exact comparison of kept
answers with the reference's.

Every answer is compared by its shape and at a seeded set of positions
along its leading axis (``Kept.sample``; all of an answer no longer than
the positions are many); a seeded sample of answers is kept
whole (``Kept.full``) and compared whole.  Keeping a few hundred values of
every answer, not every answer, bounds the host memory of a window with
hundreds of 268 MB answers."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Kept:
    j: int                       # the pool input the request carried
    shape: tuple
    sample: np.ndarray           # values at the pool's positions
    full: np.ndarray | None      # the whole answer (the program's own
                                 # array, not a copy), for a seeded few


def positions(length: int, count: int, rng: np.random.Generator) -> np.ndarray:
    """About ``count`` positions in ``[0, length)``, evenly strided from a
    seeded offset."""
    stride = max(1, length // max(1, count))
    return np.arange(int(rng.integers(stride)), length, stride)


def sampled(length: int, pos: np.ndarray) -> np.ndarray:
    """The positions compared in an answer of ``length``: all of a short
    one (no longer than the positions are many), else those that fall
    inside it."""
    return np.arange(length) if length <= len(pos) else pos[pos < length]


def keep(j: int, out, pos: np.ndarray, whole: bool) -> Kept:
    out = np.asarray(out)
    if out.ndim == 0:
        return Kept(j, (), out.reshape(1).copy(), None)
    return Kept(j, out.shape, out[sampled(out.shape[0], pos)].copy(),
                out if whole else None)


def mismatches(kept: list[Kept], refs: dict, pos: np.ndarray) -> int:
    """Answers that differ from ``refs[j]`` in shape, at a sampled position,
    or anywhere when kept whole.  Values compare exactly; dtypes may differ
    (an int32 answer equals an int64 reference of the same values)."""
    bad = 0
    for k in kept:
        ref = np.asarray(refs[k.j])
        if ref.ndim == 0:
            bad += not np.array_equal(k.sample, ref.reshape(1))
            continue
        if k.shape != ref.shape:
            bad += 1
            continue
        if not np.array_equal(k.sample, ref[sampled(ref.shape[0], pos)]):
            bad += 1
            continue
        if k.full is not None and not np.array_equal(k.full, ref):
            bad += 1
    return bad
