"""GEMV requests: a shared float32 matrix and a fresh vector each."""
from harness.pools import GemvPool


def make(data: dict, size: int, gen, device, rng, positions: int):
    return GemvPool("GEMV", data, size, gen, device, rng, positions)
