"""SCAN requests over PrIM's SCAN-SSA input, ``A[i] = rand()`` (the
suite's SCAN-SSA host code, ``read_input``), drawn from the seed: the
answer is as long as the input, in its type."""
import torch

from harness.pools import IntPool


def values(n: int, dtype, gen, device) -> torch.Tensor:
    return torch.randint(0, 2**31, (n,), generator=gen, device=device,
                         dtype=dtype)


def out_bytes(x) -> int:
    return x.numel() * x.element_size()


def make(data: dict, size: int, gen, device, rng, positions: int):
    return IntPool("SCAN", data, size, gen, device, rng, values, out_bytes,
                   positions)
