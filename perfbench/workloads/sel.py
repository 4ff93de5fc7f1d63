"""SEL requests over PrIM's SEL input, ``A[i] = i + 1`` (the suite's SEL
host code, ``read_input``; it takes no seed): the answer holds the odd
elements, half of them."""
import torch

from harness.pools import IntPool


def values(n: int, dtype, gen, device) -> torch.Tensor:
    return torch.arange(1, n + 1, dtype=dtype, device=device)


def out_bytes(x) -> int:
    return int((x % 2 != 0).sum()) * x.element_size()


def make(data: dict, size: int, gen, device, rng, positions: int):
    return IntPool("SEL", data, size, gen, device, rng, values, out_bytes,
                   positions)
