"""UNI requests over PrIM's UNI input, ``A[i] = i`` for even ``i`` and
``i + 1`` for odd (the suite's UNI host code, ``read_input``; sorted, in
runs of two; it takes no seed): the answer holds one element a run."""
import torch

from harness.pools import IntPool


def values(n: int, dtype, gen, device) -> torch.Tensor:
    i = torch.arange(n, dtype=dtype, device=device)
    return i + i % 2


def out_bytes(x) -> int:
    runs = 1 + int((x[1:] != x[:-1]).sum()) if len(x) else 0
    return runs * x.element_size()


def make(data: dict, size: int, gen, device, rng, positions: int):
    return IntPool("UNI", data, size, gen, device, rng, values, out_bytes,
                   positions)
