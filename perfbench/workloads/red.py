"""RED requests over PrIM's RED input, ``A[i] = rand()`` (the suite's RED
host code, ``read_input``: C's ``rand``, uniform on ``[0, 2**31)`` with
glibc), drawn from the seed: the answer is one 64-bit sum."""
import torch

from harness.pools import IntPool


def values(n: int, dtype, gen, device) -> torch.Tensor:
    return torch.randint(0, 2**31, (n,), generator=gen, device=device,
                         dtype=dtype)


def out_bytes(x) -> int:
    return 8


def make(data: dict, size: int, gen, device, rng, positions: int):
    return IntPool("RED", data, size, gen, device, rng, values, out_bytes,
                   positions)
