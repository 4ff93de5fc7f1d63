"""Quickstart on the PyTorch port: the paper's execution model in 30 lines.

Opens a ``repro_torch.pim`` session (every bank one slice of a device
tensor's leading axis, the ``dpu_alloc`` analogue, DESIGN.md §9) on the
card, runs three PrIM workloads through it, checks each result against
its gold ``ref()``, and prints the runtime's per-request accounting.  The
session picks the execution per workload: chunked pipeline where the
registry allows it, faithful serialized ``pim()`` otherwise.

    PYTHONPATH=src python examples/torch_quickstart.py [--banks 8]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch import pim
from repro_torch.prim import hist, scan, va


def main(banks=None, device=None):
    with pim.session(banks=banks, device=device) as s:
        print(f"bank grid: {s.n_banks} bank(s) on {s.grid.device}")
        rng = np.random.default_rng(0)

        a = rng.integers(0, 100, 1 << 20).astype(np.int32)
        b = rng.integers(0, 100, 1 << 20).astype(np.int32)
        assert (s.run("VA", a, b) == va.ref(a, b)).all()

        x = rng.integers(0, 10, 1 << 20).astype(np.int32)
        assert (s.run("SCAN", x) == scan.ref(x)).all()

        px = rng.integers(0, 256, 1 << 20).astype(np.int32)
        assert (s.run("HST", px, 256) == hist.ref(px, 256)).all()

    for r in s.telemetry.records:
        print(f"{r.workload:5s} {r.n_chunks}-chunk  "
              f"service={r.service_s*1e3:8.2f}ms  "
              f"moved={(r.bytes_in + r.bytes_out)/1e6:6.2f}MB  "
              f"{r.achieved_gbps:.2f} GB/s")
    print("\nall results match the gold references.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--banks", type=int, default=None,
                    help="banks of the session's grid (default 1)")
    ap.add_argument("--device", default=None,
                    help="default cuda:0; cpu when asked")
    args = ap.parse_args()
    main(args.banks, args.device)
