"""The full 16-workload PrIM suite on the port, with the paper's phase
breakdown.

The bank grid comes from a ``repro_torch.pim`` session (DESIGN.md §9) on
the card; workloads, variants and argument generation come from the
session's registry view (HST-S / HST-L and SCAN-SSA / SCAN-RSS are
variant entries of their modules: 16 workloads from 14 modules, 18 rows
with the variants).  The
serialized ``pim()`` variants run directly on ``s.grid``: this example
renders the paper's faithful serialized baseline, not the pipelined
runtime.

    PYTHONPATH=src python examples/torch_prim_suite.py [--banks 8]
        [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import pim


def main(banks=None, device=None):
    s = pim.session(banks=banks, device=device)
    rng = np.random.default_rng(0)
    print(f"{'bench':10s} {'cpu_dpu':>9s} {'dpu':>9s} {'inter':>9s} "
          f"{'dpu_cpu':>9s} {'total':>9s}   ({s.n_banks} banks on "
          f"{s.grid.device})")
    rows, entries = 0, pim.registry()
    for entry in entries.values():
        args = entry.make_args(rng, scale=4)
        for label, fn in entry.run_variants().items():
            _, t = fn(s.grid, *args)
            print(f"{label:10s} {t.cpu_dpu*1e3:8.2f}m {t.dpu*1e3:8.2f}m "
                  f"{t.inter_dpu*1e3:8.2f}m {t.dpu_cpu*1e3:8.2f}m "
                  f"{t.total*1e3:8.2f}m")
            rows += 1
    s.close()
    assert len(entries) == 16 and rows == sum(
        len(e.run_variants()) for e in entries.values()), rows
    print(f"{rows} rows of PhaseTimes, the {len(entries)} workloads and "
          f"their variants: the suite ran")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--banks", type=int, default=None,
                    help="banks of the session's grid (default 1)")
    ap.add_argument("--device", default=None,
                    help="default cuda:0; cpu when asked")
    args = ap.parse_args()
    main(args.banks, args.device)
