"""Sustained multi-request PrIM serving on the port's session façade.

One ``repro_torch.pim.session(autotune=True)`` handle owns the banks on
the card: at open it calibrates the device and installs per-workload
tuned plans (DESIGN.md §8), entering the ``with`` block starts the worker
thread, and producers ``submit()`` a mixed stream of requests drawn from
the FULL workload registry, each with ``RequestOptions`` (tenant +
priority, DESIGN.md §13) across two tenants at a 2:1 fair-share weight,
while earlier requests are still in flight.  The runtime batches
same-workload requests, pipelines their chunks (scatter k+1 overlapping
compute k on CUDA streams), and falls back to the serialized ``pim()``
for the registry's serialized-only workloads (NW, BFS).  Every result is
checked against the workload's gold ``ref()`` with the registry's
comparator.

    PYTHONPATH=src python examples/torch_serve_prim.py [--banks 8]
        [--no-autotune] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import pim


def main(autotune: bool = True, banks=None, device=None):
    rng = np.random.default_rng(0)
    entries = list(pim.registry().values())
    tune = {"reps": 2} if autotune else False
    with pim.session(banks=banks, device=device, autotune=tune,
                     tenants={"gold": 2.0, "free": 1.0}) as s:
        print(f"serving the full {len(entries)}-workload registry on "
              f"{s.n_banks} bank(s) on {s.grid.device} "
              f"({sum(e.pipelineable for e in entries)} pipelined, "
              f"{sum(not e.pipelineable for e in entries)} serialized-only); "
              f"{len(s.plans)} tuned plans installed")
        inflight = []
        for i, entry in enumerate(entries):      # sustained mixed stream:
            for _ in range(2):                   # bursts of 2 same-workload
                args = entry.make_args(rng, scale=1)
                gold = entry.ref(*args)
                opts = pim.RequestOptions(tenant=("gold", "free")[i % 2],
                                          priority=i % 3)
                req = s.submit(entry.name, *args, options=opts)
                inflight.append((req, gold, entry))
        for req, gold, entry in inflight:
            entry.compare(req.result(timeout=600), gold)

    agg = s.stats()
    print(f"{agg['requests']} requests in {agg['wall_s']:.3f}s "
          f"-> {agg['requests_per_s']:.1f} req/s, "
          f"{agg['aggregate_gbps']:.3f} GB/s moved "
          f"({agg['tuned_requests']} served under a tuned plan)")
    print(f"mean queue wait {agg['mean_queue_wait_s'] * 1e3:.1f} ms, "
          f"mean latency {agg['mean_latency_s'] * 1e3:.1f} ms")
    for name in ("gold", "free"):        # per-tenant rows (DESIGN.md §13)
        t = agg["tenants"][name]
        print(f"  tenant {name}: {t['completed']} served at weight "
              f"{t['weight']:g}, mean latency "
              f"{t['mean_latency_s'] * 1e3:.1f} ms")
    by_batch: dict = {}
    for r in s.telemetry.records:
        by_batch.setdefault(r.batch_id, []).append(r)
    print(f"{len(by_batch)} batches "
          "(size-aware same-workload coalescing):")
    serialized_only = {e.name for e in entries if not e.pipelineable}
    for bid in sorted(by_batch):
        rs = by_batch[bid]
        name = rs[0].workload
        if name in serialized_only:
            mode = "serialized"
        else:
            mode = (f"{rs[0].n_chunks}-chunk pipeline"
                    + (" [tuned]" if rs[0].tuned else ""))
        print(f"  batch {bid}: {name:5s} x{len(rs)} "
              f"prio={[r.priority for r in rs]} "
              f"service={sum(r.service_s for r in rs):.3f}s [{mode}]")
    print("all results match ref(); serving OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--banks", type=int, default=None,
                    help="banks of the session's grid (default 1)")
    ap.add_argument("--no-autotune", action="store_true",
                    help="skip calibration; serve with the untuned defaults")
    ap.add_argument("--device", default=None,
                    help="default cuda:0; cpu when asked")
    args = ap.parse_args()
    main(not args.no_autotune, args.banks, args.device)
