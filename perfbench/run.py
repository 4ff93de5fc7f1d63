"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout on a machine with the cell's CUDA cards.
With ``--trace 0`` it prints the cell's end-to-end metrics, with ``--trace
1`` its per-layer metrics from the program's spans and counters and a
``torch.profiler`` slice of the window.  Every run compares the answers
with the plain reference (``perfbench/reference``) once the window has closed;
the numbers compared go to standard error as its last lines, each beside
its limit.  The last line of standard output is the result, one JSON
object.  Without the cards, or with JAX or the JAX package loaded by the
end, it exits non-zero and prints no result."""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def process_start() -> float:
    """This process's start on the ``perf_counter`` clock (from the start
    time the kernel keeps for it; the time of this line where there is
    none)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - started / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, age)


T_PROCESS = process_start()


def set_paths() -> None:
    """The program's package and the harness on the path; every build and
    kernel cache at a fixed place inside the checkout; the program's own
    environment switches cleared, so the cell's files alone decide."""
    for p in (str(BENCH), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    for var in ("REPRO_RANKS", "REPRO_TRACE"):
        os.environ.pop(var, None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_paths()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    import torch
    from harness import runner, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    result = runner.execute(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda:0", T_PROCESS)
    banned = runner.banned_modules()
    if banned:
        print(f"loaded by the end of the run: {banned}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
