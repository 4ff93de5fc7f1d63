"""The control of a cell's comparison: the plain reference, computed at the
precision below the configuration's, put in the program's place.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 10

GEMV's control is the product at TF32 (float32 with TF32 off is the
configuration's); the integer workloads' is the reference over 32-bit
integers (the configuration's are int64).
Each seed runs the cell's traffic for ``--seconds`` with the control
answering, compares as a benchmark run does, and prints one JSON line of
the numbers compared.  The control has to come out not correct.  The
benchmark's own runs never run this."""
from __future__ import annotations

import argparse
import json
import sys

import run


class Done:
    """A request already answered."""

    record = None

    def __init__(self, value):
        self.value = value

    def result(self, timeout=None):
        return self.value


class Control:
    """The program's place, taken by the reference's control."""

    def __init__(self, config: dict, trace: bool, device, pools: dict):
        self.device, self.pools = device, pools

    def pin(self, name: str, args: tuple, positions: tuple) -> None:
        pass

    def call(self, name: str, j: int, args: tuple) -> Done:
        return Done(self.pools[name].control(j, self.device))

    def spans(self) -> list:
        return []

    def close(self) -> None:
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    run.set_paths()
    from harness import runner, spec

    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = runner.execute(cell, seed, args.seconds, False, args.device,
                             run.T_PROCESS, open_program=Control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
