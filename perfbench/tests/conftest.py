"""CPU tests of the benchmark's harness: ``python -m pytest perfbench/tests``.
They put the harness and the program on the path and cut each cell to a
size the CPU holds (``tiny``); the card's numbers come only from
``perfbench/run.py`` on the chip."""
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)



def tiny(name):
    """Cell ``name`` at a CPU's size: 8 banks (2 ranks of 4 where the
    configuration has ranks), 512 GEMV rows, 65,536 elements an analytics
    request, 64 GEMV vectors.  Widths, traffic and limits stay as they
    are."""
    from harness import spec
    cell = spec.load_cell(name)
    cfg = cell.config
    cfg["layout"] = ({"ranks": 2, "banks_per_rank": 4}
                     if "ranks" in cfg["layout"] else {"banks": 8})
    for k, data in cfg.items():
        if isinstance(data, dict) and "rows" in data:
            data["rows"] = 512
        if isinstance(data, dict) and "elements" in data:
            data["elements"] = 1 << 16
    if "GEMV" in cell.traffic["pool"]:
        cell.traffic["pool"]["GEMV"] = 64
    return cell
