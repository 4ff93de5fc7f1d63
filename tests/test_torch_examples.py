"""The port's user entry points: ``examples/torch_*.py``, each the
counterpart of the reference's script of the same name, and the workload
table of ``python -m repro_torch.prim.registry``.

Each example runs in a subprocess with ``--device cpu`` (all at once),
at the reference script's sizes but for a short run of the train script
(its steps, sequence and batch, the reference's own arguments), exits 0
and prints its closing check line:
quickstart's VA / SCAN / HST against ``ref()``, serve_prim's whole
registry under two tenants through ``entry.compare``, serve_decode's
``DecodeEngine`` tokens equal to ``greedy_generate``, prim_suite's rows
of ``PhaseTimes``, and the train script's ``fit`` with its checkpoints,
then resumed by a second run.  The table has one row per registry entry,
the reference's rows but for the cost-profile column.  No example, no
module of the port and not ``chip_smoke.py`` imports JAX or the
reference.
"""
import ast
import concurrent.futures
import glob
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
#: name -> (arguments, the closing check line)
TRAIN = ["--seq", "32", "--batch", "2"]
EXAMPLES = {
    "torch_quickstart": (["--banks", "8"],
                         "all results match the gold references."),
    "torch_serve_prim": (["--banks", "8", "--no-autotune"],
                         "all results match ref(); serving OK"),
    "torch_serve_decode": (["--banks", "8", "--ranks", "2", "--streams", "2",
                            "--layers", "2", "--prompt-len", "4",
                            "--max-new", "4"],
                           "token-identical to greedy_generate across 2 "
                           "stream(s)"),
    "torch_prim_suite": (["--banks", "8"],
                         "18 rows of PhaseTimes, the 16 workloads and their "
                         "variants: the suite ran"),
    "torch_train_tinyllama": (["--steps", "2", *TRAIN], "checkpoints: [2] in "),
}


def _run(args: list, timeout: float = 300) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def _example(name: str, extra=()) -> subprocess.CompletedProcess:
    return _run([os.path.join(ROOT, "examples", f"{name}.py"),
                 *EXAMPLES[name][0], "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ckpt"))
    with concurrent.futures.ThreadPoolExecutor(len(EXAMPLES)) as pool:
        futs = {name: pool.submit(_example, name,
                                  ["--ckpt-dir", ck]
                                  if name == "torch_train_tinyllama" else [])
                for name in EXAMPLES}
        out = {name: f.result() for name, f in futs.items()}
    # the second run of the script finds step 2's checkpoint and resumes
    out["resumed"] = _run([os.path.join(ROOT, "examples",
                                        "torch_train_tinyllama.py"),
                           "--steps", "3", *TRAIN, "--ckpt-dir", ck,
                           "--device", "cpu"])
    shutil.rmtree(ck)               # two checkpoints of ~1.2 GB each
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_to_its_check_line(runs, name):
    r = runs[name]
    assert r.returncode == 0, r.stderr[-4000:]
    assert EXAMPLES[name][1] in r.stdout, r.stdout[-4000:]


def test_train_example_resumes_from_its_checkpoint(runs):
    r = runs["resumed"]
    assert r.returncode == 0, r.stderr[-4000:]
    assert "[train] resumed from step 2" in r.stdout
    assert "checkpoints: [2, 3] in " in r.stdout
    assert "loss: " in r.stdout and "over 1 steps" in r.stdout


def test_registry_cli_prints_one_row_per_entry():
    from repro.prim.registry import markdown_table
    from repro_torch.prim.registry import REGISTRY

    r = _run(["-m", "repro_torch.prim.registry"], timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 2 + len(REGISTRY) == 18
    assert [ln.split(" | ")[0].strip("| ") for ln in lines[2:]] == \
        list(REGISTRY)
    want = markdown_table().splitlines()
    # the reference's table but for the cost-profile column, which names
    # what the port counts: aten ops where the reference traces a jaxpr
    assert [ln.rsplit(" | ", 1)[0] for ln in lines] == \
        [ln.rsplit(" | ", 1)[0] for ln in want]
    for ln, entry in zip(lines[2:], REGISTRY.values()):
        assert ln.endswith("counted aten ops of the compute phase |"
                           if entry.pipelineable
                           else "— (host-loop, untraced) |")


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


PORT_FILES = sorted(glob.glob(os.path.join(SRC, "repro_torch", "**", "*.py"),
                              recursive=True)
                    + glob.glob(os.path.join(ROOT, "examples", "torch_*.py"))
                    + [os.path.join(ROOT, "chip_smoke.py")])


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_neither_jax_nor_the_reference(path):
    assert not _imports(path) & {"jax", "jaxlib", "repro"}, path


def test_every_reference_example_has_a_port():
    ref = {os.path.basename(p) for p in
           glob.glob(os.path.join(ROOT, "examples", "*.py"))
           if not os.path.basename(p).startswith("torch_")}
    assert {f"torch_{n}" for n in ref} == \
        {f"{n}.py" for n in EXAMPLES}
