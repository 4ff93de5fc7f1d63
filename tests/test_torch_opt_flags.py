"""The reference dry-run's spec levers ``tp1`` and ``dp_all``
(``repro/launch/dryrun.py:60-66, 91-92, 124-131``) on the port's model, in
one launch of 4 gloo processes on the CPU, against the one-process port of
the same seed (whose parity with the reference the family test files
hold).

``transformer.Transformer(tp1=True)`` places the model by the specs the
reference's ``_strip_model_axis`` leaves (``param_specs(cfg, tp1=True)``):
its "model" group is one rank, so the ranks of a "model" axis hold the
"model" dimensions and the experts whole and compute alike; FSDP's "data"
entries stay.  ``dp_all`` is ``tp1`` with the prefill batch split over
the data axes and "model" (``forward(batch_axes=...)``).

- TinyLlama SMOKE, float32, with and without ``fsdp``, ``tp1`` on (2, 2):
  each rank's logits of its data rows within LOGIT_TOL of the one
  process's, greedy tokens equal, parameter bytes a rank the stripped
  specs'; 3 train steps on (2, 2) whose losses equal a (2, 1) run's.
- ``dp_all`` prefill on (2, 2) of a batch of 4 (a row a rank), TinyLlama
  and DeepSeek SMOKE (the MoE's capacity from the whole batch, its count
  table summed over all four ranks): each rank's row against the one
  process's.
- DeepSeek SMOKE under ``tp1`` at capacity factor 0.5 (pairs drop): the
  experts whole on every rank, logits against the one process's; with
  ``moe_ep``, each rank takes its block of the whole experts (the
  reference's ``shard_map`` slices them on "model"): logits against
  ``moe_ep`` without ``tp1`` on the same mesh (the same function: each
  data shard's capacity and aux) and 3 train steps' losses against it;
  and its logits, loss and every gradient leaf against the reference's
  own ``transformer.forward`` / ``loss_fn`` (its ``apply_ep``) on the
  specs its dry-run's ``tp1`` leaves, on a (2, 2) mesh of 4 forced host
  devices in a subprocess that runs beside the ranks, the weights the
  port's seeded draw carried across (``convert``).
- ``dp_all`` with ``moe_ep``, refused by name.
"""
import concurrent.futures
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import sharding
from repro_torch.data import DataConfig, make_batch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve, train
from repro_torch.models import convert, transformer
from repro_torch.runtime import elastic

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
LOGIT_TOL, LOSS_TOL = 1e-5, 1e-5
#: against the reference's XLA on the CPU: logits (absolute) and each
#: gradient leaf (relative to its largest |g|), as tests/test_torch_fsdp.py
REF_TOL = 1e-4
BATCH, SEQ, STEPS = 4, 16, 3
PROMPT, NEW = (2, 6), 4
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
TINY, DEEP = "tinyllama-1.1b", "deepseek-moe-16b"
#: (arch, fsdp, moe_ep) of the tp1 logits cases on (2, 2)
TP1 = [(TINY, False, False), (TINY, True, False), (DEEP, False, False),
       (DEEP, True, False), (DEEP, False, True)]
#: the tp1 train cases: (2, 2) against (2, 1), or, with moe_ep, against
#: moe_ep without tp1 on (2, 2)
STEPPED = [(TINY, False, False), (TINY, True, False), (DEEP, False, True)]
DP_ALL = [TINY, DEEP]
#: the tp1 case held to the reference's apply_ep on the stripped specs
REF_CASE = (DEEP, False, True)

# the reference's DeepSeek SMOKE with moe_ep at capacity factor 0.5 on a
# (2, 2) mesh, its weights placed by the specs its dry-run's tp1 leaves
# (``_strip_model_axis``, repro/launch/dryrun.py:60-66, whose rule is
# copied here: importing that module forces 512 host devices); the batch
# split over "data"; argv: src, the weights and batch in, the results out
REF_TP1_EP = r"""
import dataclasses, pickle, sys; sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core.compat import set_mesh
from repro.models import transformer
from repro.runtime.elastic import carve_mesh
with open(sys.argv[2], "rb") as f:
    src = pickle.load(f)
cfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                          dtype=jnp.float32, moe_ep=True,
                          moe_capacity_factor=0.5)
box = {}
def init(k):
    p, box["specs"] = transformer.init(k, cfg)
    return p
jax.eval_shape(init, jax.random.PRNGKey(0))
strip = lambda s: P(*(None if e == "model" else e for e in s))
specs = jax.tree.map(strip, box["specs"], is_leaf=lambda s: isinstance(s, P))
mesh = carve_mesh(jax.devices(), model_parallel=2)      # (data 2, model 2)
params = jax.tree.map(
    lambda a, s: jax.device_put(jnp.asarray(a), NamedSharding(mesh, s)),
    src["params"], specs)
rows = NamedSharding(mesh, P("data"))
batch = {k: jax.device_put(jnp.asarray(v), rows)
         for k, v in src["batch"].items()}
with set_mesh(mesh):
    logits = jax.jit(lambda p, t: transformer.forward(p, cfg, t)[0])(
        params, batch["tokens"])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: transformer.loss_fn(p, cfg, b)[0]))(params, batch)
with open(sys.argv[3], "wb") as f:
    pickle.dump({"logits": np.asarray(logits), "loss": float(loss),
                 "grads": jax.tree.map(np.asarray, grads)}, f)
"""


def cfg_of(arch: str, fsdp: bool = False, ep: bool = False):
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype=torch.float32, fsdp=fsdp, moe_ep=ep,
                               moe_capacity_factor=0.5)


def batch_of(cfg, step: int = 0) -> dict:
    return make_batch(cfg, DataConfig(batch=BATCH, seq=SEQ), step)


def _logits(model, cfg, batch, **kw):
    inputs = train.to_device(batch, cfg, "cpu")
    del inputs["labels"]
    with torch.no_grad():
        return transformer.forward(model, cfg, **inputs, **kw)[0]


def _losses(cfg, mesh, tp1: bool) -> list:
    model = transformer.init(cfg, seed=5, device="cpu", mesh=mesh, tp1=tp1)
    model.requires_grad_(True)
    state = optim.init(dict(model.named_parameters()))
    step = train.make_train_step(cfg, optim.AdamWConfig(**OCFG), mesh)
    out = []
    for i in range(STEPS):
        b = train.shard_batch(batch_of(cfg, i), cfg, mesh, "cpu")
        _, state, m = step(model, state, b)
        out.append(float(m["loss"]))
    return out


def _opt_rank(rank: int) -> dict:
    """Every case on this rank; every rank builds every mesh in the same
    order."""
    m22 = elastic.carve_mesh(model_parallel=2, device_type="cpu")
    m21 = elastic.carve_mesh([0, 1], 1, device_type="cpu")
    out = {"index": {a: m22.get_local_rank(a) for a in ("data", "model")}}
    for arch, fsdp, ep in TP1:
        cfg = cfg_of(arch, fsdp, ep)
        model = transformer.init(cfg, seed=5, device="cpu", mesh=m22,
                                 tp1=True)
        b = batch_of(cfg)
        got = {"logits": _logits(model, cfg, {k: v[train.rows(BATCH, m22)]
                                              for k, v in b.items()}),
               "bytes": sum(p.numel() * p.element_size()
                            for p in model.parameters()),
               "sharded": {k: lay.axes for k, lay in
                           transformer.sharded_leaves(model).items()}}
        if ep:
            plain = transformer.init(cfg, seed=5, device="cpu", mesh=m22)
            got["ep"] = _logits(plain, cfg, {k: v[train.rows(BATCH, m22)]
                                             for k, v in b.items()})
        if (arch, fsdp, ep) == REF_CASE:
            model.requires_grad_(True)
            loss, g = train.make_grads(cfg, m22)(
                model, train.shard_batch(b, cfg, m22, "cpu"))
            model.requires_grad_(False)
            got["loss"] = float(loss)
            got["grads"] = {k: v.numpy() for k, v in g.items()}
        if arch == TINY:
            prompt = np.random.default_rng(7).integers(
                0, cfg.vocab, PROMPT).astype(np.int32)
            got["tokens"] = serve.greedy_generate(model, cfg, prompt, NEW)
        out[("tp1", arch, fsdp, ep)] = got
    for arch, fsdp, ep in STEPPED:
        cfg = cfg_of(arch, fsdp, ep)
        got = {"tp1": _losses(cfg, m22, True)}
        if ep:
            got["want"] = _losses(cfg, m22, False)
        elif sharding.member(m21):
            got["want"] = _losses(cfg, m21, False)
        out[("steps", arch, fsdp, ep)] = got
    axes = ("data", "model")
    for arch in DP_ALL:
        cfg = cfg_of(arch)
        model = transformer.init(cfg, seed=5, device="cpu", mesh=m22,
                                 tp1=True)
        b = batch_of(cfg)
        r = train.rows(BATCH, m22, axes)
        out[("dp_all", arch)] = {"rows": r, "logits": _logits(
            model, cfg, {k: v[r] for k, v in b.items()}, batch_axes=axes)}
    cfg = cfg_of(DEEP, ep=True)
    model = transformer.init(cfg, seed=5, device="cpu", mesh=m22, tp1=True)
    try:
        _logits(model, cfg, {k: v[:1] for k, v in batch_of(cfg).items()},
                batch_axes=axes)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    return out


@pytest.fixture(scope="module")
def reference_job(tmp_path_factory) -> concurrent.futures.Future:
    """REF_TP1_EP in a subprocess, started before the ranks so that the
    two run together -> its logits, loss and gradients (by the port's
    parameter names)."""
    d = tmp_path_factory.mktemp("opt_flags_ref")
    cfg = cfg_of(DEEP)
    with open(d / "in.pkl", "wb") as f:
        pickle.dump({"params": convert.params_to_reference(
            transformer.init(cfg, seed=5, device="cpu"), cfg),
            "batch": batch_of(cfg)}, f)

    def go() -> dict:
        child = subprocess.run(
            [sys.executable, "-c", REF_TP1_EP, SRC, str(d / "in.pkl"),
             str(d / "out.pkl")], capture_output=True, text=True,
            timeout=300, env=dict(
                os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4"))
        assert child.returncode == 0, child.stderr[-3000:]
        with open(d / "out.pkl", "rb") as f:
            out = pickle.load(f)
        out["grads"] = {k: np.asarray(v) for k, v in
                        convert.from_reference_tree(out["grads"], cfg).items()}
        return out
    return concurrent.futures.ThreadPoolExecutor(1).submit(go)


@pytest.fixture(scope="module")
def run(reference_job, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("opt_flags"))
    return tmesh.spawn(_opt_rank, 4, timeout=300, workdir=d)


@pytest.fixture(scope="module")
def reference(reference_job):
    return reference_job.result()


@pytest.fixture(scope="module")
def one():
    """The one-process port's logits and tokens of each case."""
    out = {}
    for arch, fsdp, ep in TP1 + [(a, False, False) for a in DP_ALL]:
        if ep:                          # held to moe_ep on the mesh
            continue
        cfg = cfg_of(arch, fsdp, ep)
        model = transformer.init(cfg, seed=5, device="cpu")
        out[arch, fsdp, ep] = _logits(model, cfg, batch_of(cfg))
        if arch == TINY:
            prompt = np.random.default_rng(7).integers(
                0, cfg.vocab, PROMPT).astype(np.int32)
            out["tokens", fsdp] = serve.greedy_generate(model, cfg, prompt,
                                                        NEW)
    return out


def stripped_bytes(cfg, dims: dict) -> int:
    """The bytes a device holds of the specs the reference's ``tp1``
    leaves: each leaf over the sizes of the axes its stripped spec
    names."""
    whole = transformer.Transformer(dataclasses.replace(cfg, moe_ep=False),
                                    device="meta")
    specs = transformer.param_specs(cfg, tp1=True)
    total = 0
    for name, p in whole.named_parameters():
        n = 1
        for e in specs[name]:
            n *= 1 if e is None else sharding.axis_size(dims, e)
        total += p.numel() * p.element_size() // n
    return total


@pytest.mark.parametrize("case", TP1, ids=lambda c: "-".join(map(str, c)))
def test_tp1_logits_are_one_process_rows(run, one, case):
    arch, fsdp, ep = case
    cfg = cfg_of(arch, fsdp, ep)
    specs = transformer.param_specs(cfg, tp1=True)
    fsdp_leaves = {k for k, s in specs.items() if "data" in s}
    assert bool(fsdp_leaves) == fsdp
    for o in run:
        got = o[("tp1",) + case]
        r = slice(o["index"]["data"] * 2, o["index"]["data"] * 2 + 2)
        # the rank holds every "model" dimension whole, FSDP's blocks apart
        assert got["bytes"] == stripped_bytes(cfg, {"data": 2, "model": 2})
        assert got["sharded"] == dict.fromkeys(fsdp_leaves, ("data",))
        if ep:
            # the same function as moe_ep without tp1 (each data shard's
            # capacity and aux), the experts taken as blocks of the whole
            torch.testing.assert_close(got["logits"], got["ep"], rtol=0,
                                       atol=LOGIT_TOL)
        else:
            torch.testing.assert_close(got["logits"], one[case][r], rtol=0,
                                       atol=LOGIT_TOL)


@pytest.mark.parametrize("fsdp", [False, True])
def test_tp1_greedy_tokens_equal_one_process(run, one, fsdp):
    for o in run:
        i = o["index"]["data"]
        assert torch.equal(o[("tp1", TINY, fsdp, False)]["tokens"],
                           one["tokens", fsdp][i:i + 1])


@pytest.mark.parametrize("case", STEPPED, ids=lambda c: "-".join(map(str, c)))
def test_tp1_train_losses_equal_the_plain_run(run, case):
    """TinyLlama: (2, 2) under tp1 against (2, 1), the model replicas
    computing what the (2, 1) ranks compute; DeepSeek with moe_ep against
    moe_ep without tp1 on (2, 2) (each rank's gradient of its block of
    the whole experts summed over "model")."""
    for o in run:
        got = o[("steps",) + case]
        assert len(got["tp1"]) == STEPS
        if "want" in got:
            np.testing.assert_allclose(got["tp1"], got["want"], rtol=LOSS_TOL,
                                       atol=0)
    assert sum("want" in o[("steps",) + case] for o in run) >= 2
    losses = {tuple(o[("steps",) + case]["tp1"]) for o in run}
    assert len(losses) == 1                     # every rank's global loss


@pytest.mark.parametrize("arch", DP_ALL)
def test_dp_all_prefill_rows_are_one_process_rows(run, one, arch):
    rows = []
    for o in run:
        got = o[("dp_all", arch)]
        r = got["rows"]
        assert r.stop - r.start == 1
        rows.append(r.start)
        torch.testing.assert_close(got["logits"], one[arch, False, False][r],
                                   rtol=0, atol=LOGIT_TOL)
    # (data, model) rank (i, j) takes row 2 i + j: the reference's
    # P(("data", "model"), ...)
    assert rows == [2 * o["index"]["data"] + o["index"]["model"]
                    for o in run] and sorted(rows) == [0, 1, 2, 3]


def test_dp_all_refuses_moe_ep(run):
    for o in run:
        assert o["refused"] and "moe_ep" in o["refused"] and \
            "dp_all" in o["refused"]


@pytest.mark.parametrize("part", ["logits", "loss", "grads"])
def test_tp1_moe_ep_equals_reference_apply_ep(run, reference, part):
    """DeepSeek SMOKE, moe_ep at capacity factor 0.5, tp1 on (2, 2): each
    rank's logits of its data rows, the loss of the global batch and
    every gradient leaf (whole on each rank) against the reference's
    ``forward`` / ``jax.value_and_grad(loss_fn)`` through its
    ``apply_ep``, whose ``shard_map`` slices the replicated experts on
    "model"; logits at REF_TOL, the loss at LOSS_TOL, each leaf at
    REF_TOL of its largest |g|."""
    for o in run:
        got = o[("tp1",) + REF_CASE]
        if part == "logits":
            i = o["index"]["data"]
            np.testing.assert_allclose(
                got["logits"].numpy(), reference["logits"][2 * i:2 * i + 2],
                rtol=0, atol=REF_TOL)
        elif part == "loss":
            assert abs(got["loss"] - reference["loss"]) <= LOSS_TOL
        else:
            assert set(got["grads"]) == set(reference["grads"])
            for k, w in reference["grads"].items():
                g = got["grads"][k]
                assert g.shape == w.shape, k
                scale = np.abs(w).max()
                assert scale and np.abs(g - w).max() <= REF_TOL * scale, k
