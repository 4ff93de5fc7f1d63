"""Port parity of data-parallel and expert-parallel training
(``launch.train`` on a mesh, ``optim.psum_compressed`` over a group) and
elastic restart, against ``repro``, in 4 gloo processes on the CPU.

One launch of 4 ranks runs every case (``launch.mesh.spawn``); the
reference runs in this process (one device) and, for ``psum_compressed``
under ``shard_map``, in a subprocess on 4 forced host devices.

- ``psum_compressed`` of each rank's own gradients over the (4, 1) mesh's
  "data" group against the reference's over 4 devices: equal.
- ``make_train_step`` on (4, 1), each rank 1 row of the global 4 x 16
  batch (tinyllama SMOKE), plain and with ``compress_grads``, against the
  reference's step on the global batch: the loss at 1e-5, the gradients
  (before the step) at 1e-5 of each leaf's largest |g|, the gradient norm
  at 1e-5 relative plain and COMPRESSED_NORM compressed, the learning
  rate exactly, the parameters at the reference's 5e-3.  Compressed, the
  port sums 4 ranks' int8 levels, each within half a level of its own
  gradient, where the reference's step on the global batch quantizes the
  one reduced gradient.
- DeepSeek SMOKE without ``moe_ep`` at capacity factor 0.5 on (4, 1):
  the loss and gradients of the global batch against the reference's
  ``jax.value_and_grad`` (pairs drop; each rank routes its row as part of
  the whole batch, its capacity, ranks and aux those of all 4 rows), at
  MOE_TOL of each leaf's largest |g|, the single-device test's
  (tests/test_torch_train.py).
- ``fit`` on (4, 1) for 4 steps, uninterrupted; again with a checkpoint
  at step 2, then ``simulate_failure(n_lost=2)``: the (2, 1) mesh
  restores and finishes, its losses equal to the uninterrupted ones at
  1e-5, and those equal to the one-process ``fit`` at 1e-5.
- DeepSeek SMOKE with ``moe_ep`` on (2, 2), 2 steps of ``fit`` with a
  checkpoint: the reference's ``Checkpointer`` restores it with every
  expert whole (each rank's slice where it belongs), and the reference's
  ``fit`` resumes from it.
"""
import concurrent.futures
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core import sharding
from repro_torch.data import DataConfig, Loader
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.runtime import elastic

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ARCH, EP_ARCH = "tinyllama-1.1b", "deepseek-moe-16b"
BATCH, SEQ, STEPS = 4, 16, 4
PARAM_TOL, GRAD_TOL, MOE_TOL = 5e-3, 1e-5, 1e-4
#: the compressed step's gradient norm against the reference's, relative
COMPRESSED_NORM = 1e-3
OCFG = dict(lr=1e-3, warmup_steps=0, total_steps=10)
FIT_OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS)

REF_PSUM = r"""
import sys; sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.compat import shard_map
from repro.optim import psum_compressed
src = dict(np.load(sys.argv[2]))
mesh = jax.make_mesh((4,), ("data",))
f = shard_map(lambda t: jax.tree.map(lambda a: a[None], psum_compressed(
    jax.tree.map(lambda a: a[0], t), "data")), mesh=mesh,
    in_specs=P("data"), out_specs=P("data"))
tree = {k: jnp.asarray(v) for k, v in src.items()}
tree["b"] = tree["b"].astype(jnp.bfloat16)
out = jax.jit(f)(tree)
np.savez(sys.argv[3], **{k: np.asarray(v.astype(jnp.float32))
                         for k, v in out.items()})
"""


def _psum_inputs():
    rng = np.random.default_rng(7)
    return {"a": rng.normal(size=(4, 33, 7)).astype(np.float32) * 3,
            "b": rng.normal(size=(4, 16)).astype(np.float32),
            "z": np.zeros((4, 5), np.float32)}


# -- the ranks ------------------------------------------------------------------------

def _step_case(mesh, ref: dict, compress: bool) -> dict:
    cfg = get_config(ARCH, smoke=True)
    model = convert.params_from_reference(ref["params"], cfg, device="cpu",
                                          mesh=mesh)
    model.requires_grad_(True)
    opt = convert.opt_state_from_reference(ref["opt"], cfg, device="cpu",
                                           model=model)
    b = train.shard_batch(ref["batch"], cfg, mesh, "cpu")
    out = {}
    if not compress:
        _, g = train.make_grads(cfg, mesh)(model, b)
        out["grads"] = {k: v.numpy() for k, v in g.items()}
    step = train.make_train_step(cfg, optim.AdamWConfig(**OCFG), mesh,
                                 compress_grads=compress)
    model, opt, m = step(model, opt, b)
    out |= {k: float(v) for k, v in m.items()}
    out["params"] = convert.params_to_reference(model, cfg)
    return out


def _moe_dp_case(mesh, ref: dict) -> dict:
    cfg = dataclasses.replace(get_config(EP_ARCH, smoke=True),
                              moe_capacity_factor=0.5)
    model = convert.params_from_reference(ref["moe_params"], cfg,
                                          device="cpu", mesh=mesh)
    model.requires_grad_(True)
    b = train.shard_batch(ref["moe_batch"], cfg, mesh, "cpu")
    loss, g = train.make_grads(cfg, mesh)(model, b)
    return {"loss": float(loss), "grads": {k: v.numpy() for k, v in g.items()}}


def _fit(cfg, mesh, steps, ck=None, every=0):
    return train.fit(cfg, steps=steps, data_loader=Loader(
        cfg, DataConfig(batch=BATCH, seq=SEQ)),
        ocfg=optim.AdamWConfig(**FIT_OCFG), checkpointer=ck,
        checkpoint_every=every, log_every=0, device="cpu", mesh=mesh)


def _train_rank(rank: int, ref: dict, ckdir: str) -> dict:
    """Every case on this rank, the meshes built on every rank in the
    same order (their groups are made on the whole world)."""
    m4 = elastic.carve_mesh(model_parallel=1, device_type="cpu")
    out = {"psum": optim.psum_compressed(
        {"a": torch.from_numpy(ref["psum"]["a"][rank]),
         "b": torch.from_numpy(ref["psum"]["b"][rank]).to(torch.bfloat16),
         "z": torch.from_numpy(ref["psum"]["z"][rank]), "none": None},
        m4.get_group("data"))}
    for compress in (False, True):
        out[compress] = _step_case(m4, ref, compress)
    out["moe_dp"] = _moe_dp_case(m4, ref)
    cfg = get_config(ARCH, smoke=True)
    out["whole"] = _fit(cfg, m4, STEPS)[2]
    ck = os.path.join(ckdir, "dp")
    out["first"] = _fit(cfg, m4, STEPS // 2, Checkpointer(ck), STEPS // 2)[2]
    m2 = elastic.simulate_failure(m4, n_lost=2, model_parallel=1)
    out["m2"] = dict(zip(m2.mesh_dim_names, m2.shape))
    if sharding.member(m2):
        out["resumed"] = _fit(cfg, m2, STEPS, Checkpointer(ck))[2]
    ep = elastic.carve_mesh(model_parallel=2, device_type="cpu")
    ecfg = dataclasses.replace(get_config(EP_ARCH, smoke=True), moe_ep=True)
    model, opt, out["ep_hist"] = _fit(ecfg, ep, 2,
                                      Checkpointer(os.path.join(ckdir, "ep")),
                                      2)
    moe = model.layers[1].ffn
    out["ep"] = {"experts": (moe.experts.start, moe.experts.stop),
                 "wi": [model.layers[i].ffn.wi.detach().numpy()
                        for i in (1, 2)],
                 "mu": [opt["mu"][f"layers.{i}.ffn.wo"].numpy()
                        for i in (1, 2)]}
    return out


# -- the reference and the run ------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    from repro import optim as joptim
    from repro.configs import get_config as jget
    from repro.launch import train as jtrain
    from repro.models import transformer as jtr
    from repro.runtime.elastic import carve_mesh as jcarve
    from repro_torch.data import make_batch

    d = tmp_path_factory.mktemp("train_mesh")
    psum_in = _psum_inputs()
    np.savez(d / "psum.npz", **psum_in)
    child = subprocess.Popen(
        [sys.executable, "-c", REF_PSUM, SRC, str(d / "psum.npz"),
         str(d / "ref_psum.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"))

    jcfg, cfg = jget(ARCH, smoke=True), get_config(ARCH, smoke=True)
    m1 = jcarve(jax.devices()[:1])
    jparams, jopt, specs = jtrain.init_state(jax.random.PRNGKey(0), jcfg, m1)
    batch = make_batch(cfg, DataConfig(batch=BATCH, seq=SEQ), 0)
    mcfg = dataclasses.replace(jget(EP_ARCH, smoke=True),
                               moe_capacity_factor=0.5)
    mparams = jax.jit(lambda k: jtr.init(k, mcfg)[0])(jax.random.PRNGKey(1))
    mbatch = make_batch(get_config(EP_ARCH, smoke=True),
                        DataConfig(batch=BATCH, seq=SEQ), 0)
    ref = {"psum": psum_in, "batch": batch,
           "params": jax.tree.map(np.asarray, jparams),
           "opt": jax.tree.map(np.asarray, jopt),
           "moe_params": jax.tree.map(np.asarray, mparams),
           "moe_batch": mbatch}
    ranks = concurrent.futures.ThreadPoolExecutor(1).submit(
        tmesh.spawn, _train_rank, 4, ref, str(d), timeout=300)

    want = {}
    jb = jtrain.shard_batch(batch, jcfg, m1)
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: jtr.loss_fn(p, jcfg, jb), has_aux=True))(jparams)
    want["grads"] = convert.from_reference_tree(
        jax.tree.map(np.asarray, g), cfg)
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: jtr.loss_fn(p, mcfg, jtrain.shard_batch(mbatch, mcfg, m1)),
        has_aux=True))(mparams)
    want["moe_dp"] = {"loss": float(loss), "grads": convert.from_reference_tree(
        jax.tree.map(np.asarray, g), get_config(EP_ARCH, smoke=True))}
    for compress in (False, True):
        jo = joptim.AdamWConfig(**OCFG)
        step = jtrain.make_train_step(jcfg, jo, m1, specs,
                                      compress_grads=compress, donate=False)
        jp, _, jm = step(jparams, jopt, jb)
        want[compress] = {"params": jax.tree.map(np.asarray, jp),
                          **{k: float(v) for k, v in jm.items()}}
    want["one"] = train.fit(cfg, steps=STEPS, data_loader=Loader(
        cfg, DataConfig(batch=BATCH, seq=SEQ)),
        ocfg=optim.AdamWConfig(**FIT_OCFG), log_every=0, device="cpu")[2]

    got = ranks.result()
    _, err = child.communicate(timeout=300)
    assert child.returncode == 0, err[-3000:]
    with np.load(d / "ref_psum.npz") as z:
        want["psum"] = dict(z)
    return got, want, d


# -- the cases -----------------------------------------------------------------------------------

@pytest.mark.parametrize("leaf", ["a", "b", "z", "none"])
def test_psum_compressed_over_4_ranks_equals_reference(run, leaf):
    """Every rank gets the reference's result over 4 devices, bit for bit
    (bfloat16 in its dtype; a zero leaf zero; None stays None)."""
    got, want, _ = run
    for o in got:
        g = o["psum"][leaf]
        if leaf == "none":
            assert g is None
            continue
        assert g.dtype == (torch.bfloat16 if leaf == "b" else torch.float32)
        assert np.array_equal(g.float().numpy(), want["psum"][leaf][0])


def test_data_parallel_gradients_equal_reference(run):
    """The gradients of the global batch's loss, each rank holding 1 of
    the 4 rows, the mean of the ranks' gradients, on every rank."""
    got, want, _ = run
    for o in got:
        g = o[False]["grads"]
        assert set(g) == set(want["grads"])
        for k, w in want["grads"].items():
            w = np.asarray(w)
            assert np.abs(g[k] - w).max() <= GRAD_TOL * np.abs(w).max(), k


def test_moe_without_ep_on_a_data_mesh_routes_the_whole_batch(run):
    got, want, _ = run
    w = want["moe_dp"]
    for o in got:
        o = o["moe_dp"]
        assert abs(o["loss"] - w["loss"]) <= 1e-5
        for k, v in w["grads"].items():
            v = np.asarray(v)
            assert np.abs(o["grads"][k] - v).max() <= \
                MOE_TOL * np.abs(v).max(), k


@pytest.mark.parametrize("compress", [False, True])
def test_data_parallel_step_equals_reference(run, compress):
    got, want, _ = run
    w = want[compress]
    for o in got:
        o = o[compress]
        assert abs(o["loss"] - w["loss"]) <= 1e-5
        np.testing.assert_allclose(o["grad_norm"], w["grad_norm"],
                                   rtol=COMPRESSED_NORM if compress else 1e-5)
        assert o["lr"] == w["lr"]
        for a, b in zip(_leaves(o["params"]), _leaves(w["params"])):
            np.testing.assert_allclose(a.astype(np.float32),
                                       b.astype(np.float32),
                                       rtol=PARAM_TOL, atol=PARAM_TOL)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def test_fit_restores_onto_a_smaller_mesh(run):
    """Uninterrupted on (4, 1); stopped at a checkpoint at step 2, two
    ranks lost, resumed on (2, 1): the same losses at 1e-5, and those the
    one-process fit's at 1e-5."""
    got, want, _ = run
    whole = got[0]["whole"]
    np.testing.assert_allclose(whole, want["one"], rtol=1e-5, atol=1e-5)
    for o in got:
        assert o["whole"] == whole
        assert o["first"] == whole[:STEPS // 2]
        assert o["m2"] == {"data": 2, "model": 1}
    for o in got[:2]:
        np.testing.assert_allclose(o["resumed"], whole[STEPS // 2:],
                                   rtol=1e-5, atol=1e-5)
    assert all("resumed" not in o for o in got[2:])


def test_ep_checkpoint_restores_whole_in_the_reference(run):
    """The (2, 2) EP run's checkpoint, written by rank 0 with the experts
    gathered over "model": the reference's Checkpointer restores each
    expert leaf whole (8 experts; each rank's 4 where they belong, in the
    parameters and in the optimizer's mu), and the reference's fit resumes
    from step 2 to 3."""
    import jax
    from repro import optim as joptim
    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro.configs import get_config as jget
    from repro.data import DataConfig as JDataConfig
    from repro.data import Loader as JLoader
    from repro.launch import train as jtrain
    from repro.runtime.elastic import carve_mesh as jcarve
    got, _, d = run
    tree, man = JCheckpointer(str(d / "ep")).restore()
    assert man["step"] == 2
    wi = np.asarray(tree["params"]["group"][0]["ffn"]["wi"])
    mu = np.asarray(tree["opt"]["mu"]["group"][0]["ffn"]["wo"])
    assert wi.shape[1] == 8 and mu.shape[1] == 8
    for o in got:
        lo, hi = o["ep"]["experts"]
        assert hi - lo == 4
        for r in (0, 1):
            assert np.array_equal(wi[r, lo:hi], o["ep"]["wi"][r])
            assert np.array_equal(mu[r, lo:hi], o["ep"]["mu"][r])
    jcfg = jget(EP_ARCH, smoke=True)
    logs = []
    _, _, hist = jtrain.fit(
        jcfg, mesh=jcarve(jax.devices()[:1]), steps=3,
        data_loader=JLoader(jcfg, JDataConfig(batch=BATCH, seq=SEQ)),
        ocfg=joptim.AdamWConfig(**FIT_OCFG),
        checkpointer=JCheckpointer(str(d / "ep")), log_every=1,
        log=logs.append)
    assert "[train] resumed from step 2" in logs
    assert len(hist) == 1 and np.isfinite(hist).all()
    assert got[0]["ep_hist"] == got[3]["ep_hist"]
