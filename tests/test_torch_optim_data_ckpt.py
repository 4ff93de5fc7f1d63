"""Port parity of the training substrate: ``repro_torch.data`` (the
reference's batches, byte for byte), ``optim`` (schedule, AdamW's update,
int8 compression), ``checkpoint`` (the reference's layout, bfloat16
leaves included) and ``launch.train`` (the train step and ``fit``) against
``repro``, and the port-only counterparts of tests/test_train.py.

The whole slice: the reference's ``fit`` writes a checkpoint at step 6
(tinyllama SMOKE, batch 2 x seq 16, a one-device mesh); copies of it are
resumed to step 12 by the reference's ``fit`` and by the port's
``fit(device="cpu")``; and the other way round, a checkpoint of the
port's ``fit`` restores in the reference and resumes in both.

Tolerances, each stated where it is used: losses at 1e-4 after several
steps, 1e-5 after one; the optimizer's state at 1e-6 on identical
gradients; parameters after steps of training at the reference's own
rtol = atol = 5e-3 (tests/test_train.py), with the share of elements past
1e-4 printed.  Adam's first steps move a parameter by about lr · g / |g|,
so a rounding that flips the sign of a tiny gradient moves it by 2 · lr:
parameters are compared only at that tolerance, and the update itself
on identical gradients.
"""
import dataclasses
import json
import os
import shutil
import tempfile
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import ARCHS
from repro.configs import get_config as jget
from repro.data import DataConfig as JDataConfig
from repro.data import Loader as JLoader
from repro.data import make_batch as jmake_batch
from repro.launch import train as jtrain
from repro.runtime.elastic import carve_mesh
from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, Loader, make_batch
from repro_torch.launch import train
from repro_torch.models import convert

# the whole suite runs in 6 pytest workers on 8 cores: two intra-op threads
# a worker keep these modules from starving the reference's timing-gated tests
torch.set_num_threads(2)

ARCH = "tinyllama-1.1b"
#: the reference's tolerance for parameters after training steps
PARAM_TOL = 5e-3


def mesh():
    return carve_mesh(jax.devices()[:1])


def ocfgs(**kw):
    """The same AdamW settings in both packages."""
    return joptim.AdamWConfig(**kw), optim.AdamWConfig(**kw)


def compare_params(want_tree, model, cfg, label: str) -> None:
    """The port's parameters against the reference's tree at PARAM_TOL,
    printing the share of elements past 1e-4."""
    got = jax.tree.leaves(convert.params_to_reference(model, cfg))
    want = [np.asarray(a, np.float32) for a in jax.tree.leaves(want_tree)]
    past = sum(int((np.abs(w - g) > 1e-4).sum()) for w, g in zip(want, got))
    print(f"{label}: {past / sum(w.size for w in want):.3e} of the "
          f"elements differ by more than 1e-4")
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.astype(np.float32), w, rtol=PARAM_TOL,
                                   atol=PARAM_TOL)


# -- data ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 17])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_is_the_references(arch, step):
    """Every key, dtype, shape and byte, for every config (the audio
    family's ``embeds``, the VLM family's ``frontend``)."""
    dc = dict(seed=3, batch=2, seq=16)
    got = make_batch(get_config(arch, smoke=True), DataConfig(**dc), step)
    want = jmake_batch(jget(arch, smoke=True), JDataConfig(**dc), step)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes()


def test_loader_seeks():
    cfg = get_config(ARCH, smoke=True)
    dc = DataConfig(batch=2, seq=8)
    loader = Loader(cfg, dc, start_step=5)
    assert np.array_equal(next(loader)["tokens"], make_batch(cfg, dc, 5)["tokens"])
    loader.step = 2
    assert np.array_equal(next(loader)["labels"], make_batch(cfg, dc, 2)["labels"])
    assert loader.step == 3


# -- optimizer -------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (100, 100)])
def test_schedule_matches_reference(warmup, total):
    """Steps 0-120 (past the end of the cosine), float32, at rtol 1e-6."""
    jo, to = ocfgs(lr=1e-3, warmup_steps=warmup, total_steps=total)
    steps = np.arange(121, dtype=np.int32)
    got = optim.schedule(to, torch.from_numpy(steps))
    want = joptim.schedule(jo, jnp.asarray(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_apply_matches_reference():
    """Five steps on the same random gradients: a bfloat16 and two float32
    parameters, one of them with no gradient (``None`` in the port, a
    zero leaf in the reference: only weight decay moves it).  Master, mu
    and nu at 1e-6, the step exactly, each parameter its master re-cast,
    and the gradient norm and learning rate at 1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 8), "b": (16,), "c": (3, 3)}
    dtypes = {"a": torch.bfloat16, "b": torch.float32, "c": torch.float32}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    params = {k: torch.from_numpy(v.copy()).to(dtypes[k])
              for k, v in init.items()}
    jparams = {k: jnp.asarray(v, jnp.bfloat16 if k == "a" else jnp.float32)
               for k, v in init.items()}
    state, jstate = optim.init(params), joptim.init(jparams)
    jo, to = ocfgs(lr=1e-2, warmup_steps=2, total_steps=10)
    for _ in range(5):
        g = {k: rng.normal(size=s).astype(np.float32) * 3
             for k, s in shapes.items()}
        grads = {"a": torch.from_numpy(g["a"]).to(torch.bfloat16),
                 "b": torch.from_numpy(g["b"]), "c": None}
        jgrads = {"a": jnp.asarray(g["a"], jnp.bfloat16),
                  "b": jnp.asarray(g["b"]), "c": jnp.zeros(shapes["c"])}
        params, state, m = optim.apply(to, grads, state, params)
        jparams, jstate, jm = joptim.apply(jo, jgrads, jstate, jparams)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-6)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 5
    assert int(jstate["step"]) == 5
    for part in ("master", "mu", "nu"):
        for k in shapes:
            np.testing.assert_allclose(state[part][k].numpy(),
                                       np.asarray(jstate[part][k]),
                                       rtol=1e-6, atol=1e-6)
    for k, p in params.items():
        assert p.dtype == dtypes[k]
        assert torch.equal(p, state["master"][k].to(dtypes[k]))
    assert not state["mu"]["c"].any()
    assert not torch.equal(state["master"]["c"], torch.from_numpy(init["c"]))


@pytest.mark.parametrize("chunk", [1 << 22, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_is_the_references_expression_bit_for_bit(dtype, chunk,
                                                        monkeypatch):
    """``apply`` updates in place, a chunk of a leaf at a time (four ranks
    on one card hold four copies of DeepSeek's replicated state); every
    state and parameter equals, bit for bit, the reference's expression
    evaluated as written on whole leaves, over six steps, a ``None``
    gradient on every other step, with leaves inside one chunk and leaves
    of several (a chunk of 100 elements)."""
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw, "UPDATE_CHUNK", chunk)
    def written(cfg, grads, state, params):
        step = state["step"] + 1
        scale = torch.clamp(cfg.clip_norm / (optim.global_norm(grads) + 1e-9),
                            max=1.0)
        lr = optim.schedule(cfg, step)
        b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
        b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))
        for k, p in params.items():
            m, v, w = state["mu"][k], state["nu"][k], state["master"][k]
            g = grads.get(k)
            g = (torch.zeros_like(w) if g is None
                 else g.to(torch.float32)) * scale
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            w.copy_(w - lr * (m / b1c / (torch.sqrt(v / b2c) + cfg.eps)
                              + cfg.weight_decay * w))
            p.copy_(w)
        state["step"] = step

    gen = torch.Generator().manual_seed(0)
    shapes = {"a": (64, 33), "b": (1000,), "c": (7,)}
    want = {k: torch.randn(s, generator=gen).to(dtype)
            for k, s in shapes.items()}
    got = {k: v.clone() for k, v in want.items()}
    sw, sg = optim.init(want), optim.init(got)
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    for i in range(6):
        g = {k: (torch.randn(s, generator=gen) * 3).to(dtype)
             for k, s in shapes.items()}
        g["c"] = None if i % 2 else g["c"]
        written(cfg, g, sw, want)
        optim.apply(cfg, g, sg, got)
    for part in ("master", "mu", "nu"):
        for k in shapes:
            assert torch.equal(sg[part][k], sw[part][k]), (part, k)
    for k in shapes:
        assert torch.equal(got[k], want[k]), k


def test_global_norm_counts_none_as_zero():
    g = {"a": torch.full((4,), 1.5), "b": None, "c": torch.full((1,), 4.0)}
    assert float(optim.global_norm(g)) == 5.0
    want = joptim.global_norm({"a": jnp.full((4,), 1.5), "b": jnp.zeros(2),
                               "c": jnp.full((1,), 4.0)})
    assert float(want) == 5.0


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_compress_int8_matches_reference(dtype):
    """Equal q and the same scale (``jnp.round`` and ``torch.round`` both
    round half to even; the values include exact halves), and
    ``psum_compressed`` over one member equals the reference's over a
    one-member axis."""
    rng = np.random.default_rng(1)
    g = rng.normal(size=(64,)).astype(np.float32)
    g[:4] = np.array([0.5, 1.5, 2.5, -2.5]) * float(np.abs(g).max()) / 127
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jg = jnp.asarray(g, jdt)
    tg = torch.tensor(np.asarray(jg.astype(jnp.float32))).to(tdt)
    q, scale = optim.compress_int8(tg)
    jq, jscale = joptim.adamw.compress_int8(jg)
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    assert np.array_equal(optim.decompress_int8(q, scale).numpy(),
                          np.asarray(joptim.adamw.decompress_int8(jq, jscale)))
    got = optim.psum_compressed({"g": tg, "none": None})
    want = jax.vmap(lambda t: joptim.psum_compressed(t, "i"),
                    axis_name="i")(jg[None])[0]
    assert got["none"] is None and got["g"].dtype == tdt
    assert np.array_equal(got["g"].float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


# -- checkpoint store --------------------------------------------------------------------

def test_async_checkpoint_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_mode=True)
    tree = {"w": torch.arange(10.0), "l": [torch.ones(2, dtype=torch.int32)]}
    for s in (1, 2, 3):
        ck.save(s, tree)
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    t, man = ck.restore(3)
    assert man["step"] == 3 and man["n_devices_at_save"] == 1
    assert torch.equal(t["w"], torch.arange(10.0))
    assert isinstance(t["l"], list) and t["l"][0].dtype == torch.int32


def test_async_save_copies_what_training_changes_next(tmp_path):
    """A save takes its own host copy of each leaf, so an in-place update
    of a CPU parameter right after ``save`` does not reach the file."""
    ck = Checkpointer(str(tmp_path), keep=1, async_mode=True)
    w = torch.zeros(1 << 16)
    ck.save(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    assert not ck.restore()[0]["w"].any()


def test_bfloat16_leaves_in_the_references_layout(tmp_path):
    """A bfloat16 leaf is written as its 16 bits with the descr '<V2' and
    the manifest's "bfloat16", as the reference's ``np.savez`` of an
    ``ml_dtypes`` leaf writes it; the port restores it as bfloat16 bit for
    bit, from its own checkpoint and from the reference's.  The
    reference's own restore gives such a leaf back as raw 'V2' (its
    bits intact)."""
    w = torch.randn(5, 3).to(torch.bfloat16)
    bits = w.view(torch.int16).numpy()
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    Checkpointer(str(port_dir)).save(4, {"p": {"w": w}})
    JCheckpointer(str(ref_dir)).save(
        4, {"p": {"w": jnp.asarray(bits.view(ml_dtypes.bfloat16))}})
    for d in (port_dir, ref_dir):
        step = os.path.join(d, "step_00000004")
        with open(os.path.join(step, "manifest.json")) as f:
            assert json.load(f)["paths"]["p/w"] == {"shape": [5, 3],
                                                   "dtype": "bfloat16"}
        with zipfile.ZipFile(os.path.join(step, "arrays.npz")) as zf:
            assert b"'descr': '<V2'" in zf.read("p|w.npy")[:128]
        t, _ = Checkpointer(str(d)).restore(device="cpu")
        assert t["p"]["w"].dtype == torch.bfloat16
        assert torch.equal(t["p"]["w"], w)
        jt_, _ = JCheckpointer(str(d)).restore()
        assert jt_["p"]["w"].dtype == np.dtype("V2")
        assert jt_["p"]["w"].tobytes() == bits.tobytes()


# -- the whole slice: checkpoints of either package resume in the other ---------------

@pytest.fixture(scope="module")
def whole_slice():
    """(cfgs, AdamW cfgs, the reference's checkpoint directory at step 6)."""
    jcfg, tcfg = jget(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jo, to = ocfgs(lr=1e-3, warmup_steps=2, total_steps=12)
    d = tempfile.mkdtemp(prefix="repro_torch_slice_")
    jtrain.fit(jcfg, mesh=mesh(), steps=6,
               data_loader=JLoader(jcfg, JDataConfig(batch=2, seq=16)),
               ocfg=jo, checkpointer=JCheckpointer(os.path.join(d, "ref"),
                                                  keep=2),
               checkpoint_every=6, log_every=0)
    yield jcfg, tcfg, jo, to, d
    shutil.rmtree(d, ignore_errors=True)


def resume_both(whole, src: str, steps: int, tag: str):
    """Copies of checkpoint directory ``src`` resumed to ``steps`` by each
    package -> (reference (params, opt, history), port (model, opt,
    history))."""
    jcfg, tcfg, jo, to, d = whole
    jdir, tdir = (os.path.join(d, f"{tag}_{who}") for who in ("j", "t"))
    shutil.copytree(src, jdir)
    shutil.copytree(src, tdir)
    logs = []
    ref = jtrain.fit(jcfg, mesh=mesh(), steps=steps,
                     data_loader=JLoader(jcfg, JDataConfig(batch=2, seq=16)),
                     ocfg=jo, checkpointer=JCheckpointer(jdir, keep=2),
                     log_every=0)
    port = train.fit(tcfg, steps=steps,
                     data_loader=Loader(tcfg, DataConfig(batch=2, seq=16)),
                     ocfg=to, checkpointer=Checkpointer(tdir, keep=2),
                     log_every=1, log=logs.append, device="cpu")
    assert logs[0] == f"[train] resumed from step {6}"
    assert len(logs) == 1 + steps - 6 and logs[1].startswith("[train] step 6 ")
    return ref, port


def test_reference_checkpoint_resumes_in_the_port(whole_slice):
    """The reference's step-6 checkpoint resumed to 12 by both: the six
    losses at 1e-4, the parameters at rtol = atol = 5e-3."""
    jcfg, tcfg, *_, d = whole_slice
    (jp, jopt, jhist), (model, opt, hist) = resume_both(
        whole_slice, os.path.join(d, "ref"), 12, "ref")
    assert len(hist) == len(jhist) == 6
    np.testing.assert_allclose(hist, jhist, rtol=1e-4, atol=1e-4)
    assert int(opt["step"]) == int(jopt["step"]) == 12
    compare_params(jp, model, tcfg, "reference checkpoint, 6 steps in each")


def test_port_checkpoint_resumes_in_the_reference(whole_slice):
    """The port's ``fit`` (its own seeded weights) writes a checkpoint at
    step 6; the reference's ``restore`` reads every leaf of it bit for bit
    with the reference's paths and dtypes, and both packages resume it to
    step 9: losses at 1e-4, parameters at rtol = atol = 5e-3."""
    jcfg, tcfg, jo, to, d = whole_slice
    src = os.path.join(d, "port")
    model, opt, _ = train.fit(
        tcfg, steps=6, data_loader=Loader(tcfg, DataConfig(batch=2, seq=16)),
        ocfg=to, checkpointer=Checkpointer(src, keep=2), checkpoint_every=6,
        log_every=0, device="cpu")
    tree, man = JCheckpointer(src).restore()
    want = {"params": convert.params_to_reference(model, tcfg),
            "opt": convert.opt_state_to_reference(opt, tcfg)}
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    _, jman = JCheckpointer(os.path.join(d, "ref")).restore()
    assert man["paths"] == jman["paths"] and man["step"] == 6
    (jp, _, jhist), (model, _, hist) = resume_both(whole_slice, src, 9, "port")
    np.testing.assert_allclose(hist, jhist, rtol=1e-4, atol=1e-4)
    compare_params(jp, model, tcfg, "port checkpoint, 3 steps in each")


# -- the train step against the reference's -------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_reference(compress):
    """One step from the same weights and state on the same batch, plain
    and with int8-compressed gradients (the reference's compressed
    data-parallel step on a one-device mesh): loss at 1e-5, gradient norm
    at 1e-5 relative (1e-3 compressed: the int8 levels of a leaf lie
    amax / 127 apart, and a gradient that agrees to 1e-6 but sits at a
    rounding boundary lands one level away), learning rate exactly,
    parameters at rtol = atol = 5e-3."""
    jcfg, tcfg = jget(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jo, to = ocfgs(lr=1e-3, warmup_steps=0, total_steps=10)
    m = mesh()
    jparams, jopt, specs = jtrain.init_state(jax.random.PRNGKey(0), jcfg, m)
    model = convert.params_from_reference(jax.tree.map(np.asarray, jparams),
                                          tcfg, device="cpu")
    model.requires_grad_(True)
    opt = convert.opt_state_from_reference(jax.tree.map(np.asarray, jopt),
                                           tcfg, device="cpu")
    b = make_batch(tcfg, DataConfig(batch=4, seq=16), 0)
    jstep = jtrain.make_train_step(jcfg, jo, m, specs, compress_grads=compress,
                                   donate=False)
    jp, _, jm = jstep(jparams, jopt, jtrain.shard_batch(b, jcfg, m))
    step = train.make_train_step(tcfg, to, compress_grads=compress)
    model, opt, tm = step(model, opt, train.to_device(b, tcfg, "cpu"))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3 if compress else 1e-5)
    assert float(tm["lr"]) == float(jm["lr"])
    assert int(opt["step"]) == 1
    compare_params(jp, model, tcfg, f"one step, compress_grads={compress}")


# -- port-only counterparts of tests/test_train.py --------------------------------------

def test_fit_loss_decreases():
    """The reference's test and margin: 20 steps at 4 x 32, lr 3e-3; the
    mean of the last 5 losses at least 0.1 below the first 5's."""
    cfg = get_config(ARCH, smoke=True)
    _, hist = train.fit(
        cfg, steps=20, data_loader=Loader(cfg, DataConfig(batch=4, seq=32)),
        ocfg=optim.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=20),
        log_every=0, device="cpu")[1:]
    assert np.isfinite(hist).all()
    assert np.mean(hist[-5:]) < np.mean(hist[:5]) - 0.1, hist


def test_checkpoint_restart_exact(tmp_path):
    """Killed at step 6 and resumed: bit-identical parameters and
    optimizer state to an uninterrupted 12-step run."""
    cfg = get_config(ARCH, smoke=True)
    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12)

    def run(steps, ck=None, every=0):
        return train.fit(cfg, steps=steps,
                         data_loader=Loader(cfg, DataConfig(batch=2, seq=16)),
                         ocfg=ocfg, checkpointer=ck, checkpoint_every=every,
                         log_every=0, device="cpu")

    full, full_opt, full_hist = run(12)
    ck = Checkpointer(str(tmp_path), keep=2, async_mode=True)
    run(6, ck, 6)
    assert ck.latest_step() == 6
    res, res_opt, res_hist = run(12, ck)
    assert res_hist == full_hist[6:]
    for (k, a), (_, b) in zip(full.named_parameters(), res.named_parameters()):
        assert torch.equal(a, b), k
    for part in ("master", "mu", "nu"):
        for k in full_opt[part]:
            assert torch.equal(full_opt[part][k], res_opt[part][k])
    assert torch.equal(full_opt["step"], res_opt["step"])


def test_microbatched_step_matches_single():
    """Four microbatches and one: the same update at rtol = atol = 5e-3."""
    cfg = get_config(ARCH, smoke=True)
    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    b = train.to_device(make_batch(cfg, DataConfig(batch=4, seq=16), 0), cfg,
                        "cpu")
    out = []
    for mb in (1, 4):
        model, opt = train.init_state(0, cfg, "cpu")
        step = train.make_train_step(cfg, ocfg, microbatches=mb)
        model, _, m = step(model, opt, b)
        out.append((model, m))
    (m1, r1), (m4, r4) = out
    np.testing.assert_allclose(float(r4["loss"]), float(r1["loss"]),
                               rtol=1e-5)
    for a, b4 in zip(m1.parameters(), m4.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b4.detach().numpy(),
                                   rtol=PARAM_TOL, atol=PARAM_TOL)


def test_microbatch_grads_accumulate_in_float32(monkeypatch):
    """bfloat16 parameters: with two microbatches the update gets the
    float32 sum of each microbatch's gradients over 2 (the reference sums
    into float32 zeros; ``.backward()`` would sum in bfloat16), and the
    loss is their mean; with one, the gradients keep the parameters'
    dtype until ``apply`` casts them."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              dtype=torch.bfloat16)
    b = train.to_device(make_batch(cfg, DataConfig(batch=4, seq=16), 0), cfg,
                        "cpu")
    seen = []
    real = optim.apply
    monkeypatch.setattr(optim, "apply", lambda c, g, s, p: (
        seen.append(g), real(c, g, s, p))[1])
    model, opt = train.init_state(0, cfg, "cpu")
    named = dict(model.named_parameters())
    want, losses = {}, []
    from repro_torch.models import transformer
    for half in train._split(b, 2):
        loss, _ = transformer.loss_fn(model, cfg, half)
        losses.append(loss.detach())
        for k, g in zip(named, torch.autograd.grad(loss, list(named.values()))):
            assert g.dtype == torch.bfloat16
            want[k] = g.float() if k not in want else want[k] + g.float()
    ocfg = optim.AdamWConfig(warmup_steps=0)
    _, _, m = train.make_train_step(cfg, ocfg, microbatches=2)(model, opt, b)
    assert torch.equal(m["loss"], (torch.zeros(()) + losses[0] + losses[1]) / 2)
    for k, g in seen[0].items():
        assert g.dtype == torch.float32 and torch.equal(g, want[k] / 2)
    model, opt = train.init_state(0, cfg, "cpu")
    train.make_train_step(cfg, ocfg)(model, opt, b)
    assert all(g.dtype == torch.bfloat16 for g in seen[1].values())


def test_parameter_without_gradient_is_decayed():
    """The audio family feeds ``embeds=``, so ``embed`` gets no gradient
    (None): AdamW treats it as zeros, as the reference's zero leaf, and
    weight decay alone moves it: w - lr · wd · w."""
    cfg = get_config("musicgen-medium", smoke=True)
    ocfg = optim.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    model, opt = train.init_state(0, cfg, "cpu")
    w = model.embed.detach().clone()
    b = train.to_device(make_batch(cfg, DataConfig(batch=2, seq=8), 0), cfg,
                        "cpu")
    _, opt, m = train.make_train_step(cfg, ocfg)(model, opt, b)
    lr = m["lr"]
    assert torch.equal(opt["master"]["embed"],
                       w - lr * (0 / (torch.sqrt(torch.zeros(())) + ocfg.eps)
                                 + ocfg.weight_decay * w))
    assert not opt["mu"]["embed"].any()


def test_fit_drives_the_step_monitor():
    """``monitor.start_step`` / ``end_step`` around every step, as the
    reference's ``fit`` calls them."""
    from repro_torch.runtime.straggler import StepMonitor
    cfg = get_config(ARCH, smoke=True)
    mon = StepMonitor()
    train.fit(cfg, steps=3, data_loader=Loader(cfg, DataConfig(batch=1, seq=8)),
              monitor=mon, log_every=0, device="cpu")
    assert len(mon.times) == 3 and all(t > 0 for t in mon.times)


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """``init_state``, ``to_device`` and ``fit`` go to ``cuda:0`` by
    default and raise without it; the CPU runs only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH, smoke=True)
    b = make_batch(cfg, DataConfig(batch=1, seq=4), 0)
    for call in (lambda: train.init_state(0, cfg),
                 lambda: train.to_device(b, cfg),
                 lambda: train.fit(cfg, steps=1, data_loader=Loader(
                     cfg, DataConfig(batch=1, seq=4)), log_every=0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_to_device_checks_the_batch():
    cfg = get_config("llama-3.2-vision-11b", smoke=True)
    b = make_batch(cfg, DataConfig(batch=1, seq=4), 0)
    t = train.to_device(b, cfg, "cpu")
    assert {k: v.dtype for k, v in t.items()} == {
        "tokens": torch.int32, "labels": torch.int32,
        "frontend": torch.float32}
    with pytest.raises(ValueError, match="batch keys"):
        train.to_device({k: b[k] for k in ("tokens", "labels")}, cfg, "cpu")


def full_width_curves(layers: int, lr: float, steps: int = 6) -> None:
    """Both packages' train steps on TinyLlama's published width cut to
    ``layers`` layers, float32, from the reference's seeded weights, on
    the same batches of 2 x 64 (AdamW warmup 2 to ``lr``): each step's
    loss and gradient norm, side by side.  Too large for the test run
    (~3 GB, ~5 s a step); the learning rate's effect at full width."""
    jcfg = dataclasses.replace(jget(ARCH), n_layers=layers,
                               dtype=jnp.float32, remat=False)
    tcfg = dataclasses.replace(get_config(ARCH), n_layers=layers,
                               dtype=torch.float32, remat=False)
    m = mesh()
    jparams, jopt, specs = jtrain.init_state(jax.random.PRNGKey(0), jcfg, m)
    model = convert.params_from_reference(jax.tree.map(np.asarray, jparams),
                                          tcfg, device="cpu")
    model.requires_grad_(True)
    opt = convert.opt_state_from_reference(jax.tree.map(np.asarray, jopt),
                                           tcfg, device="cpu")
    jo, to = ocfgs(lr=lr, warmup_steps=2, total_steps=8)
    jstep = jtrain.make_train_step(jcfg, jo, m, specs, donate=False)
    step = train.make_train_step(tcfg, to)
    print(f"{ARCH} width, {layers} layer(s), float32, 2 x 64, lr {lr}: "
          f"step, loss reference / port, grad_norm reference / port")
    for i in range(steps):
        b = jmake_batch(jcfg, JDataConfig(seed=0, batch=2, seq=64), i)
        jparams, jopt, jm = jstep(jparams, jopt, jtrain.shard_batch(b, jcfg, m))
        model, opt, tm = step(model, opt, train.to_device(b, tcfg, "cpu"))
        print(f"  {i} {float(jm['loss']):.6f} / {float(tm['loss']):.6f}  "
              f"{float(jm['grad_norm']):.4f} / {float(tm['grad_norm']):.4f}")


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_optim_data_ckpt.py [LR ...]
    import sys
    torch.set_num_threads(os.cpu_count())
    for lr in map(float, sys.argv[1:] or ["1e-3", "4e-4"]):
        full_width_curves(1, lr)
