"""Port parity of the rest of the reference's parameter placement — FSDP's
"data" entries (``fsdp=True``: each rank holds its block of a leaf's
embedding dimension, gathers a layer's leaves over "data" before using
them and reduce-scatters their gradients) and the experts on "model"
without ``moe_ep`` — in 4 gloo processes on the CPU against ``repro``.

One launch of 4 ranks (``launch.mesh.spawn``) runs every case while this
process computes the reference (one device) and, for its ``apply_ep``
under FSDP, a subprocess on 4 forced host devices.  The weights are the
port's seeded draw in the reference's tree (tests/test_torch_tp.py's
scheme); the batch is ``make_batch``'s 4 x 16, each data rank its rows.

- Every SMOKE family with ``fsdp=True`` on (2, 2) and (4, 1) — tinyllama,
  stablelm (``parallel_block``), musicgen (``embeds=``), llama-vision
  (cross attention), jamba (Mamba + MoE), deepseek, kimi, xlstm — and
  TinyLlama with ``remat`` on (2, 2) (the checkpointed group gathers
  again in the backward); the MoE families (deepseek, kimi, jamba)
  without ``moe_ep``, published (no FSDP), on (1, 2), (1, 4) and (2, 2).
  Every MoE config at capacity factor 0.5, where pairs drop (the whole
  batch's capacity).  For each: the logits of the rank's rows,
  the loss of the global batch and each rank's gradient of its part of
  each leaf (``launch.train.make_grads``: an FSDP leaf's gradient
  arrives summed over "data" by its gather's backward and is only
  divided) against ``jax.grad`` of the reference's loss, and
  ``params_to_reference`` after ``params_from_reference`` byte for byte
  (the two-axis placement undone); greedy tokens for some; on one case of
  each mesh the optimizer state a rank equal to its part and its bytes
  the parts' (ZeRO-3's saving), and the carry back byte for byte.
- One ``compress_grads`` step of TinyLlama with FSDP on (4, 1) against
  the reference's compressed step (each FSDP leaf's mean gradient enters
  the int8 sum whole, as ``_compressed_dp_grads`` takes the tree).
- ``fit`` of TinyLlama with FSDP on (2, 2) with a checkpoint,
  ``simulate_failure(n_lost=2)`` and restarts on (1, 2) and on (2, 1) at
  the uninterrupted losses (1e-5), those at the one-process fit's.
- ``apply_ep`` with ``fsdp`` on (2, 2) against the reference's
  ``apply_ep`` (the router and the experts gathered over "data",
  ``moe.py:151-154``), at capacity factors 8.0 and 0.5.
- The combined placement stated leaf by leaf; ``check_ported`` refusing
  experts or "data" dimensions that do not divide.

Tolerances are each family's one-process ones from its own test file:
logits 1e-4 (jamba's stack 1e-3, tests/test_torch_moe_hybrid.py), the
loss 1e-5 and each gradient leaf 1e-4 of its largest |g|, jamba's within
twice the reference's own one-ulp spread (tests/test_torch_train.py).
The reference is imported inside the fixture: the ranks import this
module and run no JAX.
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
from repro_torch.core.sharding import P
from repro_torch.data import DataConfig, Loader, make_batch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve, train
from repro_torch.models import convert, layers, moe, transformer
from repro_torch.models.layers import ModelConfig
from repro_torch.runtime import elastic

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TOL, LOSS_TOL = 1e-4, 1e-5
STACK_TOL = {"jamba-1.5-large-398b": 1e-3}
#: families whose gradients are held within twice the reference's own
#: one-ulp spread (tests/test_torch_train.py)
SPREAD = {"jamba-1.5-large-398b"}
MOE = ("deepseek-moe-16b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b")
#: the capacity factor of every MoE config here: pairs drop
CAP = 0.5
BATCH, SEQ = 4, 16
PROMPT, NEW = (2, 6), 4
FIT_STEPS, FIT_OCFG = 4, dict(lr=1e-3, warmup_steps=1, total_steps=4)
FIT_ARCH = "tinyllama-1.1b"
#: the compressed step on (4, 1) (tests/test_torch_train_mesh.py's step,
#: parameter tolerance and norm tolerance)
STEP_OCFG = dict(lr=1e-3, warmup_steps=0, total_steps=10)
PARAM_TOL, COMPRESSED_NORM = 5e-3, 1e-3
#: the MoE layer of tests/test_torch_ep.py (the reference's own config)
LAYER = dict(d_model=32, d_ff=16, moe_experts=8, moe_top_k=2)
CAPS = (8.0, 0.5)

FAMILIES = ("tinyllama-1.1b", "stablelm-12b", "musicgen-medium",
            "llama-3.2-vision-11b", "jamba-1.5-large-398b",
            "deepseek-moe-16b", "kimi-k2-1t-a32b", "xlstm-125m")
#: (arch, mode, mesh): mode "fsdp" (``fsdp=True``), "remat" (and
#: ``remat=True``) or "published" (the SMOKE config, no ``moe_ep``);
#: mesh "m22" (2, 2), "m41" (4, 1), "m14" (1, 4), "a" / "b" the (1, 2)
#: meshes of ranks 0-1 / 2-3
CASES = ([(a, "fsdp", m) for m in ("m22", "m41") for a in FAMILIES]
         + [("tinyllama-1.1b", "remat", "m22")]
         + [(a, "published", m) for a, m in zip(MOE, ("a", "b", "a"))]
         + [(a, "published", m) for m in ("m14", "m22") for a in MOE])
GREEDY = {("tinyllama-1.1b", "fsdp", "m22"),
          ("jamba-1.5-large-398b", "fsdp", "m41"),
          ("llama-3.2-vision-11b", "fsdp", "m41"),
          ("xlstm-125m", "fsdp", "m22"),
          ("deepseek-moe-16b", "published", "m14")}
#: the cases whose optimizer state is carried both ways
OPT = {("kimi-k2-1t-a32b", "fsdp", "m22"), ("jamba-1.5-large-398b",
                                            "fsdp", "m41"),
       ("deepseek-moe-16b", "published", "m14")}
SIZES = {"m22": 4, "m41": 4, "m14": 4, "a": 2, "b": 2}

REF_EP = r"""
import sys; sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from repro.models import moe
from repro.models.layers import ModelConfig
from repro.core.compat import set_mesh
src = np.load(sys.argv[2])
params = {k: jnp.asarray(src[k]) for k in ("router", "wi", "wo")}
x = jnp.asarray(src["x"])
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for cap in (8.0, 0.5):
    cfg = ModelConfig(d_model=32, d_ff=16, moe_experts=8, moe_top_k=2,
                      moe_capacity_factor=cap, dtype=jnp.float32, fsdp=True)
    f = lambda p, xx: moe.apply_ep(p, cfg, xx)
    obj = lambda p, xx: (lambda y, a: y.sum() + a)(*f(p, xx))
    with set_mesh(mesh):
        y, aux = jax.jit(f)(params, x)
        gp, gx = jax.jit(jax.grad(obj, argnums=(0, 1)))(params, x)
    out[f"{cap}/y"], out[f"{cap}/aux"], out[f"{cap}/x"] = y, aux, gx
    for k in gp:
        out[f"{cap}/{k}"] = gp[k]
np.savez(sys.argv[3], **{k: np.asarray(v) for k, v in out.items()})
"""


def port_cfg(arch: str, mode: str = "published") -> ModelConfig:
    cfg = get_config(arch, smoke=True)
    if cfg.moe_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=CAP)
    if mode != "published":
        cfg = dataclasses.replace(cfg, fsdp=True, remat=mode == "remat")
    return cfg


def model_input(batch: dict) -> dict:
    """``batch``'s forward inputs (all but the labels)."""
    return {k: v for k, v in batch.items() if k != "labels"}


def layer_cfg(cap: float) -> ModelConfig:
    return ModelConfig(**LAYER, moe_capacity_factor=cap, dtype=torch.float32,
                       moe_ep=True, fsdp=True)


# -- the ranks ------------------------------------------------------------------------

def _case(mesh, ref: dict, case) -> dict:
    arch, mode, _ = case
    cfg = port_cfg(arch, mode)
    model = convert.params_from_reference(ref["params"][arch], cfg,
                                           device="cpu", mesh=mesh)
    rows = train.rows(BATCH, mesh)
    b = train.shard_batch(ref["batch"][arch], cfg, mesh, "cpu")
    with torch.no_grad():
        logits, _ = transformer.forward(model, cfg, **model_input(b))
    out = {"rows": (rows.start, rows.stop), "logits": logits.numpy(),
           "round_trip": convert.params_to_reference(model, cfg),
           "parts": dict(transformer.leaf_parts(model))}
    model.requires_grad_(True)
    loss, g = train.make_grads(cfg, mesh)(model, b)
    out["loss"] = float(loss)
    out["grads"] = {k: None if v is None else v.numpy() for k, v in g.items()}
    model.requires_grad_(False)
    if case in GREEDY:
        fr = ref["batch"][arch].get("frontend")
        out["tokens"] = serve.greedy_generate(
            model, cfg, ref["prompt"][arch], NEW,
            frontend=None if fr is None else fr[:PROMPT[0]]).numpy()
        bm = serve.batch_mesh(mesh, PROMPT[0])
        r = (train.rows(PROMPT[0], bm) if bm and "data" in bm.mesh_dim_names
             else slice(0, PROMPT[0]))
        out["token_rows"] = (r.start, r.stop)
    if case in OPT:
        state = convert.opt_state_from_reference(ref["opt"][arch], cfg,
                                                 device="cpu", model=model)
        out["opt"] = {k: {n: t.numpy() for n, t in state[k].items()}
                      for k in ("master", "mu", "nu")}
        out["opt_back"] = convert.opt_state_to_reference(state, cfg, model)
    return out


def _layer_case(mesh, ref: dict, cap: float) -> dict:
    """``apply_ep`` under FSDP on the rank's row; the objective's
    gradients of the router and the rank's experts arrive summed over
    "data" (their gathers' reduce-scatter)."""
    cfg = layer_cfg(cap)
    p = moe.MoE(cfg, device="cpu", mesh=mesh)
    convert._load(p, {k: ref["layer"][k] for k in ("router", "wi", "wo")},
                  "moe")
    p.requires_grad_(True)
    i, D = mesh.get_local_rank("data"), 2
    x = torch.from_numpy(ref["layer"]["x"][i:i + 1].copy()).requires_grad_(True)
    y, aux = moe.apply_ep(p, cfg, x, mesh=mesh)
    g = torch.autograd.grad(y.sum() + aux / D, [p.router, p.wi, p.wo, x])
    return {"row": i, "y": y.detach().numpy(), "aux": float(aux.detach()),
            "parts": dict(transformer.leaf_parts(p)),
            "shapes": {k: tuple(getattr(p, k).shape)
                       for k in ("router", "wi", "wo")},
            **{k: t.numpy() for k, t in zip(("router", "wi", "wo", "x"), g)}}


def _compressed_step(mesh, ref: dict) -> dict:
    """One ``compress_grads`` step of TinyLlama with FSDP on (4, 1): each
    FSDP leaf's mean gradient enters the int8 sum whole on every rank, as
    the reference's ``_compressed_dp_grads`` takes its tree."""
    cfg = port_cfg(FIT_ARCH, "fsdp")
    model = convert.params_from_reference(ref["params"][FIT_ARCH], cfg,
                                          device="cpu", mesh=mesh)
    model.requires_grad_(True)
    opt = convert.opt_state_from_reference(ref["step_opt"], cfg,
                                           device="cpu", model=model)
    b = train.shard_batch(ref["batch"][FIT_ARCH], cfg, mesh, "cpu")
    step = train.make_train_step(cfg, optim.AdamWConfig(**STEP_OCFG), mesh,
                                 compress_grads=True)
    model, opt, m = step(model, opt, b)
    return {**{k: float(v) for k, v in m.items()},
            "params": convert.params_to_reference(model, cfg)}


def _fit(cfg, mesh, steps, ck=None, every=0):
    return train.fit(cfg, steps=steps, data_loader=Loader(
        cfg, DataConfig(batch=BATCH, seq=SEQ)),
        ocfg=optim.AdamWConfig(**FIT_OCFG), checkpointer=ck,
        checkpoint_every=every, log_every=0, device="cpu", mesh=mesh)[2]


def _fsdp_rank(rank: int, ref: dict, ckdir: str) -> dict:
    """Every case on this rank; every rank builds every mesh in the same
    order (their groups are made on the whole world)."""
    meshes = {"m22": elastic.carve_mesh(model_parallel=2, device_type="cpu"),
              "m41": elastic.carve_mesh(model_parallel=1, device_type="cpu"),
              "m14": elastic.carve_mesh(model_parallel=4, device_type="cpu"),
              "a": elastic.carve_mesh([0, 1], 2, device_type="cpu"),
              "b": elastic.carve_mesh([2, 3], 2, device_type="cpu")}
    out = {}
    for case in CASES:
        if sharding.member(meshes[case[2]]):
            out[case] = _case(meshes[case[2]], ref, case)
    for cap in CAPS:
        out[("layer", cap)] = _layer_case(meshes["m22"], ref, cap)
    out["compressed"] = _compressed_step(meshes["m41"], ref)
    cfg = port_cfg(FIT_ARCH, "fsdp")
    m22 = meshes["m22"]
    out["whole"] = _fit(cfg, m22, FIT_STEPS)
    ck = os.path.join(ckdir, "fsdp")
    out["first"] = _fit(cfg, m22, FIT_STEPS // 2, Checkpointer(ck),
                        FIT_STEPS // 2)
    for mp in (2, 1):
        lost = elastic.simulate_failure(m22, n_lost=2, model_parallel=mp)
        out[f"mesh{mp}"] = dict(zip(lost.mesh_dim_names, lost.shape))
        if sharding.member(lost):
            out[f"resumed{mp}"] = _fit(cfg, lost, FIT_STEPS, Checkpointer(ck))
    return out


# -- the reference and the run ------------------------------------------------------------

def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def reference_spread(vg, params, b, want, seeds=(0, 1)) -> float:
    """The largest move of the reference's own gradients (each leaf's max
    |diff| over its largest |g|) when every weight moves by one ulp, up or
    down as ``seeds`` draw it (tests/test_torch_train.py's)."""
    import jax
    import jax.numpy as jnp
    reach = 0.0
    for seed in seeds:
        r = np.random.default_rng(seed)

        def nudge(a):
            a = np.asarray(a)
            up = r.random(a.shape) < 0.5
            return jnp.asarray(np.nextafter(
                a, np.where(up, np.inf, -np.inf).astype(a.dtype)))
        moved = vg(jax.tree.map(nudge, params), b)[1]
        for w, m in zip(jax.tree.leaves(want), jax.tree.leaves(moved)):
            w, m = np.asarray(w), np.asarray(m)
            if np.abs(w).max() > 0:
                reach = max(reach, float(np.abs(m - w).max()
                                         / np.abs(w).max()))
    return reach


def _opt_tree(params):
    """A reference optimizer state of distinct leaves: master, mu and nu
    float32, from the weights."""
    import jax
    f32 = lambda f: jax.tree.map(  # noqa: E731
        lambda a: f(np.asarray(a, dtype=np.float32)), params)
    return {"master": f32(lambda a: a), "mu": f32(lambda a: 0.5 * a),
            "nu": f32(lambda a: a * a), "step": np.int32(3)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro import optim as joptim
    from repro.configs import get_config as jget
    from repro.launch import serve as jserve
    from repro.launch import train as jtrain
    from repro.models import moe as jmoe
    from repro.models import transformer as jtr
    from repro.models.layers import ModelConfig as JCfg
    from repro.runtime.elastic import carve_mesh as jcarve

    d = tmp_path_factory.mktemp("fsdp")
    jl = JCfg(**LAYER, moe_capacity_factor=8.0, dtype=jnp.float32)
    lp, _ = jmoe.init(jax.random.PRNGKey(0), jl)
    layer = {k: np.asarray(v) for k, v in lp.items()}
    layer["x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                              (2, 16, 32), jnp.float32))
    np.savez(d / "layer.npz", **layer)
    child = subprocess.Popen(
        [sys.executable, "-c", REF_EP, SRC, str(d / "layer.npz"),
         str(d / "ref_ep.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    archs = sorted({a for a, _, _ in CASES})
    ref = {"params": {}, "batch": {}, "prompt": {}, "opt": {},
           "layer": layer}
    jparams, jspecs = {}, {}
    rng = np.random.default_rng(7)
    for arch in archs:
        cfg = port_cfg(arch)
        box = {}

        def init(k, jcfg=jget(arch, smoke=True)):
            p, box["specs"] = jtr.init(k, jcfg)
            return p
        jax.eval_shape(init, jax.random.PRNGKey(0))
        jspecs[arch] = box["specs"]
        ref["params"][arch] = convert.params_to_reference(
            transformer.init(cfg, seed=1, device="cpu"), cfg)
        jparams[arch] = jax.tree.map(jnp.asarray, ref["params"][arch])
        ref["batch"][arch] = make_batch(cfg, DataConfig(batch=BATCH,
                                                        seq=SEQ), 0)
        ref["prompt"][arch] = rng.integers(0, cfg.vocab,
                                           PROMPT).astype(np.int32)
        if any(c[0] == arch for c in OPT):
            ref["opt"][arch] = _opt_tree(ref["params"][arch])
    ref["step_opt"] = jax.tree.map(np.asarray,
                                   joptim.init(jparams[FIT_ARCH]))
    ranks = concurrent.futures.ThreadPoolExecutor(1).submit(
        tmesh.spawn, _fsdp_rank, 4, ref, str(d), timeout=400)

    want = {"logits": {}, "grads": {}, "loss": {}, "tokens": {}, "spread": {}}
    m1 = jcarve(jax.devices()[:1])
    for arch in archs:
        jcfg = jget(arch, smoke=True)
        if jcfg.moe_experts:
            jcfg = dataclasses.replace(jcfg, moe_capacity_factor=CAP)
        p = jparams[arch]
        b = {k: jnp.asarray(v) for k, v in ref["batch"][arch].items()}
        vg = jax.value_and_grad(lambda p, b: jtr.loss_fn(p, jcfg, b)[0])
        both = jax.jit(lambda p, b: (vg(p, b), jtr.forward(
            p, jcfg, **model_input(b))[0]))
        (loss, g), logits = both(p, b)
        want["loss"][arch] = float(loss)
        want["logits"][arch] = np.asarray(logits)
        want["grads"][arch] = convert.from_reference_tree(
            _np_tree(g), port_cfg(arch))
        if arch in SPREAD:
            want["spread"][arch] = reference_spread(
                lambda p, b: both(p, b)[0], p, b, g)
        if any(c[0] == arch for c in GREEDY):
            fr = b.get("frontend")
            want["tokens"][arch] = np.asarray(jserve.greedy_generate(
                p, jcfg, m1, jspecs[arch], jnp.asarray(ref["prompt"][arch]),
                NEW, frontend=None if fr is None else fr[:PROMPT[0]]))
    want["fit"] = _fit(port_cfg(FIT_ARCH), None, FIT_STEPS)
    jcfg = dataclasses.replace(jget(FIT_ARCH, smoke=True), fsdp=True)
    box = {}

    def init_fsdp(k):
        p, box["specs"] = jtr.init(k, jcfg)
        return p
    jax.eval_shape(init_fsdp, jax.random.PRNGKey(0))
    step = jtrain.make_train_step(jcfg, joptim.AdamWConfig(**STEP_OCFG), m1,
                                  box["specs"], compress_grads=True,
                                  donate=False)
    jp, _, jm = step(jparams[FIT_ARCH], jax.tree.map(jnp.asarray,
                                                     ref["step_opt"]),
                     jtrain.shard_batch(ref["batch"][FIT_ARCH], jcfg, m1))
    want["compressed"] = {"params": _np_tree(jp),
                          **{k: float(v) for k, v in jm.items()}}
    got = ranks.result()
    _, err = child.communicate(timeout=300)
    assert child.returncode == 0, err[-3000:]
    with np.load(d / "ref_ep.npz") as z:
        want["ep"] = dict(z)
    return got, want, ref


def ranks_of(got, case):
    return [o[case] for o in got if case in o]


def case_id(c) -> str:
    return f"{c[0]}-{c[1]}-{c[2]}"


# -- the cases -----------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_forward_matches_reference(run, case):
    """Each rank's logits of its rows equal the reference's rows at the
    family's one-process tolerance, on every rank of the mesh."""
    got, want, _ = run
    outs = ranks_of(got, case)
    assert len(outs) == SIZES[case[2]]
    tol = STACK_TOL.get(case[0], TOL)
    w = want["logits"][case[0]]
    for o in outs:
        a, b = o["rows"]
        np.testing.assert_allclose(o["logits"], w[a:b], rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_gradients_match_reference(run, case):
    """The loss of the global batch at 1e-5 and each rank's gradient of
    its part of each leaf (a block of one or two dimensions, ``Layout
    .take``) at 1e-4 of the reference's largest |g| of that leaf (jamba
    within twice the reference's own one-ulp spread): an FSDP leaf's
    gradient summed once over "data", the norm's leaves counted once."""
    got, want, _ = run
    arch = case[0]
    gap = 0.0
    for o in ranks_of(got, case):
        assert abs(o["loss"] - want["loss"][arch]) <= LOSS_TOL
        for k, w in want["grads"][arch].items():
            w = np.asarray(w)
            g = o["grads"][k]
            if g is None:       # the audio family's embed: no gradient
                assert not w.any(), k
                continue
            scale = np.abs(w).max()
            if k in o["parts"]:
                lay, i = o["parts"][k]
                w = lay.take(torch.from_numpy(w.copy()), i).numpy()
            assert g.shape == w.shape, k
            if scale:
                gap = max(gap, float(np.abs(g - w).max() / scale))
    if arch in SPREAD:
        reach = want["spread"][arch]
        assert reach > TOL and gap <= 2 * reach, (gap, reach)
    else:
        assert gap <= TOL, gap


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_placement_and_round_trip(run, case):
    """Every rank holds its part of each leaf the specs shard — FSDP's
    "data" entries and the experts' "model" entry included — and
    ``params_to_reference`` after ``params_from_reference`` gives the
    reference's tree back byte for byte."""
    import jax
    got, _, ref = run
    arch, mode, mesh = case
    cfg = port_cfg(arch, mode)
    for o in ranks_of(got, case):
        axes = {a for lay, _ in o["parts"].values() for a in lay.axes}
        want_axes = ({"data"} if mode != "published" and mesh != "m14"
                     else set()) | ({"model"} if mesh != "m41" else set())
        assert axes == want_axes, (axes, want_axes)
        if cfg.moe_experts and mesh != "m41":
            assert any(k.endswith("ffn.wi") and lay.split("model")
                       and lay.split("model").dim == 0
                       for k, (lay, _) in o["parts"].items())
        w = ref["params"][arch]
        assert jax.tree.structure(w) == jax.tree.structure(o["round_trip"])
        for a, b in zip(jax.tree.leaves(w), jax.tree.leaves(o["round_trip"])):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", sorted(GREEDY), ids=case_id)
def test_greedy_tokens_match_reference(run, case):
    """Greedy tokens on the mesh (each decode step gathers each layer's
    FSDP leaves) equal the reference's: each rank's streams on (2, 2);
    on (4, 1) the 2 streams do not split over 4 data ranks and every rank
    decodes them whole."""
    got, want, _ = run
    for o in ranks_of(got, case):
        a, b = o["token_rows"]
        assert b - a == (1 if case[2] == "m22" else 2)
        np.testing.assert_array_equal(o["tokens"],
                                      want["tokens"][case[0]][a:b])


@pytest.mark.parametrize("case", sorted(OPT), ids=case_id)
def test_optimizer_state_is_the_ranks_part(run, case):
    """``opt_state_from_reference`` on the mesh: each rank's master, mu
    and nu of each leaf equal its part of the reference's (a quarter of
    the sharded leaves' bytes on 4 ranks), and ``opt_state_to_reference``
    gives the reference's tree back byte for byte."""
    import jax
    got, _, ref = run
    whole = convert.from_reference_tree
    tree = ref["opt"][case[0]]
    cfg = port_cfg(*case[:2])
    for o in ranks_of(got, case):
        assert o["parts"]
        for k in ("master", "mu", "nu"):
            for name, w in whole(tree[k], cfg).items():
                t = torch.from_numpy(np.array(w))
                if name in o["parts"]:
                    lay, i = o["parts"][name]
                    t = lay.take(t, i)
                    n = 1
                    for s in lay.splits:
                        n *= s.n
                    assert o["opt"][k][name].size * n == w.size, name
                np.testing.assert_array_equal(o["opt"][k][name], t.numpy())
        back = o["opt_back"]
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_fit_restarts_onto_other_meshes(run):
    """``fit`` with FSDP on (2, 2): the uninterrupted losses at the
    one-process fit's (1e-5); stopped at a checkpoint (written whole by
    rank 0), two ranks lost, resumed on (1, 2) and, again from the same
    checkpoint, on (2, 1), each at the uninterrupted losses (1e-5)."""
    got, want, _ = run
    whole = got[0]["whole"]
    np.testing.assert_allclose(whole, want["fit"], rtol=1e-5, atol=1e-5)
    for o in got:
        assert o["whole"] == whole and o["first"] == whole[:FIT_STEPS // 2]
        assert o["mesh2"] == {"data": 1, "model": 2}
        assert o["mesh1"] == {"data": 2, "model": 1}
    for o in got[:2]:
        for mp in (2, 1):
            np.testing.assert_allclose(o[f"resumed{mp}"],
                                       whole[FIT_STEPS // 2:],
                                       rtol=1e-5, atol=1e-5)
    assert all("resumed2" not in o and "resumed1" not in o for o in got[2:])


def test_compressed_step_takes_each_fsdp_leaf_whole(run):
    """``compress_grads`` with FSDP on (4, 1): the loss at 1e-5, the
    learning rate exactly, the gradient norm at COMPRESSED_NORM and the
    parameters after the step at PARAM_TOL against the reference's
    compressed step on one device (tests/test_torch_train_mesh.py's
    bounds); every rank's parameters the same whole tree."""
    import jax
    got, want, _ = run
    w = want["compressed"]
    for o in got:
        o = o["compressed"]
        assert abs(o["loss"] - w["loss"]) <= LOSS_TOL
        assert o["lr"] == pytest.approx(w["lr"], rel=1e-7)
        assert abs(o["grad_norm"] - w["grad_norm"]) <= \
            COMPRESSED_NORM * w["grad_norm"]
        for a, b in zip(jax.tree.leaves(w["params"]),
                        jax.tree.leaves(o["params"])):
            np.testing.assert_allclose(np.asarray(b, np.float32),
                                       np.asarray(a, np.float32),
                                       rtol=PARAM_TOL, atol=PARAM_TOL)
    first = got[0]["compressed"]["params"]
    for o in got[1:]:
        for a, b in zip(jax.tree.leaves(first),
                        jax.tree.leaves(o["compressed"]["params"])):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("cap", CAPS)
def test_apply_ep_with_fsdp_matches_the_references(run, cap):
    """``apply_ep`` with ``fsdp`` on (2, 2): each rank holds 4 of the 8
    experts and half of their d rows (``wo``: columns) and of the
    router's; y of its row, the aux and the gradients of y.sum() + aux —
    the router's and its experts' parts, summed over "data" by the
    gathers' reduce-scatter, and its row of x — against the reference's
    ``apply_ep`` on 4 devices, at tests/test_torch_ep.py's 1e-5 of each
    leaf's largest |g|."""
    got, want, _ = run
    ref = want["ep"]
    for o in got:
        o = o[("layer", cap)]
        assert o["shapes"] == {"router": (16, 8), "wi": (4, 16, 32),
                               "wo": (4, 16, 16)}
        i = o["row"]
        np.testing.assert_allclose(o["y"], ref[f"{cap}/y"][i:i + 1],
                                   rtol=2e-4, atol=2e-4)
        assert abs(o["aux"] - float(ref[f"{cap}/aux"])) <= 1e-5
        for k in ("router", "wi", "wo"):
            w = torch.from_numpy(ref[f"{cap}/{k}"].copy())
            lay, idx = o["parts"][k]
            part = lay.take(w, idx).numpy()
            assert np.abs(o[k] - part).max() <= 1e-5 * np.abs(w.numpy()).max()
        gx = ref[f"{cap}/x"][i:i + 1]
        assert np.abs(o["x"] - gx).max() <= 1e-5 * np.abs(gx).max()


def test_two_axis_placement_leaf_by_leaf():
    """The combined placement on a (data 2, model 2) mesh, stated: rank
    (i, j) of the expert ``wi`` (E, d, 2f) ``P("model", "data", None)``
    holds expert block j and row block i; of the dense ``wi`` (d, 2f)
    ``P("data", "model")`` row block i and, on "model", gate block j and
    up block j side by side (the fused placement); of ``embed`` (V, d)
    ``P("model", "data")`` vocab block j and column block i; of ``wo``
    (f, d) ``P("model", "data")`` row block j and column block i.  Each
    axis's ``assemble`` of the ranks' parts is the whole, byte for byte."""
    g = torch.Generator().manual_seed(0)
    E, d, f, V = 4, 6, 8, 10
    leaves = {"layers.1.ffn.wi": (P("model", "data", None), (E, d, 2 * f)),
              "layers.0.ffn.wi": (P("data", "model"), (d, 2 * f)),
              "embed": (P("model", "data"), (V, d)),
              "layers.0.ffn.wo": (P("model", "data"), (f, d))}
    for name, (spec, shape) in leaves.items():
        w = torch.randn(shape, generator=g)
        lay = layers.layout(name, spec, shape, 2, 2)
        assert lay.axes == ("data", "model")
        parts = {(i, j): lay.take(w, {"data": i, "model": j})
                 for i in range(2) for j in range(2)}
        for (i, j), part in parts.items():
            if name == "layers.1.ffn.wi":
                want = w[j * 2:(j + 1) * 2, i * 3:(i + 1) * 3]
            elif name == "layers.0.ffn.wi":
                rows = w[i * 3:(i + 1) * 3]
                want = torch.cat([rows[:, j * 4:(j + 1) * 4],
                                  rows[:, f + j * 4:f + (j + 1) * 4]], 1)
            elif name == "embed":
                want = w[j * 5:(j + 1) * 5, i * 3:(i + 1) * 3]
            else:
                want = w[j * 4:(j + 1) * 4, i * 3:(i + 1) * 3]
            assert torch.equal(part, want), (name, i, j)
            assert part.shape == lay.local(shape)
        ds, ms = lay.split("data"), lay.split("model")
        rows = [ms.assemble([parts[(i, j)] for j in range(2)])
                for i in range(2)]
        assert torch.equal(ds.assemble(rows), w)


def test_check_ported_refuses_experts_and_data_that_do_not_divide():
    """Experts that do not divide over the "model" axis raise, whatever
    ``moe_ep`` says, naming the config and the axis; so does a "data"
    dimension that does not divide over the "data" axis of an FSDP
    config (TinyLlama SMOKE's d 64 over 3), naming the config, FSDP and
    the leaf; the same configs pass where they divide."""
    cfg = get_config("deepseek-moe-16b", smoke=True)
    for ep in (False, True):
        c = dataclasses.replace(cfg, moe_ep=ep)
        with pytest.raises(ValueError, match=r"deepseek-smoke: the 8 experts"
                                             r" do not split over 3 'model'"):
            transformer.check_ported(c, {"data": 1, "model": 3})
        transformer.check_ported(c, {"data": 2, "model": 2})
    fsdp = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                               fsdp=True)
    with pytest.raises(ValueError, match=r"tinyllama-smoke: FSDP over 3 data "
                                         r"ranks: embed: .* does not split "
                                         r"over 3 data ranks"):
        transformer.check_ported(fsdp, {"data": 3, "model": 1})
    transformer.check_ported(fsdp, {"data": 4, "model": 1})
    transformer.check_ported(get_config("tinyllama-1.1b", smoke=True),
                             {"data": 3, "model": 1})
