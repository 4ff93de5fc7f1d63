"""Port parity of expert parallelism (``moe.apply_ep``, the MoE layer on a
mesh, decode on a mesh) against ``repro``, in 8 gloo processes on the CPU.

One launch of 8 ranks (``launch.mesh.spawn``) runs every case; the
reference runs in this process (one device) and, for its ``apply_ep``, in
a subprocess on 8 forced host devices, at the same time as the ranks.

- The reference's own config (tests/test_multibank.py:60-84): d 32, f 16,
  E 8, K 2, float32, x (2, 16, 32), on a (data 2, model 4) mesh.
  - capacity factor 8.0 (no drop): ``y`` against the reference's
    ``moe.apply`` at its 2e-4; the gradients of ``y.sum() + aux`` (router,
    ``wi``, ``wo``, ``x``) against ``jax.grad`` of the same through
    ``moe.apply`` at GRAD_TOL, with ``apply_ep``'s aux: the mean over the
    data shards of each shard's own aux (``moe.py:186-188``), which is
    ``moe.apply``'s aux of each half.  The reference's own ``apply_ep``
    agrees with that target; ``moe.apply``'s aux of the whole batch is
    another number (ROADMAP queue 3).
  - capacity factor 0.5 (pairs drop, each data shard's capacity its
    own): ``y``, aux and the gradients against the reference's
    ``apply_ep``.
- DeepSeek SMOKE with ``moe_ep`` on a (1, 2) mesh: ``forward`` logits and
  ``greedy_generate`` tokens against the reference's one-device ones.
- A decode batch whose pairs drop (capacity factor 0.25, 32 streams) on a
  (2, 2) mesh: each data rank's logits against the reference's
  ``decode_step`` of the whole batch, whose MoE capacity counts all 32
  tokens (the global rule); decoding each half alone gives other logits.

Each rank computes the objective's gradient of its own rows
(``y.sum()`` of its rows + aux / data ranks) and the replicated leaves'
gradients are summed over "data": the objective of the whole batch.
"""
import concurrent.futures
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve
from repro_torch.models import convert, moe, transformer
from repro_torch.models.layers import ModelConfig
from repro_torch.runtime import elastic

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
#: the gradients of y.sum() + aux against jax.grad, relative to each
#: leaf's largest |g| (measured: a few 1e-7; the reference's own check of
#: its apply_ep is 5e-3)
GRAD_TOL = 1e-5
LAYER = dict(d_model=32, d_ff=16, moe_experts=8, moe_top_k=2)
CAPS = (8.0, 0.5)
DROP_CAP, DROP_STREAMS, DROP_STEPS = 0.25, 32, 3
ODD_PROMPT, ODD_NEW = (3, 6), 4         # 3 streams do not split over 2
SMOKE_PROMPT, SMOKE_NEW = (2, 8), 6

REF_EP = r"""
import sys; sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from repro.models import moe
from repro.models.layers import ModelConfig
from repro.core.compat import set_mesh
src = np.load(sys.argv[2])
params = {k: jnp.asarray(src[k]) for k in ("router", "wi", "wo")}
x = jnp.asarray(src["x"])
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for cap in (8.0, 0.5):
    cfg = ModelConfig(d_model=32, d_ff=16, moe_experts=8, moe_top_k=2,
                      moe_capacity_factor=cap, dtype=jnp.float32)
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


def layer_cfg(cap: float, ep: bool = True) -> ModelConfig:
    return ModelConfig(**LAYER, moe_capacity_factor=cap, dtype=torch.float32,
                       moe_ep=ep)


# -- the ranks ----------------------------------------------------------------------

def _layer_case(mesh, ref: dict, cap: float) -> dict:
    """apply_ep on the rank's rows; the objective's gradients summed over
    "data" for the replicated router and the rank's experts."""
    cfg = layer_cfg(cap)
    p = moe.MoE(cfg, device="cpu", mesh=mesh)
    convert._load(p, {k: ref[k] for k in ("router", "wi", "wo")}, "moe")
    p.requires_grad_(True)
    i, D = mesh.get_local_rank("data"), 2
    x = torch.from_numpy(ref["x"][i:i + 1].copy()).requires_grad_(True)
    y, aux = moe.apply_ep(p, cfg, x, mesh=mesh)
    leaves = [p.router, p.wi, p.wo, x]
    g = torch.autograd.grad(y.sum() + aux / D, leaves)
    g = [sharding.all_reduce(t.clone(), mesh, "data") for t in g[:3]] + [g[3]]
    return {"experts": (p.experts.start, p.experts.stop), "row": i,
            "y": y.detach().numpy(), "aux": float(aux.detach()),
            **{k: t.numpy() for k, t in zip(("router", "wi", "wo", "x"), g)}}


def _smoke_case(mesh, ref: dict) -> dict:
    cfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                              moe_ep=True)
    model = convert.params_from_reference(ref["smoke_params"], cfg,
                                          device="cpu", mesh=mesh)
    with torch.no_grad():
        logits, aux = transformer.forward(model, cfg, ref["smoke_tokens"])
    tokens = serve.greedy_generate(model, cfg, ref["smoke_prompt"], SMOKE_NEW)
    return {"logits": logits.numpy(), "aux": float(aux),
            "tokens": tokens.numpy(),
            "wi": tuple(model.layers[1].ffn.wi.shape)}


def _decode_case(mesh, ref: dict) -> dict:
    cfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                              moe_ep=True, moe_capacity_factor=DROP_CAP)
    model = convert.params_from_reference(ref["smoke_params"], cfg,
                                          device="cpu", mesh=mesh)
    toks = torch.from_numpy(ref["drop_tokens"])
    cache = serve.make_cache(model, cfg, DROP_STREAMS, DROP_STEPS)
    step = serve.make_serve_step(cfg, batch=DROP_STREAMS)
    r = serve.rows(DROP_STREAMS, mesh)
    out = []
    with torch.no_grad(), moe_routing() as log:
        for t in range(DROP_STEPS):
            logits, cache = step(model, cache, toks[r, t:t + 1])
            out.append(logits)
    odd = serve.greedy_generate(model, cfg, ref["odd_prompt"], ODD_NEW)
    return {"rows": (r.start, r.stop), "logits": torch.cat(out, 1).numpy(),
            "dropped": sum(d for _, d in log), "odd": odd.numpy()}


class moe_routing:
    def __enter__(self):
        moe.apply.routing = []
        return moe.apply.routing

    def __exit__(self, *exc):
        moe.apply.routing = None


def _ep_rank(rank: int, ref: dict) -> dict:
    """Every case on this rank; every rank builds every mesh (their
    groups are made on the whole world) and runs the cases it is in."""
    m24 = elastic.carve_mesh(model_parallel=4, device_type="cpu")
    m12 = elastic.carve_mesh([0, 1], model_parallel=2, device_type="cpu")
    m22 = elastic.carve_mesh([0, 1, 2, 3], model_parallel=2,
                             device_type="cpu")
    out = {cap: _layer_case(m24, ref, cap) for cap in CAPS}
    if sharding.member(m12):
        out["smoke"] = _smoke_case(m12, ref)
    if sharding.member(m22):
        out["decode"] = _decode_case(m22, ref)
    return out


# -- the reference and the run ----------------------------------------------------------

def _np_tree(tree):
    import jax
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.launch import serve as jserve
    from repro.models import moe as jmoe
    from repro.models import transformer as jtr
    from repro.models.layers import ModelConfig as JCfg
    from repro.runtime.elastic import carve_mesh as jcarve

    d = tmp_path_factory.mktemp("ep")
    jcfg = JCfg(**LAYER, moe_capacity_factor=8.0, dtype=jnp.float32)
    params, _ = jmoe.init(jax.random.PRNGKey(0), jcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 16, 32), jnp.float32)
    ref = {k: np.asarray(v) for k, v in params.items()}
    ref["x"] = np.asarray(x)
    np.savez(d / "layer.npz", **ref)
    child = subprocess.Popen(
        [sys.executable, "-c", REF_EP, SRC, str(d / "layer.npz"),
         str(d / "ref_ep.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    scfg = jget("deepseek-moe-16b", smoke=True)
    box = {}

    def init(k):
        p, box["specs"] = jtr.init(k, scfg)
        return p
    sparams = jax.jit(init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    ref["smoke_params"] = _np_tree(sparams)
    ref["smoke_tokens"] = rng.integers(0, scfg.vocab, (2, 12)).astype(np.int32)
    ref["smoke_prompt"] = rng.integers(0, scfg.vocab,
                                       SMOKE_PROMPT).astype(np.int32)
    ref["drop_tokens"] = rng.integers(
        0, scfg.vocab, (DROP_STREAMS, DROP_STEPS)).astype(np.int32)
    ref["odd_prompt"] = rng.integers(0, scfg.vocab,
                                     ODD_PROMPT).astype(np.int32)
    # the ranks run while this process computes the reference
    ranks = concurrent.futures.ThreadPoolExecutor(1).submit(
        tmesh.spawn, _ep_rank, 8, ref, timeout=240)

    want = {"y": np.asarray(jmoe.apply(params, jcfg, x)[0])}

    def target(p, xx):
        y, _ = jmoe.apply(p, jcfg, xx)
        halves = [jmoe.apply(p, jcfg, xx[i:i + 1])[1] for i in (0, 1)]
        return y.sum() + (halves[0] + halves[1]) / 2
    gp, gx = jax.jit(jax.grad(target, argnums=(0, 1)))(params, x)
    want |= {k: np.asarray(v) for k, v in gp.items()} | {"x": np.asarray(gx)}
    want["aux_halves"] = float(sum(jmoe.apply(params, jcfg, x[i:i + 1])[1]
                                   for i in (0, 1)) / 2)
    want["aux_whole"] = float(jmoe.apply(params, jcfg, x)[1])

    want["smoke_logits"], want["smoke_aux"] = map(np.asarray, jax.jit(
        lambda p, t: jtr.forward(p, scfg, t))(
            sparams, jnp.asarray(ref["smoke_tokens"])))
    m1 = jcarve(jax.devices()[:1])
    want["smoke_tokens"] = np.asarray(jserve.greedy_generate(
        sparams, scfg, m1, box["specs"], jnp.asarray(ref["smoke_prompt"]),
        SMOKE_NEW))

    dcfg = dataclasses.replace(scfg, moe_capacity_factor=DROP_CAP)
    want["odd"] = np.asarray(jserve.greedy_generate(
        sparams, dcfg, m1, box["specs"], jnp.asarray(ref["odd_prompt"]),
        ODD_NEW))
    step = jax.jit(lambda p, t, c: jtr.decode_step(p, dcfg, t, c))

    def decode(toks):
        cache = jtr.init_cache(sparams, dcfg, toks.shape[0], DROP_STEPS)
        out = []
        for t in range(DROP_STEPS):
            lg, cache = step(sparams, jnp.asarray(toks[:, t:t + 1]), cache)
            out.append(np.asarray(lg))
        return np.concatenate(out, 1)
    want["drop_whole"] = decode(ref["drop_tokens"])
    half = DROP_STREAMS // 2
    want["drop_halves"] = np.concatenate(
        [decode(ref["drop_tokens"][:half]), decode(ref["drop_tokens"][half:])])

    got = ranks.result()
    _, err = child.communicate(timeout=240)
    assert child.returncode == 0, err[-3000:]
    with np.load(d / "ref_ep.npz") as z:
        ref_ep = dict(z)
    return got, want, ref_ep


# -- the cases ----------------------------------------------------------------------------

def test_ep_forward_equals_apply(run):
    """y of every rank's rows against the reference's moe.apply at its
    2e-4 (no pair drops at factor 8.0); each model rank holds its 2
    experts."""
    got, want, _ = run
    for rank, o in enumerate(got):
        o = o[8.0]
        assert o["experts"] == (2 * (rank % 4), 2 * (rank % 4) + 2)
        np.testing.assert_allclose(o["y"], want["y"][o["row"]:o["row"] + 1],
                                   rtol=2e-4, atol=2e-4)
        assert abs(o["aux"] - want["aux_halves"]) <= 1e-6


@pytest.mark.parametrize("leaf", ["router", "wi", "wo", "x"])
def test_ep_gradients_equal_jax_grad(run, leaf):
    """The gradient of y.sum() + aux against jax.grad through moe.apply
    (aux: the mean of the data halves'), at GRAD_TOL of the leaf's
    largest |g|: the combine's gradient counted once per model rank, the
    router's and the tokens' summed over the model ranks' pairs, aux's
    once."""
    got, want, _ = run
    for o in got:
        o = o[8.0]
        w = want[leaf]
        if leaf in ("wi", "wo"):
            w = w[slice(*o["experts"])]
        elif leaf == "x":
            w = w[o["row"]:o["row"] + 1]
        scale = np.abs(want[leaf]).max()
        assert np.abs(o[leaf] - w).max() <= GRAD_TOL * scale, leaf


def test_reference_apply_ep_agrees_with_the_target(run):
    """The reference's own apply_ep (8 forced host devices) has the
    gradient of the per-shard aux (the port's target), not that of
    moe.apply's aux of the whole batch."""
    _, want, ref_ep = run
    assert abs(float(ref_ep["8.0/aux"]) - want["aux_halves"]) <= 1e-6
    assert abs(want["aux_halves"] - want["aux_whole"]) > 1e-3
    for leaf in ("router", "wi", "wo", "x"):
        scale = np.abs(want[leaf]).max()
        assert np.abs(ref_ep[f"8.0/{leaf}"] - want[leaf]).max() <= \
            GRAD_TOL * scale, leaf


@pytest.mark.parametrize("part", ["y", "aux", "router", "wi", "wo", "x"])
def test_ep_with_drops_equals_reference_apply_ep(run, part):
    """Capacity factor 0.5: each data shard's capacity (8 slots) drops
    pairs; the port against the reference's apply_ep."""
    got, _, ref_ep = run
    for o in got:
        o = o[0.5]
        w = ref_ep[f"0.5/{part}"]
        if part == "aux":
            assert abs(o["aux"] - float(w)) <= 1e-6
            continue
        if part in ("wi", "wo"):
            w = w[slice(*o["experts"])]
        elif part in ("x", "y"):
            w = w[o["row"]:o["row"] + 1]
        scale = max(np.abs(ref_ep[f"0.5/{part}"]).max(), 1.0)
        assert np.abs(o[part] - w).max() <= GRAD_TOL * scale, part


def test_deepseek_smoke_ep_forward_and_greedy(run):
    """DeepSeek SMOKE with moe_ep on a (1, 2) mesh: each rank holds 4 of
    the 8 experts; logits at 1e-4 and aux at 1e-6 against the reference's
    one-device forward; greedy tokens identical."""
    got, want, _ = run
    for o in got[:2]:
        assert o["smoke"]["wi"][0] == 4
        np.testing.assert_allclose(o["smoke"]["logits"], want["smoke_logits"],
                                   rtol=1e-4, atol=1e-4)
        assert abs(o["smoke"]["aux"] - float(want["smoke_aux"])) <= 1e-6
        assert (o["smoke"]["tokens"] == want["smoke_tokens"]).all()
    assert all("smoke" not in o for o in got[2:])


def test_decode_routes_the_whole_batch(run):
    """32 streams at capacity factor 0.25 on a (2, 2) mesh: pairs drop,
    and every data rank's logits equal the reference's decode of the whole
    batch (capacity and ranks over all 32 tokens), which differs from
    decoding each half on its own."""
    got, want, _ = run
    assert np.abs(want["drop_whole"] - want["drop_halves"]).max() > 1e-3
    assert sum(o["decode"]["dropped"] for o in got[:4]) > 0
    for o in got[:4]:
        o = o["decode"]
        np.testing.assert_allclose(o["logits"],
                                   want["drop_whole"][slice(*o["rows"])],
                                   rtol=1e-4, atol=1e-4)


def test_decode_batch_that_does_not_split_is_replicated(run):
    """3 streams on a (2, 2) mesh: 3 does not split over 2 data ranks, so
    every rank decodes all 3 (the reference's ``batch % data`` rule) with
    its experts combined over "model", and the greedy tokens equal the
    reference's one-device ones."""
    got, want, _ = run
    for o in got[:4]:
        assert (o["decode"]["odd"] == want["odd"]).all()
