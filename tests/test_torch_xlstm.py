"""Port parity for the xLSTM family: ``repro_torch.models.xlstm`` (the mLSTM
in its parallel and chunked forms and its O(1) decode, the sLSTM
recurrence and its decode) and the ``xlstm-smoke`` stack around them,
against ``repro`` on the CPU.

The reference's seeded weights go through the weight carry
(``models.convert``) into the port's modules, and the same numpy inputs
through both packages.  No Pallas kernel runs here in either package.

Tolerances: float32 at rtol = atol = 1e-4 (both sides compute in float32
and differ in the order of their sums: the reference's associative scan
over chunks against a loop, XLA's cumsum against torch's); the chunked
mLSTM against the parallel one at 1e-4, the reference's own
(tests/test_kernels.py ``test_chunked_mlstm_matches_parallel``);
teacher-forced decode against the prefill at 2e-2, as
tests/test_models.py holds it; greedy tokens identical.  bfloat16: each
mixer is held to the reference in bfloat16 within twice the reference's
own bfloat16 error, its largest distance from the same computation in
float32 on the same (bfloat16) weights and inputs (``bf16_tolerance``):
the two packages round at the same points, and a matmul's bfloat16
result may land one rounding step apart, no further than bfloat16
itself moves the reference.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.models import transformer as jt
from repro.models import xlstm as jx
from repro.runtime.elastic import carve_mesh
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import convert, transformer, xlstm

# the whole suite runs in 6 pytest workers on 8 cores: two intra-op threads
# a worker keep these modules from starving the reference's timing-gated tests
torch.set_num_threads(2)

ARCH = "xlstm-125m"
TOL = 1e-4
CONSISTENCY_TOL = 2e-2
CHUNKS = [8, 32, 64]
#: the reference's sharding specs of the arch's params (greedy_generate's)
SPECS: dict = {}


def cfgs(dtype=None):
    """(reference, port) SMOKE configs, float32 or both in ``dtype``
    ("bfloat16")."""
    jcfg, tcfg = jget(ARCH, smoke=True), get_config(ARCH, smoke=True)
    if dtype == "bfloat16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    return jcfg, tcfg


@functools.cache
def carried(seed: int = 1):
    """(reference cfg, reference params, port cfg, port model) of the
    xlstm-smoke stack on one set of reference weights."""
    jcfg, tcfg = cfgs()

    def init(key):
        params, SPECS[ARCH] = jt.init(key, jcfg)
        return params

    params = jax.jit(init)(jax.random.PRNGKey(seed))
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu")
    return jcfg, params, tcfg, model


def mixer(kind: str, dtype=None, seed: int = 0):
    """(reference cfg, reference params, port cfg, port module) of one
    mixer (``"mlstm"`` or ``"slstm"``) on the reference's weights."""
    jcfg, tcfg = cfgs(dtype)
    init = jx.init_mlstm if kind == "mlstm" else jx.init_slstm
    params, _ = init(jax.random.PRNGKey(seed), jcfg)
    mod = (xlstm.MLSTM if kind == "mlstm" else xlstm.SLSTM)(tcfg,
                                                            device="cpu")
    convert._load(mod, jax.tree.map(np.asarray, params), kind)
    return jcfg, params, tcfg, mod


def inputs(d: int, B=2, S=64, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


def tokens(cfg, B=2, S=16, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# -- the mLSTM ---------------------------------------------------------------------

def test_apply_mlstm_matches_reference():
    jcfg, params, tcfg, mod = mixer("mlstm")
    x = inputs(tcfg.d_model)
    want = jx.apply_mlstm(params, jcfg, jnp.asarray(x))
    got = xlstm.apply_mlstm(mod, tcfg, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_apply_mlstm_chunked_matches_reference(chunk):
    jcfg, params, tcfg, mod = mixer("mlstm")
    x = inputs(tcfg.d_model)
    want = jx.apply_mlstm_chunked(params, jcfg, jnp.asarray(x), chunk=chunk)
    got = xlstm.apply_mlstm_chunked(mod, tcfg, torch.from_numpy(x),
                                    chunk=chunk)
    close(got, want)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_mlstm_matches_parallel(chunk):
    """The reference's own check on the port, at its tolerance."""
    _, _, tcfg, mod = mixer("mlstm")
    x = torch.from_numpy(inputs(tcfg.d_model))
    close(xlstm.apply_mlstm_chunked(mod, tcfg, x, chunk=chunk),
          xlstm.apply_mlstm(mod, tcfg, x).numpy())


def test_chunked_mlstm_refuses_a_chunk_that_does_not_divide():
    _, _, tcfg, mod = mixer("mlstm")
    with pytest.raises(AssertionError, match="divide"):
        xlstm.apply_mlstm_chunked(mod, tcfg,
                                  torch.from_numpy(inputs(tcfg.d_model)),
                                  chunk=24)


def test_decode_mlstm_matches_reference():
    """Token by token over 12 positions: each output and the (C, n, m)
    state; m starts at -1e30 on both sides."""
    jcfg, params, tcfg, mod = mixer("mlstm")
    x = inputs(tcfg.d_model, S=12)
    jcache = jx.init_mlstm_cache(jcfg, 2)
    tcache = xlstm.init_mlstm_cache(tcfg, 2, device="cpu")
    assert float(tcache["m"].max()) == float(np.float32(-1e30))
    for t in range(12):
        want, jcache = jx.decode_mlstm(params, jcfg, jnp.asarray(x[:, t:t + 1]),
                                       jcache)
        got, tcache = xlstm.decode_mlstm(mod, tcfg,
                                         torch.from_numpy(x[:, t:t + 1]),
                                         tcache)
        close(got, want)
    for k in ("C", "n", "m"):
        assert tcache[k].dtype == torch.float32
        close(tcache[k], jcache[k])


# -- the sLSTM ---------------------------------------------------------------------

def test_apply_slstm_matches_reference():
    jcfg, params, tcfg, mod = mixer("slstm")
    x = inputs(tcfg.d_model, S=24)
    want = jx.apply_slstm(params, jcfg, jnp.asarray(x))
    got = xlstm.apply_slstm(mod, tcfg, torch.from_numpy(x))
    assert got.shape == x.shape
    close(got, want)


def test_decode_slstm_matches_reference():
    jcfg, params, tcfg, mod = mixer("slstm")
    x = inputs(tcfg.d_model, S=12)
    jcache = jx.init_slstm_cache(jcfg, 2)
    tcache = xlstm.init_slstm_cache(tcfg, 2, device="cpu")
    for t in range(12):
        want, jcache = jx.decode_slstm(params, jcfg, jnp.asarray(x[:, t:t + 1]),
                                       jcache)
        got, tcache = xlstm.decode_slstm(mod, tcfg,
                                         torch.from_numpy(x[:, t:t + 1]),
                                         tcache)
        close(got, want)
    for k in ("c", "n", "m"):
        close(tcache[k], jcache[k])


def test_slstm_decode_reproduces_its_prefill():
    """The recurrence run step by step is the sequence form's loop."""
    _, _, tcfg, mod = mixer("slstm")
    x = torch.from_numpy(inputs(tcfg.d_model, S=10))
    cache = xlstm.init_slstm_cache(tcfg, 2, device="cpu")
    outs = []
    for t in range(10):
        y, cache = xlstm.decode_slstm(mod, tcfg, x[:, t:t + 1], cache)
        outs.append(y)
    close(torch.cat(outs, 1), xlstm.apply_slstm(mod, tcfg, x).numpy())


# -- bfloat16 ----------------------------------------------------------------------

def _mixer_runs(kind: str, fn: str, jcfg, params, tcfg, mod, x):
    """One mixer function of both packages on ``x`` (B, S, d) float32
    numpy, cast to the configs' dtype: (reference out, port out); the
    decode functions run token by token and return every step's output."""
    xj = jnp.asarray(x).astype(jcfg.dtype)
    xt = torch.from_numpy(x).to(tcfg.dtype)
    if fn.startswith("decode"):
        jinit = jx.init_mlstm_cache if kind == "mlstm" else jx.init_slstm_cache
        tinit = (xlstm.init_mlstm_cache if kind == "mlstm"
                 else xlstm.init_slstm_cache)
        jdec, tdec = getattr(jx, fn), getattr(xlstm, fn)
        jc, tc, jo, to = jinit(jcfg, 2), tinit(tcfg, 2, device="cpu"), [], []
        for t in range(x.shape[1]):
            y, jc = jdec(params, jcfg, xj[:, t:t + 1], jc)
            jo.append(np.asarray(y.astype(jnp.float32)))
            y, tc = tdec(mod, tcfg, xt[:, t:t + 1], tc)
            to.append(y.float().numpy())
        return np.concatenate(jo, 1), np.concatenate(to, 1)
    kw = {"chunk": 8} if fn == "apply_mlstm_chunked" else {}
    want = getattr(jx, fn)(params, jcfg, xj, **kw)
    got = getattr(xlstm, fn)(mod, tcfg, xt, **kw)
    assert got.dtype == tcfg.dtype
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


def bf16_tolerance(kind: str, fn: str, x) -> tuple[float, float]:
    """(the port's largest gap from the reference in bfloat16, the
    reference's own bfloat16 error: its largest distance from the same
    function in float32 on the bfloat16 weights and inputs)."""
    jcfg, params, tcfg, mod = mixer(kind, "bfloat16")
    want, got = _mixer_runs(kind, fn, jcfg, params, tcfg, mod, x)
    jcfg32 = dataclasses.replace(jcfg, dtype=jnp.float32)
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    xr = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    exact, _ = _mixer_runs(kind, fn, jcfg32, params32, cfgs()[1],
                           mixer(kind)[3], xr)
    return float(np.abs(got - want).max()), float(np.abs(want - exact).max())


@pytest.mark.parametrize("kind,fn", [
    ("mlstm", "apply_mlstm"), ("mlstm", "apply_mlstm_chunked"),
    ("mlstm", "decode_mlstm"), ("slstm", "apply_slstm"),
    ("slstm", "decode_slstm")])
def test_bfloat16_mixers_match_reference(kind, fn):
    """Each mixer in bfloat16 against the reference in bfloat16, held
    within twice the reference's own bfloat16 error (module docstring)."""
    gap, own = bf16_tolerance(kind, fn, inputs(64, S=16, seed=7))
    assert own > 0 and gap <= 2 * own, (gap, own)


# -- the stack ---------------------------------------------------------------------

def test_layer_plan_and_build():
    """xlstm-125m: [mlstm x3, slstm] x 3, no FFN, no prologue; the SMOKE
    config one such period.  Both build on the CPU, and the model's
    parameters are the reference's keys."""
    pro, period, repeats = transformer.layer_plan(get_config(ARCH))
    assert not pro and repeats == 3
    assert [d["mixer"] for d in period] == ["mlstm"] * 3 + ["slstm"]
    assert {d["ffn"] for d in period} == {"none"}
    transformer.check_ported(get_config(ARCH))
    _, params, tcfg, model = carried()
    names = {n.split(".", 2)[2] for n in dict(model.named_parameters())
             if n.startswith("layers.")}
    leaves = {".".join(str(getattr(k, "key", k)) for k in path)
              for g in params["group"]
              for path, _ in jax.tree_util.tree_flatten_with_path(g)[0]}
    assert names == leaves
    built = transformer.init(tcfg, device="cpu")
    assert [type(b.mixer) for b in built.layers] == \
        [xlstm.MLSTM] * 3 + [xlstm.SLSTM]


@pytest.mark.parametrize("mlstm_chunk", [0, 8])
def test_forward_matches_reference(mlstm_chunk):
    """The xlstm-smoke stack's logits, the mLSTM parallel (``mlstm_chunk``
    0) or chunked by 8 (which divides the 16 tokens)."""
    jcfg, params, tcfg, model = carried()
    jcfg = dataclasses.replace(jcfg, mlstm_chunk=mlstm_chunk)
    tcfg = dataclasses.replace(tcfg, mlstm_chunk=mlstm_chunk)
    toks = tokens(tcfg)
    want, jaux = jax.jit(lambda p, t: jt.forward(p, jcfg, tokens=t))(
        params, jnp.asarray(toks))
    got, aux = transformer.forward(model, tcfg, torch.from_numpy(toks))
    assert got.shape == (2, 16, tcfg.vocab)
    close(got, want)
    assert float(aux) == float(jaux) == 0.0


def test_decode_step_matches_reference():
    """Teacher-forced decode on both packages, step by step (the
    reference's step jitted, as its server runs it)."""
    jcfg, params, tcfg, model = carried()
    toks = tokens(tcfg, B=1, S=12)
    jstep = jax.jit(jt.decode_step, static_argnums=1)
    jcache = jt.init_cache(params, jcfg, 1, 16)
    tcache = transformer.init_cache(model, tcfg, 1, 16)
    for i in range(12):
        want, jcache = jstep(params, jcfg, jnp.asarray(toks[:, i:i + 1]),
                             jcache)
        got, tcache = transformer.decode_step(
            model, tcfg, torch.from_numpy(toks[:, i:i + 1]), tcache)
        close(got, want)
    assert [set(c) for c in tcache["layers"]] == \
        [{"C", "n", "m"}] * 3 + [{"c", "n", "m"}]


@pytest.mark.parametrize("mlstm_chunk", [0, 4])
def test_prefill_decode_consistency(mlstm_chunk):
    """tests/test_models.py's check on the port: teacher-forced
    ``decode_step`` reproduces ``forward``'s logits."""
    _, _, tcfg, model = carried()
    tcfg = dataclasses.replace(tcfg, mlstm_chunk=mlstm_chunk)
    toks = torch.from_numpy(tokens(tcfg, B=1, S=12, seed=5))
    full, _ = transformer.forward(model, tcfg, toks)
    cache = transformer.init_cache(model, tcfg, 1, 16)
    outs = []
    for i in range(12):
        lt, cache = transformer.decode_step(model, tcfg, toks[:, i:i + 1],
                                            cache)
        outs.append(lt)
    close(torch.cat(outs, dim=1), full.numpy(), CONSISTENCY_TOL)


def test_greedy_generate_matches_reference():
    """The same tokens as the reference's, 2 streams x (4 + 6)."""
    jcfg, params, tcfg, model = carried()
    prompt = tokens(tcfg, B=2, S=4, seed=11)
    mesh = carve_mesh(jax.devices(), model_parallel=1)
    want = np.asarray(jserve.greedy_generate(params, jcfg, mesh, SPECS[ARCH],
                                             jnp.asarray(prompt), max_new=6))
    got = serve.greedy_generate(model, tcfg, prompt, 6)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def stack_gaps(S: int = 512, chunk: int = 256, seed: int = 0):
    """xlstm-125m FULL in float32 at S positions, the reference's seeded
    weights carried across: the largest relative gap (|a - b| / (1 +
    |b|)) between the parallel and the chunked stack's logits, for the
    reference and for the port (what chip_smoke.py prints for the port at
    2,048 positions on the card).  ~20 s on the CPU; not a test."""
    jcfg = dataclasses.replace(jget(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(ARCH), dtype=torch.float32)
    params = jax.jit(lambda k: jt.init(k, jcfg)[0])(jax.random.PRNGKey(seed))
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (1, S)
                                             ).astype(np.int32)

    def gap(a, b):
        return float((np.abs(a - b) / (1 + np.abs(b))).max())

    ref = [np.asarray(jax.jit(lambda p, t, c=c: jt.forward(
        p, dataclasses.replace(jcfg, mlstm_chunk=c), tokens=t)[0])(
            params, jnp.asarray(toks))) for c in (0, chunk)]
    port = [transformer.forward(model, dataclasses.replace(
        tcfg, mlstm_chunk=c), torch.from_numpy(toks))[0].numpy()
        for c in (0, chunk)]
    return gap(*ref), gap(*port)


if __name__ == "__main__":
    for kind, fn in [("mlstm", "apply_mlstm"), ("mlstm", "apply_mlstm_chunked"),
                     ("mlstm", "decode_mlstm"), ("slstm", "apply_slstm"),
                     ("slstm", "decode_slstm")]:
        gap, own = bf16_tolerance(kind, fn, inputs(64, S=16, seed=7))
        print(f"{fn:20s} bfloat16 gap {gap:.3e}, reference's own error "
              f"{own:.3e}")
    ref, port = stack_gaps()
    print(f"xlstm-125m FULL float32, 512 positions: parallel vs chunked "
          f"(256) stack logits, relative: reference {ref:.3e}, port "
          f"{port:.3e}")
