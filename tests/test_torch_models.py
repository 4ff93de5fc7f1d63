"""Port parity: the model stack of ``repro_torch`` (configs, layers,
attention, transformer, the weight carry) against ``repro``.

The reference's seeded ``transformer.init`` weights go through
``models.convert.params_from_reference`` into the port's model on the CPU;
then the same numpy tokens go through both packages' ``forward`` (with
``use_kernel`` True and False; the reference's Pallas kernel runs in
interpret mode), ``decode_step`` and their prefill/decode consistency,
for the SMOKE configs of the dense-attention family: tinyllama, h2o-danube
(window 16), codeqwen (``qkv_bias``) and stablelm (``parallel_block``).
float32 logits agree at rtol = atol = 1e-4: both sides compute in float32
and differ only in the order of their sums.  The MoE and hybrid families
have their own file, tests/test_torch_moe_hybrid.py, as have the xLSTM
(tests/test_torch_xlstm.py) and VLM (tests/test_torch_vlm.py) families.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, get_config as jget
from repro.models import layers as jlayers
from repro.models import transformer as jt
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import convert, layers, transformer

# the whole suite runs in 6 pytest workers on 8 cores: two intra-op threads
# a worker keep these modules from starving the reference's timing-gated tests
torch.set_num_threads(2)

DENSE = ["tinyllama-1.1b", "h2o-danube-3-4b", "codeqwen1.5-7b", "stablelm-12b"]
TOL = 1e-4


@functools.cache
def carried(arch: str, seed: int = 1):
    """(reference cfg, reference params, port cfg, port model) on one set
    of reference weights."""
    jcfg, tcfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    params, _ = jt.init(jax.random.PRNGKey(seed), jcfg)
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu")
    return jcfg, params, tcfg, model


def tokens(cfg, B=2, S=20, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# -- configs --------------------------------------------------------------------

def test_archs_mirror_reference():
    assert ARCHS == JARCHS


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_are_the_reference_data(arch, smoke):
    t, j = get_config(arch, smoke=smoke), jget(arch, smoke=smoke)
    tf, jf = dataclasses.asdict(t), dataclasses.asdict(j)
    assert str(tf.pop("dtype")).removeprefix("torch.") == \
        jnp.dtype(jf.pop("dtype")).name
    assert tf == jf
    assert t.hd == j.hd
    assert t.total_params() == j.total_params()
    assert t.active_params() == j.active_params()
    assert transformer.layer_plan(t) == jt.layer_plan(j)


# -- primitives --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_primitives_match_reference(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    tol = TOL if dtype == torch.float32 else 2e-2
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 8, 16)).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    pos = np.arange(8)[None, None, :] + np.array([[[0]], [[5]]])
    wi = rng.normal(size=(16, 24)).astype(np.float32)
    wo = rng.normal(size=(12, 16)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dtype)           # noqa: E731
    j = lambda a: jnp.asarray(a, jdt)                     # noqa: E731
    for got, want in (
            (layers.rms_norm(t(x), t(scale)), jlayers.rms_norm(j(x), j(scale))),
            (layers.rope(t(x), torch.from_numpy(pos)),
             jlayers.rope(j(x), jnp.asarray(pos))),
            (layers.swiglu(t(x), t(wi), t(wo)),
             jlayers.swiglu(j(x), j(wi), j(wo)))):
        assert got.dtype == dtype
        close(got, want, tol)


# -- forward, decode, consistency ---------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch, use_kernel):
    jcfg, params, tcfg, model = carried(arch)
    toks = tokens(tcfg)
    want, jaux = jt.forward(params, jcfg, tokens=jnp.asarray(toks),
                            use_kernel=use_kernel)
    got, aux = transformer.forward(model, tcfg, torch.from_numpy(toks),
                                   use_kernel=use_kernel)
    assert got.shape == (2, 20, tcfg.vocab) and got.dtype == torch.float32
    close(got, want)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_reference(arch):
    """Teacher-forced decode on both packages, step by step."""
    jcfg, params, tcfg, model = carried(arch)
    toks = tokens(tcfg, B=1, S=12)
    jcache = jt.init_cache(params, jcfg, 1, 16)
    tcache = transformer.init_cache(model, tcfg, 1, 16)
    for i in range(12):
        want, jcache = jt.decode_step(params, jcfg,
                                      jnp.asarray(toks[:, i:i + 1]), jcache)
        got, tcache = transformer.decode_step(
            model, tcfg, torch.from_numpy(toks[:, i:i + 1]), tcache)
        assert got.shape == (1, 1, tcfg.vocab)
        close(got, want)
    assert [int(c["len"][0]) for c in tcache["layers"]] == [12] * tcfg.n_layers


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(arch):
    """The reference's tests/test_models.py check on the port: teacher-forced
    ``decode_step`` reproduces ``forward(use_kernel=True)``'s logits."""
    _, _, tcfg, model = carried(arch)
    toks = torch.from_numpy(tokens(tcfg, B=1, S=24, seed=5))
    full, _ = transformer.forward(model, tcfg, toks, use_kernel=True)
    cache = transformer.init_cache(model, tcfg, 1, 28)
    outs = []
    for i in range(24):
        lt, cache = transformer.decode_step(model, tcfg, toks[:, i:i + 1],
                                            cache)
        outs.append(lt)
    close(torch.cat(outs, dim=1), full.numpy())


def test_fast_decode_matches_reference():
    """``fast_decode`` (grouped decode attention) on both packages."""
    jcfg, params, tcfg, model = carried("h2o-danube-3-4b")
    jcfg = dataclasses.replace(jcfg, fast_decode=True)
    tcfg = dataclasses.replace(tcfg, fast_decode=True)
    toks = tokens(tcfg, B=1, S=20)
    jcache = jt.init_cache(params, jcfg, 1, 20)
    tcache = transformer.init_cache(model, tcfg, 1, 20)
    for i in range(20):       # past the window of 16
        want, jcache = jt.decode_step(params, jcfg,
                                      jnp.asarray(toks[:, i:i + 1]), jcache)
        got, tcache = transformer.decode_step(
            model, tcfg, torch.from_numpy(toks[:, i:i + 1]), tcache)
        close(got, want)


def test_embeds_input_matches_reference():
    """The audio family feeds frame embeddings instead of tokens."""
    jcfg, params, tcfg, model = carried("musicgen-medium")
    emb = np.random.default_rng(2).normal(size=(2, 10, tcfg.d_model)
                                          ).astype(np.float32)
    want, _ = jt.forward(params, jcfg, embeds=jnp.asarray(emb))
    got, _ = transformer.forward(model, tcfg, embeds=torch.from_numpy(emb))
    close(got, want)


# -- model construction and the weight carry ------------------------------------------

def test_parameter_names_are_the_reference_keys():
    _, params, tcfg, model = carried("codeqwen1.5-7b")
    names = set(dict(model.named_parameters()))
    assert {"embed", "final_norm", "lm_head"} <= names
    blk = {n.split(".", 2)[2] for n in names if n.startswith("layers.0.")}
    leaves = {".".join(str(getattr(k, "key", k)) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(
                  params["group"][0])[0]}
    assert blk == leaves
    assert not any(p.requires_grad for p in model.parameters())


def test_weights_carry_exactly():
    """Every port weight equals its reference leaf, layer by layer through
    the stacked group: layer li is group[pos][leaf][r]."""
    _, params, tcfg, model = carried("tinyllama-1.1b")
    for li, blk in enumerate(model.layers):
        want = np.asarray(params["group"][0]["mixer"]["wq"][li])
        np.testing.assert_array_equal(blk.mixer.wq.numpy(), want)
        np.testing.assert_array_equal(
            blk.ffn.wo.numpy(), np.asarray(params["group"][0]["ffn"]["wo"][li]))
    np.testing.assert_array_equal(model.embed.numpy(),
                                  np.asarray(params["embed"]))


def test_weight_carry_handles_prologue_and_bfloat16(monkeypatch):
    """A dense config's weights laid out as one prologue block and a
    stacked group of two, and bfloat16 leaves carried by their bits.  The
    configs with a real prologue, deepseek and kimi (layer 0 dense, MoE
    after it), are carried in tests/test_torch_moe_hybrid.py."""
    jcfg = dataclasses.replace(jget("tinyllama-1.1b", smoke=True),
                               n_layers=3, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                               n_layers=3, dtype=torch.bfloat16)
    params, _ = jt.init(jax.random.PRNGKey(4), jcfg)
    tree = jax.tree.map(np.asarray, params)
    # the same weights laid out as one prologue block + a stacked group of 2
    g = tree["group"][0]
    take = lambda t, s: jax.tree.map(lambda a: a[s], t)   # noqa: E731
    split = {**{k: tree[k] for k in ("embed", "final_norm", "lm_head")},
             "prologue": [take(g, 0)], "group": [take(g, slice(1, 3))]}
    monkeypatch.setattr(convert, "layer_plan",
                        lambda cfg: ([{}], [{}], 2))      # 1 + 2 x 1 layers
    model = convert.params_from_reference(split, tcfg, device="cpu")
    for li in range(3):
        np.testing.assert_array_equal(
            model.layers[li].mixer.wk.view(torch.int16).numpy(),
            np.asarray(g["mixer"]["wk"][li]).view(np.int16))
    toks = tokens(tcfg)
    want, _ = jt.forward(params, jcfg, tokens=jnp.asarray(toks))
    got, _ = transformer.forward(model, tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    close(got, want, 5e-2)


def test_weight_carry_refuses_a_mismatched_tree():
    jcfg, params, tcfg, _ = carried("tinyllama-1.1b")
    tree = jax.tree.map(np.asarray, params)
    wrong = dataclasses.replace(tcfg, d_ff=tcfg.d_ff * 2)
    with pytest.raises(ValueError, match="ffn.wi"):
        convert.params_from_reference(tree, wrong, device="cpu")
    biased = dataclasses.replace(tcfg, qkv_bias=True)
    with pytest.raises(ValueError, match="bq"):
        convert.params_from_reference(tree, biased, device="cpu")


def test_seeded_init_is_deterministic_and_scaled():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    a = transformer.init(cfg, seed=7, device="cpu")
    b = transformer.init(cfg, seed=7, device="cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    w = a.layers[0].mixer.wq
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1) < 0.1
    assert torch.equal(a.layers[0].norm1, torch.ones(cfg.d_model))


def test_models_run_on_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init(get_config("tinyllama-1.1b", smoke=True))
