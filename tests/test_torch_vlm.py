"""Port parity for the VLM family's cross attention and the serve path's
``frontend=`` and ``embeds=`` inputs: ``repro_torch.models.attention``'s
``apply_cross`` and cross K/V cache, the ``llama-vision-smoke`` stack
(4 self-attention layers, then a cross layer over the frontend's tokens)
and the audio family's decode by frame embeddings (``musicgen-smoke``),
against ``repro`` on the CPU.

The reference's seeded weights go through ``models.convert`` into the
port's model, and the same numpy tokens and frontend tokens through both
packages; with ``use_kernel=True`` the reference's self-attention runs its
Pallas kernel in interpret mode and the port's its plain version (CPU
tensors).  Cross attention runs the plain attention in both, as the
reference has it.

Tolerances: float32 at rtol = atol = 1e-4 (both sides compute in float32
and differ in the order of their sums); teacher-forced decode against the
prefill at 2e-2, as tests/test_models.py holds it; greedy tokens
identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.runtime.elastic import carve_mesh
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import attention, convert, transformer

# the whole suite runs in 6 pytest workers on 8 cores: two intra-op threads
# a worker keep these modules from starving the reference's timing-gated tests
torch.set_num_threads(2)

VLM, AUDIO = "llama-3.2-vision-11b", "musicgen-medium"
TOL = 1e-4
CONSISTENCY_TOL = 2e-2
#: the reference's sharding specs of each arch's params (greedy_generate's)
SPECS: dict = {}


@functools.cache
def carried(arch: str, seed: int = 1):
    """(reference cfg, reference params, port cfg, port model) on one set
    of reference weights; the reference's init runs jitted."""
    jcfg, tcfg = jget(arch, smoke=True), get_config(arch, smoke=True)

    def init(key):
        params, SPECS[arch] = jt.init(key, jcfg)
        return params

    params = jax.jit(init)(jax.random.PRNGKey(seed))
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu")
    return jcfg, params, tcfg, model


@functools.cache
def _jitted_forward(jcfg, use_kernel: bool):
    return jax.jit(lambda params, toks, fr: jt.forward(
        params, jcfg, tokens=toks, frontend=fr, use_kernel=use_kernel))


def frontend(cfg, B=2, seed=4, dtype=np.float32) -> np.ndarray:
    """Seeded frontend tokens (B, n_frontend_tokens, d), the stub's
    precomputed patch embeddings."""
    return np.random.default_rng(seed).normal(
        size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(dtype)


def tokens(cfg, B=2, S=20, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def cross_layer():
    """(index of the first cross layer, its reference params)."""
    jcfg, params, _, model = carried(VLM)
    li = next(i for i, b in enumerate(model.layers)
              if b.desc["mixer"] == "cross")
    return li, jax.tree.map(lambda a: a[0], params["group"][li])


# -- cross attention ----------------------------------------------------------------

def test_layer_plan_and_build():
    """llama-3.2-vision-11b: [attn x4, cross] x 8, no prologue; the SMOKE
    config one such period.  Both pass ``check_ported``; the SMOKE config
    builds on the CPU with a self-attention's keys in every cross layer."""
    pro, period, repeats = transformer.layer_plan(get_config(VLM))
    assert not pro and repeats == 8
    assert [d["mixer"] for d in period] == ["attn"] * 4 + ["cross"]
    transformer.check_ported(get_config(VLM))
    cfg = get_config(VLM, smoke=True)
    model = transformer.init(cfg, device="cpu")
    assert [b.desc["mixer"] for b in model.layers] == ["attn"] * 4 + ["cross"]
    assert set(dict(model.layers[4].mixer.named_parameters())) == \
        {"wq", "wk", "wv", "wo"}
    cross = attention.init_cross(torch.Generator().manual_seed(0), cfg)
    assert isinstance(cross, attention.Attention)


def test_apply_cross_matches_reference():
    jcfg, _, tcfg, model = carried(VLM)
    li, p = cross_layer()
    x = np.random.default_rng(5).normal(size=(2, 12, tcfg.d_model)
                                        ).astype(np.float32)
    fr = frontend(tcfg)
    want = jattn.apply_cross(p["mixer"], jcfg, jnp.asarray(x),
                             jnp.asarray(fr))
    got = attention.apply_cross(model.layers[li].mixer, tcfg,
                                torch.from_numpy(x), torch.from_numpy(fr))
    assert got.shape == (2, 12, tcfg.d_model)
    close(got, want)


def test_bfloat16_frontend_promotes_as_jnp_does():
    """A bfloat16 frontend with float32 weights: jnp promotes the product
    to float32, and so does the port (never a quiet cast of the frontend);
    the cross K/V come out float32, the layer's output equals the
    reference's.  Integer tokens are refused."""
    jcfg, _, tcfg, model = carried(VLM)
    li, p = cross_layer()
    mod = model.layers[li].mixer
    x = np.random.default_rng(5).normal(size=(2, 6, tcfg.d_model)
                                        ).astype(np.float32)
    fr = torch.from_numpy(frontend(tcfg)).to(torch.bfloat16)
    want = jattn.apply_cross(p["mixer"], jcfg, jnp.asarray(x),
                             jnp.asarray(fr.float().numpy(), jnp.bfloat16))
    got = attention.apply_cross(mod, tcfg, torch.from_numpy(x), fr)
    close(got, want)
    ck, cv = attention.cross_kv(mod, tcfg, fr)
    assert ck.dtype == cv.dtype == torch.float32
    with pytest.raises(TypeError, match="float"):
        attention.apply_cross(mod, tcfg, torch.from_numpy(x),
                              torch.zeros((2, 4, tcfg.d_model),
                                          dtype=torch.int32))


def test_cross_layers_need_the_frontend():
    _, _, tcfg, model = carried(VLM)
    with pytest.raises(ValueError, match="frontend="):
        transformer.forward(model, tcfg, torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="frontend="):
        transformer.init_cache(model, tcfg, 1, 8)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_reference(use_kernel):
    """``forward(frontend=)`` logits: the kernel path against the
    reference's kernel path, the plain path against its plain path."""
    jcfg, params, tcfg, model = carried(VLM)
    toks, fr = tokens(tcfg), frontend(tcfg)
    want, _ = _jitted_forward(jcfg, use_kernel)(params, jnp.asarray(toks),
                                                jnp.asarray(fr))
    got, aux = transformer.forward(model, tcfg, torch.from_numpy(toks),
                                   frontend=torch.from_numpy(fr),
                                   use_kernel=use_kernel)
    assert got.shape == (2, 20, tcfg.vocab) and float(aux) == 0.0
    close(got, want)


def test_frontend_moves_the_logits():
    """The cross layer reads the frontend: another frontend, other logits
    (and numpy frontends are taken as they are)."""
    _, _, tcfg, model = carried(VLM)
    toks = torch.from_numpy(tokens(tcfg))
    a, _ = transformer.forward(model, tcfg, toks, frontend=frontend(tcfg))
    b, _ = transformer.forward(model, tcfg, toks,
                               frontend=frontend(tcfg, seed=9))
    assert float((a - b).abs().max()) > 1e-3


def test_init_cache_cross_kv_matches_reference():
    """The cross layer's cache holds the frontend's keys and values,
    (B, KVH, T, hd), as the reference's ``_block_cache`` computes them;
    the self-attention layers hold KV caches."""
    jcfg, params, tcfg, model = carried(VLM)
    li, _ = cross_layer()
    fr = frontend(tcfg)
    jcache = jt.init_cache(params, jcfg, 2, 16, frontend=jnp.asarray(fr))
    tcache = transformer.init_cache(model, tcfg, 2, 16,
                                    frontend=torch.from_numpy(fr))
    got = tcache["layers"][li]
    assert set(got) == {"ck", "cv"}
    assert tuple(got["ck"].shape) == (2, tcfg.n_kv_heads,
                                      tcfg.n_frontend_tokens, tcfg.hd)
    for k in ("ck", "cv"):
        close(got[k], jcache["group"][li][k][0])
    assert all(set(c) == {"k", "v", "len"} for c in tcache["layers"][:li])


def test_decode_step_matches_reference():
    """Teacher-forced decode on both packages, step by step, the
    reference's step jitted."""
    jcfg, params, tcfg, model = carried(VLM)
    toks, fr = tokens(tcfg, B=2, S=12), frontend(tcfg)
    jstep = jax.jit(jt.decode_step, static_argnums=1)
    jcache = jt.init_cache(params, jcfg, 2, 16, frontend=jnp.asarray(fr))
    tcache = transformer.init_cache(model, tcfg, 2, 16, frontend=fr)
    for i in range(12):
        want, jcache = jstep(params, jcfg, jnp.asarray(toks[:, i:i + 1]),
                             jcache, None, jnp.asarray(fr))
        got, tcache = transformer.decode_step(
            model, tcfg, torch.from_numpy(toks[:, i:i + 1]), tcache,
            frontend=fr)
        close(got, want)


def test_prefill_decode_consistency():
    """tests/test_models.py's check on the port: teacher-forced
    ``decode_step`` reproduces ``forward(use_kernel=True)``'s logits, the
    cross layers reading their cached frontend K/V."""
    _, _, tcfg, model = carried(VLM)
    toks = torch.from_numpy(tokens(tcfg, B=1, S=12, seed=5))
    fr = torch.from_numpy(frontend(tcfg, B=1))
    full, _ = transformer.forward(model, tcfg, toks, frontend=fr,
                                  use_kernel=True)
    cache = transformer.init_cache(model, tcfg, 1, 16, frontend=fr)
    outs = []
    for i in range(12):
        lt, cache = transformer.decode_step(model, tcfg, toks[:, i:i + 1],
                                            cache, frontend=fr)
        outs.append(lt)
    close(torch.cat(outs, dim=1), full.numpy(), CONSISTENCY_TOL)


def test_greedy_generate_matches_reference():
    """``greedy_generate(frontend=)``: the same tokens as the reference's,
    2 streams x (4 + 6)."""
    jcfg, params, tcfg, model = carried(VLM)
    prompt, fr = tokens(tcfg, B=2, S=4, seed=11), frontend(tcfg)
    mesh = carve_mesh(jax.devices(), model_parallel=1)
    want = np.asarray(jserve.greedy_generate(
        params, jcfg, mesh, SPECS[VLM], jnp.asarray(prompt), max_new=6,
        frontend=jnp.asarray(fr)))
    got = serve.greedy_generate(model, tcfg, prompt, 6,
                                frontend=torch.from_numpy(fr))
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_step_takes_embeds_and_frontend():
    """``make_serve_step``'s step is one ``decode_step`` with the
    reference's step's inputs."""
    _, _, tcfg, model = carried(VLM)
    fr = frontend(tcfg, B=1)
    tok = torch.from_numpy(tokens(tcfg, B=1, S=1))
    step = serve.make_serve_step(tcfg)
    got, _ = step(model, serve.make_cache(model, tcfg, 1, 4, frontend=fr),
                  tok, None, fr)
    want, _ = transformer.decode_step(
        model, tcfg, tok, transformer.init_cache(model, tcfg, 1, 4,
                                                 frontend=fr))
    assert torch.equal(got, want)


# -- the audio family's embeds= ------------------------------------------------------

def test_musicgen_decode_step_by_embeds_matches_reference():
    """musicgen decodes by frame embeddings (``embeds=``), 12 steps on
    both packages against the reference's ``decode_step(embeds=)``."""
    jcfg, params, tcfg, model = carried(AUDIO)
    emb = np.random.default_rng(2).normal(size=(2, 12, tcfg.d_model)
                                          ).astype(np.float32)
    jstep = jax.jit(jt.decode_step, static_argnums=1)
    jcache = jt.init_cache(params, jcfg, 2, 16)
    tcache = transformer.init_cache(model, tcfg, 2, 16)
    for i in range(12):
        want, jcache = jstep(params, jcfg, None, jcache,
                             jnp.asarray(emb[:, i:i + 1]))
        got, tcache = transformer.decode_step(
            model, tcfg, None, tcache, embeds=torch.from_numpy(emb[:, i:i + 1]))
        assert got.shape == (2, 1, tcfg.vocab)
        close(got, want)
    full, _ = transformer.forward(model, tcfg,
                                  embeds=torch.from_numpy(emb))
    # the serve path's embeds= reproduces the full-sequence forward too
    step = serve.make_serve_step(tcfg)
    cache, outs = serve.make_cache(model, tcfg, 2, 16), []
    for i in range(12):
        lt, cache = step(model, cache, None, torch.from_numpy(emb[:, i:i + 1]))
        outs.append(lt)
    close(torch.cat(outs, 1), full.numpy(), CONSISTENCY_TOL)


def test_embeds_cast_to_the_model_dtype_as_the_reference_does():
    """``embeds.astype(cfg.dtype)`` in the reference: the one cast the
    serve path makes, of frame embeddings into the model's dtype."""
    _, _, tcfg, model = carried(AUDIO)
    emb = np.random.default_rng(2).normal(size=(1, 3, tcfg.d_model))
    got, _ = transformer.forward(model, tcfg, embeds=torch.from_numpy(emb))
    want, _ = transformer.forward(model, tcfg,
                                  embeds=torch.from_numpy(emb).float())
    assert torch.equal(got, want)


def test_greedy_generate_passes_the_frontend_only_to_the_vlm_family():
    """The reference hands ``frontend`` to the step only for ``vlm``; the
    port's greedy_generate on the audio family ignores one."""
    _, _, tcfg, model = carried(AUDIO)
    prompt = tokens(tcfg, B=1, S=3, seed=1)
    a = serve.greedy_generate(model, tcfg, prompt, 3)
    b = serve.greedy_generate(model, tcfg, prompt, 3,
                              frontend=np.zeros((1, 2, tcfg.d_model),
                                                np.float32))
    assert tcfg.family == "audio" and torch.equal(a, b)
