"""Port parity for the LM serving stack: ``repro_torch.launch.serve``'s
``greedy_generate`` and ``repro_torch.pim.DecodeEngine`` against the
reference's ``greedy_generate``, on the reference's seeded weights carried
across by ``models.convert.params_from_reference`` (the ``_tiny_cfg`` of
tests/test_decode.py: 2 layers, d_model 128, 2 streams).

Tokens must be identical.  The engine runs on CPU sessions of 1 bank, 8
banks and 2 ranks x 4 banks, with the phase accounting, tagged telemetry
and residency checks of tests/test_decode.py: warm steps scatter no weight
byte.  The bridge rejects the same configs as the reference's.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.models import pim_bridge as jbridge
from repro.models import transformer as jt
from repro.runtime.elastic import carve_mesh
from repro_torch import pim
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import convert, pim_bridge, transformer
from repro_torch.pim.decode import PIM_GROUPS, PROJ_WORKLOADS, DecodeEngine
from repro_torch.runtime.trace import NULL_TRACER, set_tracer

# the whole suite runs in 6 pytest workers on 8 cores: two intra-op threads
# a worker keep these modules from starving the reference's timing-gated tests
torch.set_num_threads(2)

STREAMS, PROMPT, MAX_NEW = 2, 4, 6
SHAPES = {"1 bank": dict(banks=1), "8 banks": dict(banks=8),
          "2 ranks x 4 banks": dict(ranks=2, banks_per_rank=4)}


def tiny(get, dtype, layers=2):
    return dataclasses.replace(
        get("tinyllama-1.1b", smoke=True), n_layers=layers, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=256, dtype=dtype,
        fast_decode=True)


@pytest.fixture(scope="module")
def ref_run():
    """The reference's weights, prompt and greedy tokens, and the port's
    model on those weights."""
    jcfg, tcfg = tiny(jget, jnp.float32), tiny(get_config, torch.float32)
    params, specs = jt.init(jax.random.PRNGKey(0), jcfg)
    prompt = jax.random.randint(jax.random.PRNGKey(1), (STREAMS, PROMPT), 0,
                                jcfg.vocab)
    mesh = carve_mesh(jax.devices(), model_parallel=1)
    tokens = np.asarray(jserve.greedy_generate(params, jcfg, mesh, specs,
                                               prompt, max_new=MAX_NEW))
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu")
    return types.SimpleNamespace(jcfg=jcfg, params=params, cfg=tcfg,
                                 model=model, prompt=np.array(prompt),
                                 tokens=tokens)


def spans(session, name):
    return [sp for sp in session.tracer.spans if sp.name == name]


@pytest.fixture(scope="module", params=list(SHAPES))
def engine_run(request, ref_run):
    """One warm engine run per session shape: pin every projection,
    decode, close — the tracer's spans and telemetry outlive the close."""
    s = pim.session(device="cpu", trace=True, **SHAPES[request.param])
    try:
        eng = DecodeEngine(ref_run.model, ref_run.cfg, session=s)
        n_scatter_pin = len(spans(s, "scatter"))
        out = eng.generate(ref_run.prompt, MAX_NEW)
    finally:
        s.close()
        set_tracer(NULL_TRACER)
    return types.SimpleNamespace(eng=eng, session=s, out=out,
                                 n_scatter_pin=n_scatter_pin,
                                 shape=SHAPES[request.param])


# -- greedy_generate ------------------------------------------------------------

def test_greedy_generate_tokens_identical(ref_run):
    out = serve.greedy_generate(ref_run.model, ref_run.cfg, ref_run.prompt,
                                MAX_NEW)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref_run.tokens)


def test_greedy_generate_on_danube_window_matches_reference():
    """Sliding-window decode (window 16) past the window."""
    jcfg, tcfg = jget("h2o-danube-3-4b", smoke=True), \
        get_config("h2o-danube-3-4b", smoke=True)
    params, specs = jt.init(jax.random.PRNGKey(2), jcfg)
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab, (1, 12)
                                               ).astype(np.int32)
    mesh = carve_mesh(jax.devices(), model_parallel=1)
    want = np.asarray(jserve.greedy_generate(params, jcfg, mesh, specs,
                                             jnp.asarray(prompt), max_new=10))
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu")
    np.testing.assert_array_equal(
        serve.greedy_generate(model, tcfg, prompt, 10).numpy(), want)


def test_serve_step_is_one_decode_step(ref_run):
    cfg, model = ref_run.cfg, ref_run.model
    cache = serve.make_cache(model, cfg, STREAMS, 8)
    assert len(cache["layers"]) == cfg.n_layers
    assert tuple(cache["layers"][0]["k"].shape) == (STREAMS, cfg.n_kv_heads,
                                                    8, cfg.hd)
    step = serve.make_serve_step(cfg)
    tok = torch.from_numpy(ref_run.prompt[:, :1])
    logits, cache = step(model, cache, tok)
    want, _ = transformer.decode_step(model, cfg, tok,
                                      transformer.init_cache(model, cfg,
                                                             STREAMS, 8))
    assert torch.equal(logits, want)
    assert cache["layers"][1]["len"].tolist() == [1] * STREAMS


# -- DecodeEngine ------------------------------------------------------------------

def test_engine_tokens_identical_to_greedy_generate(engine_run, ref_run):
    np.testing.assert_array_equal(engine_run.out, ref_run.tokens)
    assert engine_run.out.shape == (STREAMS, PROMPT + MAX_NEW)
    assert engine_run.out.dtype == np.int32


def test_report_counts_generation_steps_only(engine_run):
    rep = engine_run.eng.report()
    assert rep["steps"] == PROMPT + MAX_NEW - 1
    assert rep["new_tokens"] == STREAMS * MAX_NEW
    assert rep["tokens_per_s"] > 0
    assert rep["time_per_output_token_s"] * rep["new_tokens"] == \
        pytest.approx(rep["generate_s"])
    assert rep["setup_s"] > 0                       # the pin pass was timed
    assert set(rep["pim_s"]) == set(PIM_GROUPS)


def test_every_step_wall_is_covered_by_pim_plus_host_phases(engine_run):
    for sr in engine_run.eng.steps:
        accounted = sum(sr.pim_s.values()) + sr.host_s
        assert abs(accounted - sr.wall_s) <= 0.25 * sr.wall_s + 5e-3, (
            sr.step, accounted, sr.wall_s)


def test_telemetry_rows_tag_every_layer_and_projection(engine_run, ref_run):
    cfg, eng, s = ref_run.cfg, engine_run.eng, engine_run.session
    want = {(li, p) for li in range(cfg.n_layers) for p in PROJ_WORKLOADS}
    assert set(eng.proj_seconds()) == want
    rows = [r.row(s.n_banks) for r in s.telemetry.records]
    tagged = [r for r in rows if "tag_proj" in r]
    assert len(tagged) == ((PROMPT + MAX_NEW - 1) * cfg.n_layers
                           * len(PROJ_WORKLOADS) * STREAMS)
    assert {r["tag_layer"] for r in tagged} == set(range(cfg.n_layers))
    for r in tagged:
        assert r["workload"] == PROJ_WORKLOADS[r["tag_proj"]]
        assert r["tenant"].startswith("stream-")
    ranks = engine_run.shape.get("ranks", 1)
    assert {r.n_ranks for r in s.telemetry.records} == {ranks}
    serves = [sp for sp in spans(s, "serve") if "proj" in sp.args]
    assert {sp.args["proj"] for sp in serves} == set(PROJ_WORKLOADS)
    assert len(spans(s, "decode_step")) == PROMPT + MAX_NEW - 1


def test_warm_steps_emit_zero_weight_scatter_bytes(engine_run):
    s = engine_run.session
    assert engine_run.n_scatter_pin == 0
    assert not spans(s, "scatter")
    cached = spans(s, "scatter:cached")
    assert cached and sum(sp.args["bytes"] for sp in cached) > 0
    cs = s.stats()["cache"]
    assert cs["misses"] == len(engine_run.eng.pins)      # pins only
    assert cs["hits"] >= (PROMPT + MAX_NEW - 1) * len(engine_run.eng.pins)


def test_cold_engine_rescatters_weights_every_step():
    jcfg, tcfg = tiny(jget, jnp.float32, 1), tiny(get_config, torch.float32, 1)
    params, _ = jt.init(jax.random.PRNGKey(0), jcfg)
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu")
    s = pim.session(device="cpu", trace=True, resident=False)
    try:
        eng = DecodeEngine(model, tcfg, session=s)
        assert eng.pins == [] and eng.setup_s == 0.0     # nothing to pin
        out = eng.generate(np.asarray([[1, 2]], np.int32), 2)
    finally:
        s.close()
        set_tracer(NULL_TRACER)
    assert out.shape == (1, 4)
    assert not spans(s, "scatter:cached")
    weight_nbytes = sum(sum(a.nbytes for a in h.value.values())
                        for h in eng.handles.values())
    scattered = sum(sp.args["bytes"] for sp in spans(s, "scatter"))
    assert scattered >= len(eng.steps) * weight_nbytes


def test_engine_owns_and_closes_its_session(ref_run):
    with DecodeEngine(ref_run.model, ref_run.cfg, banks=2,
                      device="cpu") as eng:
        out = eng.generate(ref_run.prompt[:1], 2)
        np.testing.assert_array_equal(out, ref_run.tokens[:1, :PROMPT + 2])
    assert eng.session.closed


# -- the bridge ---------------------------------------------------------------------

def test_extracted_weights_equal_the_reference(ref_run):
    want = jbridge.extract_decode_weights(ref_run.params, ref_run.jcfg)
    got = pim_bridge.extract_decode_weights(ref_run.model, ref_run.cfg)
    assert len(got) == len(want) == ref_run.cfg.n_layers
    for g, w in zip(got, want):
        for f in ("q", "k", "v", "o", "gate_up", "down"):
            gd, wd = getattr(g, f), getattr(w, f)
            assert set(gd) == set(wd)
            for k in gd:
                assert gd[k].dtype == wd[k].dtype and gd[k].flags.c_contiguous
                np.testing.assert_array_equal(gd[k], wd[k])
        np.testing.assert_array_equal(g.norm1.numpy(), np.asarray(w.norm1))


@pytest.mark.parametrize("arch,match", [
    ("stablelm-12b", "parallel_block"),
    ("xlstm-125m", "mixer"),
    ("deepseek-moe-16b", "ffn"),
])
def test_bridge_rejects_out_of_contract_archs(arch, match):
    with pytest.raises(ValueError, match=match):
        pim_bridge.validate_decode_config(get_config(arch, smoke=True))
    with pytest.raises(ValueError, match=match):
        jbridge.validate_decode_config(jget(arch, smoke=True))


def test_bridge_rejects_non_float32_params():
    with pytest.raises(ValueError, match="float32"):
        pim_bridge.validate_decode_config(tiny(get_config, torch.bfloat16))
