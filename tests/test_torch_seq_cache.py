"""Port parity of the sequence-sharded decode cache: a decode batch that
the data axes replicate (batch 1; batch 2 on data 4) keeps each
self-attention layer's cache as the data rank's block of positions,
where the reference's ``cache_spec_for`` of the whole leaf puts the data
axes on the sequence, and each step merges the ranks' partial softmaxes
— in 4 gloo processes on the CPU against ``repro``.

One launch of 4 ranks (``launch.mesh.spawn``) runs every case on (4, 1),
(2, 2) and (2, 2, 1) with "pod" while this process computes the
reference's greedy tokens (one device), its cache specs (on
``jax.sharding.AbstractMesh``) and the one-process port.  The weights
are the port's seeded draw in the reference's tree
(tests/test_torch_tp.py's scheme).

- danube-smoke (window 16: with 12 positions a rank on (4, 1) the window
  spans two or three ranks) in both decode impls (``ref`` and the
  reference's ``fast_decode`` form), tinyllama-smoke (no window),
  jamba-smoke (one attention layer among Mamba and MoE layers) as
  published on (4, 1) and with ``fsdp=True`` on (2, 2), as its FULL
  config has, and xlstm-smoke (no sequence axis: its cache comes out
  unchanged).
- For each: greedy tokens of a 40-token prompt and 8 new ones equal to
  the reference's ``greedy_generate``; every step's logits of a
  teacher-forced decode over all 48 positions (the last step writes
  position ``max_len - 1``) within the family's one-process tolerance
  (1e-4; jamba's stack 1e-3) of the one-process port on a whole cache;
  each rank's KV leaves equal in bytes to the reference's
  ``cache_specs`` shard of the whole leaves.
- Batch 2 on data 4 is split too; 49 positions, which do not divide by
  4, stay replicated (the spec puts "data" on the head dimension).
- A step made without the cache's ``max_len`` refuses a batch that the
  data axes replicate, on every rank; one told another length refuses
  the cache.
- A rank whose block holds no valid position contributes m = -inf, l =
  0, o = 0 and no NaN; the partial softmaxes merge to the plain decode
  attention over every split of the positions (one process).

The reference is imported inside the fixture: the ranks import this
module and run no JAX.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import get_config
from repro_torch.core import sharding
from repro_torch.kernels import ref as kref
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve
from repro_torch.models import attention, convert, transformer
from repro_torch.runtime import elastic

TOL = 1e-4
STACK_TOL = {"jamba-1.5-large-398b": 1e-3}
DANUBE, LLAMA = "h2o-danube-3-4b", "tinyllama-1.1b"
JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-125m"
PROMPT, NEW = 40, 8
#: (arch, mode, mesh, batch, prompt length): mode "ref", "grouped"
#: (``fast_decode``) or "fsdp" (``fsdp=True``); mesh "m41" (4, 1), "m22"
#: (2, 2), "p221" (2, 2, 1) over ("pod", "data", "model")
CASES = [(DANUBE, "ref", m, 1, PROMPT) for m in ("m41", "m22", "p221")] + [
    (DANUBE, "grouped", m, 1, PROMPT) for m in ("m41", "m22")] + [
    (LLAMA, "ref", m, 1, PROMPT) for m in ("m41", "m22", "p221")] + [
    (JAMBA, "ref", "m41", 1, PROMPT), (JAMBA, "fsdp", "m22", 1, PROMPT),
    (XLSTM, "ref", "m41", 1, PROMPT), (XLSTM, "ref", "m22", 1, PROMPT),
    (DANUBE, "ref", "m41", 2, PROMPT),          # batch 2 on data 4
    (DANUBE, "ref", "m41", 1, PROMPT + 1)]      # 49 positions: replicated
DIMS = {"m41": {"data": 4, "model": 1}, "m22": {"data": 2, "model": 2},
        "p221": {"pod": 2, "data": 2, "model": 1}}


def port_cfg(arch: str, mode: str):
    cfg = get_config(arch, smoke=True)
    if mode == "grouped":
        return dataclasses.replace(cfg, fast_decode=True)
    if mode == "fsdp":
        return dataclasses.replace(cfg, fsdp=True)
    return cfg


def ref_key(case) -> tuple:
    """What the reference's and the one-process port's outputs depend on:
    (arch, impl, batch, prompt length)."""
    arch, mode, _, b, s = case
    return arch, mode == "grouped", b, s


def case_id(c) -> str:
    return f"{c[0].split('-')[0]}-{c[1]}-{c[2]}-b{c[3]}-s{c[4]}"


def kv_bytes(cache: dict) -> int:
    return sum(c[k].numel() * c[k].element_size() for c in cache["layers"]
               for k in ("k", "v") if k in c)


# -- the ranks ------------------------------------------------------------------------

def _case(mesh, ref: dict, case) -> dict:
    arch, mode, _, B, S = case
    cfg = port_cfg(arch, mode)
    key = ref_key(case)
    L = S + NEW
    model = convert.params_from_reference(ref["params"][arch], cfg,
                                          device="cpu", mesh=mesh)
    out = {"tokens": serve.greedy_generate(model, cfg, ref["prompt"][key],
                                           NEW).numpy()}
    seq = serve.seq_shard(mesh, cfg, B, L)
    out["seq"] = (seq.size, seq.index)
    cache = serve.make_cache(model, cfg, B, L)
    out["shapes"] = [{k: tuple(t.shape) for k, t in c.items()}
                     for c in cache["layers"]]
    out["kv_bytes"] = kv_bytes(cache)
    step = serve.make_serve_step(cfg, batch=B, max_len=L)
    toks = torch.from_numpy(ref["forced"][key])
    logits = []
    with torch.no_grad():
        for i in range(L):
            lg, cache = step(model, cache, toks[:, i:i + 1])
            logits.append(lg.numpy())
    out["logits"] = np.stack(logits)
    try:        # a step that is not told the cache's max_len
        serve.make_serve_step(cfg, batch=B)(model, cache, toks[:, :1])
        out["unsized"] = None
    except ValueError as e:
        out["unsized"] = str(e)
    out["len"] = [c["len"].tolist() for c in cache["layers"] if "len" in c]
    # the rank's own partial at the last step's lengths, over its block
    attn = [c for c in cache["layers"] if "k" in c]
    if attn:
        c = attn[0]
        T = c["k"].shape[2]
        q = torch.randn((B, cfg.n_heads // model.tp.size, 1, cfg.hd),
                        generator=torch.Generator().manual_seed(0))
        out["partial"] = [t.numpy() for t in attention.decode_partial(
            q, c["k"], c["v"], c["len"], start=seq.index * T,
            window=cfg.window)]
        out["block"] = (seq.index * T, T)
    return out


def _seq_rank(rank: int, ref: dict) -> dict:
    """Every case on this rank; every rank builds every mesh in the same
    order (their groups are made on the whole world)."""
    meshes = {"m41": elastic.carve_mesh(model_parallel=1, device_type="cpu"),
              "m22": elastic.carve_mesh(model_parallel=2, device_type="cpu"),
              "p221": DeviceMesh("cpu", torch.arange(4).reshape(2, 2, 1),
                                 mesh_dim_names=("pod", "data", "model"))}
    out = {}
    for case in CASES:
        out[case] = _case(meshes[case[2]], ref, case)
        out[case]["index"] = sharding.axis_index(
            meshes[case[2]], sharding.data_axes(meshes[case[2]]))
    return out


# -- the reference and the run ---------------------------------------------------------

def _shard_bytes(shapes, specs, dims: dict) -> int:
    """The bytes that the reference's specs put on one device of a mesh of
    ``dims`` of its self-attention KV leaves ("k" / "v")."""
    import jax
    total = 0
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    spec_of = dict(jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    for path, a in leaves:
        if getattr(path[-1], "key", None) not in ("k", "v"):
            continue
        n = a.size * a.dtype.itemsize
        for e in spec_of[path]:
            for ax in (() if e is None else (e,) if isinstance(e, str)
                       else e):
                n //= dims[ax]
        total += n
    return total


@pytest.fixture(scope="module")
def run():
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh
    from repro.configs import get_config as jget
    from repro.launch import serve as jserve
    from repro.models import transformer as jtr
    from repro.runtime.elastic import carve_mesh as jcarve

    rng = np.random.default_rng(5)
    ref = {"params": {}, "prompt": {}, "forced": {}}
    for arch in sorted({c[0] for c in CASES}):
        cfg = get_config(arch, smoke=True)
        ref["params"][arch] = convert.params_to_reference(
            transformer.init(cfg, seed=1, device="cpu"), cfg)
    for key in sorted({ref_key(c) for c in CASES}):
        arch, _, B, S = key
        V = get_config(arch, smoke=True).vocab
        ref["prompt"][key] = rng.integers(0, V, (B, S)).astype(np.int32)
        ref["forced"][key] = rng.integers(0, V, (B, S + NEW)).astype(
            np.int32)
    ranks = concurrent.futures.ThreadPoolExecutor(1).submit(
        tmesh.spawn, _seq_rank, 4, ref, timeout=300)

    want = {"tokens": {}, "logits": {}, "kv_bytes": {}, "whole": {}}
    m1 = jcarve(jax.devices()[:1])
    for key in sorted({ref_key(c) for c in CASES}):
        arch, grouped, B, S = key
        jcfg = dataclasses.replace(jget(arch, smoke=True),
                                   fast_decode=grouped)
        box = {}

        def init(k, jcfg=jcfg):
            p, box["specs"] = jtr.init(k, jcfg)
            return p
        jax.eval_shape(init, jax.random.PRNGKey(0))
        p = jax.tree.map(jnp.asarray, ref["params"][arch])
        want["tokens"][key] = np.asarray(jserve.greedy_generate(
            p, jcfg, m1, box["specs"], jnp.asarray(ref["prompt"][key]), NEW))
        shapes = jax.eval_shape(
            lambda p, B=B, L=S + NEW, jcfg=jcfg: jtr.init_cache(p, jcfg, B, L),
            p)
        for name, dims in DIMS.items():
            specs = jserve.cache_specs(shapes, AbstractMesh(
                tuple(dims.values()), tuple(dims)))
            want["kv_bytes"][key, name] = _shard_bytes(shapes, specs, dims)
        want["whole"][key] = _shard_bytes(shapes, jserve.cache_specs(
            shapes, AbstractMesh((1, 1), ("data", "model"))),
            {"data": 1, "model": 1})
        # the one-process port on a whole cache, teacher-forced
        cfg = port_cfg(arch, "grouped" if grouped else "ref")
        model = convert.params_from_reference(ref["params"][arch], cfg,
                                              device="cpu")
        cache = serve.make_cache(model, cfg, B, S + NEW)
        step = serve.make_serve_step(cfg, batch=B, max_len=S + NEW)
        toks = torch.from_numpy(ref["forced"][key])
        logits = []
        with torch.no_grad():
            for i in range(S + NEW):
                lg, cache = step(model, cache, toks[:, i:i + 1])
                logits.append(lg.numpy())
        want["logits"][key] = np.stack(logits)
    return ranks.result(), want


def ranks_of(got, case):
    return [o[case] for o in got]


# -- the cases ------------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_greedy_tokens_match_reference(run, case):
    """Every rank's greedy tokens equal the reference's
    ``greedy_generate`` on one device (the batch is replicated: every
    rank decodes it whole)."""
    got, want = run
    for o in ranks_of(got, case):
        np.testing.assert_array_equal(o["tokens"],
                                      want["tokens"][ref_key(case)])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_step_logits_match_one_process(run, case):
    """Every step's logits of a teacher-forced decode over all positions
    (the last step writes position ``max_len - 1``, on the last data
    rank) within the family's one-process tolerance of the port on a
    whole cache, finite on every rank."""
    got, want = run
    tol = STACK_TOL.get(case[0], TOL)
    w = want["logits"][ref_key(case)]
    for o in ranks_of(got, case):
        assert np.isfinite(o["logits"]).all()
        np.testing.assert_allclose(o["logits"], w, rtol=tol, atol=tol)
        L = case[4] + NEW
        assert all(n == [L] * case[3] for n in o["len"]), o["len"]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_kv_bytes_equal_the_reference_specs(run, case):
    """Each rank's self-attention KV leaves hold, to the byte, what the
    reference's ``cache_specs`` put on one device of the mesh for the
    whole leaves where the spec splits the sequence: max_len / D
    positions a rank (its "model" shard of the head dimension is the
    port's of kv heads: the same bytes).  At 49 positions the spec puts
    "data" on the head dimension instead, and the port keeps the whole
    cache (D times the spec's bytes, the same function).  xlstm has no
    KV leaf."""
    got, want = run
    arch, mode, mesh, B, S = case
    key = ref_key(case)
    L = S + NEW
    cfg = get_config(arch, smoke=True)
    D = DIMS[mesh].get("pod", 1) * DIMS[mesh]["data"]
    split = case != (DANUBE, "ref", "m41", 1, PROMPT + 1)
    spec = want["kv_bytes"][key, mesh]
    for o in ranks_of(got, case):
        assert o["kv_bytes"] == spec * (1 if split else D), (
            o["kv_bytes"], spec)
        for sh in o["shapes"]:
            if "k" in sh:
                assert sh["k"][2] == (L // D if split else L), sh
                assert sh["len"] == (B,)
        if arch == XLSTM:
            assert o["kv_bytes"] == 0
        else:
            assert o["seq"] == ((D, o["index"]) if split else (1, 0))
    assert spec * D * DIMS[mesh]["model"] == want["whole"][key]


def test_the_pod_axis_is_pod_major(run):
    """On (2, 2, 1) the combined data axis of pod · data ranks is indexed
    pod major: rank r holds positions [r · 12, r · 12 + 12) of 48."""
    got, _ = run
    case = (DANUBE, "ref", "p221", 1, PROMPT)
    for r, o in enumerate(ranks_of(got, case)):
        assert o["seq"] == (4, r) and o["block"] == (12 * r, 12)


def test_caches_that_stay_whole(run):
    """The recurrent states (jamba's Mamba layers, xlstm's mLSTM / sLSTM)
    are replicated over the data axes: each rank's equal to the
    one-process cache's shapes; the attention layer of jamba is split."""
    got, _ = run
    for case in [c for c in CASES if c[0] in (JAMBA, XLSTM)
                 and c[2] == "m41"]:
        cfg = get_config(case[0], smoke=True)
        L = case[4] + NEW
        one = transformer.init_cache(transformer.Transformer(
            cfg, device="meta"), cfg, case[3], L)
        for o in ranks_of(got, case):
            for sh, c in zip(o["shapes"], one["layers"]):
                whole = {k: tuple(t.shape) for k, t in c.items()}
                if "k" in sh:
                    whole["k"] = whole["v"] = (1, cfg.n_kv_heads, L // 4,
                                               cfg.hd)
                assert sh == whole


def test_rank_without_valid_positions_gives_no_nan(run):
    """At the last step of danube-smoke on (4, 1) (48 positions, window
    16: valid 32 … 47) ranks 0 and 1 hold no valid position: their
    partial is m = -inf, l = 0, o = 0, with no NaN, and the merged logits
    are finite and the one process's."""
    got, _ = run
    case = (DANUBE, "ref", "m41", 1, PROMPT)
    outs = ranks_of(got, case)
    for r, o in enumerate(outs):
        m, l, o_ = o["partial"]
        assert not np.isnan(m).any() and not np.isnan(o_).any()
        if r < 2:
            assert np.isneginf(m).all() and (l == 0).all() and (o_ == 0).all()
        else:
            assert np.isfinite(m).all() and (l > 0).all()


@pytest.mark.parametrize("impl", ["ref", "grouped"])
@pytest.mark.parametrize("window", [None, 16, 4])
def test_partials_merge_to_the_plain_decode(impl, window):
    """``decode_partial`` over D blocks of the positions, merged with
    ``rescaled`` / ``normalized`` (the terms ``merge_partials`` sums over
    the ranks), equals ``kernels/ref``'s decode attention over the whole
    cache at 1e-5, for every length and D in {1, 2, 3, 4, 6}; blocks
    wholly outside the window give no NaN; with no offset the plain
    mask is unchanged."""
    g = torch.Generator().manual_seed(3)
    B, H, KVH, T, D = 2, 8, 2, 48, 16
    q = torch.randn(B, H, 1, D, generator=g)
    k, v = (torch.randn(B, KVH, T, D, generator=g) for _ in range(2))
    f = kref.decode_attention_grouped if impl == "grouped" \
        else kref.decode_attention
    for n in (1, 5, 20, 47, 48):
        lens = torch.full((B,), n, dtype=torch.int32)
        want = f(q, k, v, lens, window=window)
        for parts in (1, 2, 3, 4, 6):
            w = T // parts
            ps = [attention.decode_partial(
                q, k[:, :, i * w:(i + 1) * w], v[:, :, i * w:(i + 1) * w],
                lens, start=i * w, window=window, impl=impl)
                for i in range(parts)]
            M = torch.stack([p[0] for p in ps]).amax(0)
            got = attention.normalized(sum(attention.rescaled(*p, M)
                                           for p in ps))
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(kref._decode_valid(lens, T, window),
                       kref._decode_valid(lens, T, window, 0))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_step_without_max_len_refuses_a_replicated_batch(run, case):
    """Every case's batch is replicated over D > 1 data ranks, so its
    cache may be a block of positions a rank: a step made without the
    cache's ``max_len`` raises on every rank before it writes or attends
    (it would write position ``len`` at the block's local index ``len``)."""
    got, _ = run
    dims = DIMS[case[2]]
    D = sharding.axis_size(dims, sharding.data_axes(dims))
    for o in ranks_of(got, case):
        assert o["unsized"] is not None
        assert f"replicated over {D} data ranks" in o["unsized"]


def test_step_refuses_a_cache_of_another_length():
    """A step told another ``max_len`` than its cache's raises instead of
    writing a position into the wrong block (no mesh needed: the check
    reads the shapes)."""
    cfg = get_config(DANUBE, smoke=True)
    cache = {"layers": [{"k": torch.zeros(1, 2, 12, 16)}]}
    serve._check_block(cache, slice(12, 24))
    with pytest.raises(ValueError, match="12 positions a rank"):
        serve._check_block(cache, slice(0, 24))
    assert serve.seq_shard(None, cfg, 1, 48) is sharding.SOLO
    # without a mesh the step's cache is whole: a block of 12 is refused
    one = type("Model", (), {"mesh": None})()
    step = serve.make_serve_step(cfg, batch=1, max_len=48)
    with pytest.raises(ValueError, match="not the 48 of"):
        step(one, cache, torch.zeros(1, 1, dtype=torch.int32))
    # a replicated batch without max_len raises before it reads the model
    step = serve.make_serve_step(cfg, {"data": 4, "model": 1}, batch=1)
    with pytest.raises(ValueError, match="needs the cache's max_len"):
        step(None, cache, torch.zeros(1, 1, dtype=torch.int32))
    assert serve.seq_shard({"data": 4, "model": 1}, cfg, 4, 48) \
        is sharding.SOLO
