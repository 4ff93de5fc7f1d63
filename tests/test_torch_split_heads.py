"""Port parity of tensor parallelism inside a head: on a "model" axis of M
ranks, rank r holds the reference's contiguous block r of the columns of
``wq`` / ``wk`` / ``wv`` (and the mLSTM's ``wz``) and the same rows of
``wo`` wherever a head falls; where its columns cut a head it computes
every head they touch, whole, and keeps its own columns of their output
(``layers.head_split``) — in 4 gloo processes on the CPU against
``repro``.

One launch of 4 ranks (``launch.mesh.spawn``) runs every case while this
process computes the reference (one device) and the one-process port on
the same weights (the port's seeded draw in the reference's tree, as in
tests/test_torch_tp.py).  The cases, on (1, 4) unless named:

- musicgen SMOKE: 6 heads of 8, 12 columns a rank, 1.5 heads: each rank
  computes 2 heads (``embeds=``);
- xlstm SMOKE: 2 mLSTM heads of 32, half a head a rank (parallel form);
- xlstm SMOKE with 1 head: a quarter of a head a rank (chunked form, 8);
- xlstm SMOKE with 3 heads of 32 (d 96): 24 columns a rank, which fall
  unevenly in two heads on ranks 1 and 2 (the padded layout of v,
  ``layers.padded_layout``; chunked form);
- the tinyllama straddle config (6 query and 3 kv heads of 8): on (1, 4)
  1.5 query heads a rank over half a kv head; on (1, 2), ranks 0-1, 3
  query heads a rank that use their kv heads unevenly (2 and 1), so each
  rank repeats its kv heads to one a query head (a local MHA);
- llama-vision SMOKE with 6 query and 2 kv heads of 8: its self and cross
  attention split a query head and a kv head;
- musicgen with 3 heads of 16 and ``fsdp=True`` on (2, 2): 1.5 heads a
  rank, each layer's leaves gathered over "data" first;
- the same without FSDP on (2, 2) at batch 1: the decode cache split
  along the sequence over "data" (``launch.serve.seq_shard``) and inside
  a head over "model";
- jamba SMOKE cut to 2 layers (attention and MoE, then Mamba and a
  dense FFN) with Mamba heads of 64 (di 128: 2 heads): half a head a
  rank, which scans only its own 32 columns of it; also with ``fsdp`` on
  (2, 2), a whole head a rank;
- the same with ``ssm_expand=3`` (di 192: 3 heads): 48 columns a rank,
  which fall unevenly in two heads on ranks 1 and 2 (16 + 32: the
  zero-padded layout, ``layers.padded_layout``);
- the same without experts (heads of 16) and ``parallel_block=True``:
  its attention and Mamba layers' partial sums join their dense FFN's;
- llama-vision SMOKE with ``parallel_block=True``: its cross layer's too.

Each is held to the reference's forward and to the one-process port:
float32 logits of the rank's rows at 1e-4, the loss at 1e-5, each
gradient part at 1e-3 of the leaf's largest |g|, greedy tokens equal, the
parameter bytes a rank equal to the reference's specs on one device.
The caches' bytes a rank are findings, stated against the reference's
cache specs (``launch.serve.cache_specs``): a split-head self-attention
layer keeps the whole kv heads it computes (M · kept / KVH times the
spec's bytes where the spec splits by M; 4/3 for musicgen on (1, 4)); the
mLSTM's C keeps (B, heads, hd, own columns), the spec's bytes where a
rank's columns lie as many in each touched head, and its n and m whole
for the touched heads; Mamba's conv window is the spec's and its state
(B, heads, N, w) the rank's own columns of each touched head, the spec's
bytes where they lie as many in each.

The reference is imported inside the fixture: the ranks import this
module and run no JAX.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import sharding
from repro_torch.data import DataConfig, make_batch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve, train
from repro_torch.models import (attention, convert, layers, mamba,
                                transformer, xlstm)
from repro_torch.runtime import elastic

TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 1e-3
BATCH, SEQ = 2, 16
PROMPT, NEW = (2, 6), 4
#: each case's config: (arch, the SMOKE fields it replaces)
CONFIGS = {
    "musicgen": ("musicgen-medium", {}),
    "xlstm": ("xlstm-125m", {}),
    "xlstm-1h": ("xlstm-125m", dict(n_heads=1, n_kv_heads=1, mlstm_chunk=8)),
    "xlstm-3h": ("xlstm-125m", dict(n_heads=3, n_kv_heads=3, d_model=96,
                                    mlstm_chunk=8)),
    "straddle": ("tinyllama-1.1b", dict(n_heads=6, n_kv_heads=3, d_model=48)),
    "vision": ("llama-3.2-vision-11b", dict(n_heads=6, n_kv_heads=2,
                                            head_dim=8)),
    "musicgen-3h": ("musicgen-medium", dict(n_heads=3, n_kv_heads=3)),
    "musicgen-3h-fsdp": ("musicgen-medium", dict(n_heads=3, n_kv_heads=3,
                                                 fsdp=True)),
    "jamba-2h": ("jamba-1.5-large-398b", dict(n_layers=2, ssm_head_dim=64)),
    "jamba-2h-fsdp": ("jamba-1.5-large-398b", dict(n_layers=2,
                                                   ssm_head_dim=64,
                                                   fsdp=True)),
    "jamba-3h": ("jamba-1.5-large-398b", dict(n_layers=2, ssm_expand=3,
                                              ssm_head_dim=64)),
    "jamba-par": ("jamba-1.5-large-398b", dict(n_layers=2, moe_experts=0,
                                               parallel_block=True)),
    "vision-par": ("llama-3.2-vision-11b", dict(parallel_block=True)),
}
#: a config whose weights, inputs and one-device numbers are another's:
#: FSDP changes only the placement
TWINS = {"jamba-2h-fsdp": "jamba-2h"}
#: (config, mesh): "m4" (1, 4), "a" (1, 2) of ranks 0-1, "m22" (2, 2)
CASES = [("musicgen", "m4"), ("xlstm", "m4"), ("xlstm-1h", "m4"),
         ("xlstm-3h", "m4"), ("straddle", "m4"), ("straddle", "a"),
         ("vision", "m4"), ("musicgen-3h-fsdp", "m22"), ("jamba-2h", "m4"),
         ("jamba-2h-fsdp", "m22"), ("jamba-3h", "m4"), ("jamba-par", "m4"),
         ("vision-par", "m4")]
DIMS = {"m4": {"data": 1, "model": 4}, "a": {"data": 1, "model": 2},
        "m22": {"data": 2, "model": 2}}
#: the sequence-sharded case: batch 1 over SEQ_PROMPT + NEW positions
SEQ_KEY, SEQ_PROMPT = "musicgen-3h", 20
#: the meshes ``check_ported`` must accept every FULL config on
MESHES = [{"data": 1, "model": m} for m in (2, 4, 8, 16)] + [
    {"data": 2, "model": 2}, {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16}]


def port_cfg(key: str):
    arch, fields = CONFIGS[key]
    return dataclasses.replace(get_config(arch, smoke=True), **fields)


def case_id(c) -> str:
    return f"{c[0]}-{c[1]}"


def model_input(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k != "labels"}


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def cache_shapes(cache: dict) -> list[dict]:
    return [{k: tuple(t.shape) for k, t in c.items()} for c in cache["layers"]]


# -- the ranks ------------------------------------------------------------------------

def _case(mesh, ref: dict, case) -> dict:
    key = case[0]
    cfg = port_cfg(key)
    model = convert.params_from_reference(ref["params"][key], cfg,
                                          device="cpu", mesh=mesh)
    rows = train.rows(BATCH, mesh)
    b = train.shard_batch(ref["batch"][key], cfg, mesh, "cpu")
    with torch.no_grad():
        logits, _ = transformer.forward(model, cfg, **model_input(b))
    out = {"rows": (rows.start, rows.stop), "logits": logits.numpy(),
           "param_bytes": param_bytes(model),
           "parts": dict(transformer.leaf_parts(model)),
           "mixers": [(blk.desc["mixer"], getattr(blk.mixer, "split", None),
                       getattr(blk.mixer, "kv", None),
                       getattr(blk.mixer, "heads", None))
                      for blk in model.layers]}
    model.requires_grad_(True)
    loss, g = train.make_grads(cfg, mesh)(model, b)
    out["loss"] = float(loss)
    out["grads"] = {k: None if v is None else v.numpy() for k, v in g.items()}
    model.requires_grad_(False)
    fr = ref["batch"][key].get("frontend")
    fr = None if fr is None else fr[:PROMPT[0]]
    out["tokens"] = serve.greedy_generate(model, cfg, ref["prompt"][key], NEW,
                                          frontend=fr).numpy()
    bm = serve.batch_mesh(mesh, PROMPT[0])
    r = (train.rows(PROMPT[0], bm) if bm and "data" in bm.mesh_dim_names
         else slice(0, PROMPT[0]))
    out["token_rows"] = (r.start, r.stop)
    out["cache"] = cache_shapes(serve.make_cache(
        model, cfg, PROMPT[0], PROMPT[1] + NEW, frontend=fr))
    return out


def _seq_case(mesh, ref: dict) -> dict:
    """Batch 1 on (2, 2): greedy tokens, every step's logits of a
    teacher-forced decode over all positions, the cache's shapes."""
    cfg = port_cfg(SEQ_KEY)
    L = SEQ_PROMPT + NEW
    model = convert.params_from_reference(ref["params"][SEQ_KEY], cfg,
                                          device="cpu", mesh=mesh)
    seq = serve.seq_shard(mesh, cfg, 1, L)
    out = {"seq": (seq.size, seq.index),
           "tokens": serve.greedy_generate(model, cfg, ref["seq_prompt"],
                                           NEW).numpy()}
    cache = serve.make_cache(model, cfg, 1, L)
    out["cache"] = cache_shapes(cache)
    step = serve.make_serve_step(cfg, batch=1, max_len=L)
    toks = torch.from_numpy(ref["seq_forced"])
    logits = []
    with torch.no_grad():
        for i in range(L):
            lg, cache = step(model, cache, toks[:, i:i + 1])
            logits.append(lg.numpy())
    out["logits"] = np.stack(logits)
    return out


def _split_rank(rank: int, ref: dict) -> dict:
    """Every case on this rank; every rank builds every mesh in the same
    order (their groups are made on the whole world)."""
    meshes = {"m4": elastic.carve_mesh(model_parallel=4, device_type="cpu"),
              "a": elastic.carve_mesh([0, 1], 2, device_type="cpu"),
              "m22": elastic.carve_mesh(model_parallel=2, device_type="cpu")}
    out = {}
    for case in CASES:
        if sharding.member(meshes[case[1]]):
            out[case] = _case(meshes[case[1]], ref, case)
    out["seq"] = _seq_case(meshes["m22"], ref)
    return out


# -- the reference, the one process and the run ------------------------------------------

def _spec_parts(cfg, batch: int, max_len: int, dims: dict) -> dict:
    """The bytes that the reference's cache specs (the port's copy of its
    pure ``cache_specs``, held to it by tests/test_torch_mesh.py) put on
    one device of a mesh of ``dims`` for each self-attention layer's "k"
    and "v" together ("kv"), each mLSTM layer's "C", "n" and "m" and each
    Mamba layer's "conv" and "ssm"."""
    fr = torch.empty((batch, cfg.n_frontend_tokens, cfg.d_model),
                     device="meta") if cfg.cross_attn_every else None
    whole = transformer.init_cache(transformer.Transformer(cfg, device="meta"),
                                   cfg, batch, max_len, frontend=fr)
    specs = serve.cache_specs(whole, dims)
    out = {"kv": 0, "C": 0, "n": 0, "m": 0, "conv": 0, "ssm": 0}
    for lc, sp in zip(whole["layers"], specs["layers"]):
        keys = (("k", "kv"), ("v", "kv")) if "k" in lc else \
            (("C", "C"), ("n", "n"), ("m", "m")) if "C" in lc else \
            (("conv", "conv"), ("ssm", "ssm")) if "ssm" in lc else ()
        for k, kind in keys:
            n = lc[k].numel() * lc[k].element_size()
            for e in sp[k]:
                n //= 1 if e is None else sharding.axis_size(dims, e)
            out[kind] += n
    return out


@pytest.fixture(scope="module")
def run():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.launch import serve as jserve
    from repro.models import transformer as jtr
    from repro.runtime.elastic import carve_mesh as jcarve

    rng = np.random.default_rng(5)
    ref = {"params": {}, "batch": {}, "prompt": {}}
    for key in CONFIGS:
        cfg = port_cfg(key)
        ref["params"][key] = convert.params_to_reference(
            transformer.init(cfg, seed=1, device="cpu"), cfg)
        ref["batch"][key] = make_batch(cfg, DataConfig(batch=BATCH, seq=SEQ),
                                       0)
        ref["prompt"][key] = rng.integers(0, cfg.vocab,
                                          PROMPT).astype(np.int32)
    for key, twin in TWINS.items():
        for k in ref:
            ref[k][key] = ref[k][twin]
    V = port_cfg(SEQ_KEY).vocab
    ref["seq_prompt"] = rng.integers(0, V, (1, SEQ_PROMPT)).astype(np.int32)
    ref["seq_forced"] = rng.integers(0, V, (1, SEQ_PROMPT + NEW)).astype(
        np.int32)
    ranks = concurrent.futures.ThreadPoolExecutor(1).submit(
        tmesh.spawn, _split_rank, 4, ref, timeout=300)

    want = {k: {} for k in ("logits", "loss", "grads", "tokens", "specs",
                            "port_logits", "port_loss", "port_grads",
                            "port_tokens")}
    m1 = jcarve(jax.devices()[:1])
    for key in sorted({c[0] for c in CASES} | {SEQ_KEY}):
        arch, fields = CONFIGS[key]
        jcfg = dataclasses.replace(jget(arch, smoke=True), **fields)
        box = {}

        def init(k, jcfg=jcfg):
            p, box["specs"] = jtr.init(k, jcfg)
            return p
        shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
        want["specs"][key] = (shapes, box["specs"])
        if key in TWINS:
            continue
        p = jax.tree.map(jnp.asarray, ref["params"][key])
        fr = ref["batch"][key].get("frontend")
        fr = None if fr is None else fr[:PROMPT[0]]
        prompt = ref["seq_prompt"] if key == SEQ_KEY else ref["prompt"][key]
        want["tokens"][key] = np.asarray(jserve.greedy_generate(
            p, jcfg, m1, box["specs"], jnp.asarray(prompt), NEW,
            frontend=None if fr is None else jnp.asarray(fr)))
        # the one-process port on the same weights
        cfg = port_cfg(key)
        model = convert.params_from_reference(ref["params"][key], cfg,
                                              device="cpu")
        want["port_tokens"][key] = serve.greedy_generate(
            model, cfg, prompt, NEW, frontend=fr).numpy()
        if key == SEQ_KEY:
            cache = serve.make_cache(model, cfg, 1, SEQ_PROMPT + NEW)
            toks = torch.from_numpy(ref["seq_forced"])
            logits = []
            with torch.no_grad():
                for i in range(SEQ_PROMPT + NEW):
                    lg, cache = transformer.decode_step(model, cfg,
                                                        toks[:, i:i + 1], cache)
                    logits.append(lg.numpy())
            want["seq_logits"] = np.stack(logits)
            continue
        b = {k: jnp.asarray(v) for k, v in ref["batch"][key].items()}
        fwd = lambda p, b, jcfg=jcfg: jtr.forward(  # noqa: E731
            p, jcfg, **model_input(b))[0]
        vg = jax.value_and_grad(
            lambda p, b, jcfg=jcfg: jtr.loss_fn(p, jcfg, b)[0])
        (loss, g), logits = jax.jit(lambda p, b: (vg(p, b), fwd(p, b)))(p, b)
        want["loss"][key] = float(loss)
        want["logits"][key] = np.asarray(logits)
        want["grads"][key] = convert.from_reference_tree(
            jax.tree.map(np.asarray, g), cfg)
        bt = train.to_device(ref["batch"][key], cfg, "cpu")
        with torch.no_grad():
            want["port_logits"][key] = transformer.forward(
                model, cfg, **model_input(bt))[0].numpy()
        model.requires_grad_(True)
        loss, g = train.make_grads(cfg)(model, bt)
        want["port_loss"][key] = float(loss)
        want["port_grads"][key] = {k: None if v is None else v.numpy()
                                   for k, v in g.items()}
    for key, twin in TWINS.items():
        for k, v in want.items():
            if k != "specs" and isinstance(v, dict):
                v[key] = v[twin]
    return ranks.result(), want


def ranks_of(got, case):
    return [o[case] for o in got if case in o]


def _gap(g, w, part) -> float:
    """|g - w's part| over w's largest |g|."""
    scale = np.abs(w).max()
    if part is not None:
        lay, i = part
        w = lay.take(torch.from_numpy(np.array(w)), i).numpy()
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / scale) if scale else 0.0


# -- the cases -----------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_forward_matches_reference_and_one_process(run, case):
    """Each rank's logits of its rows equal the reference's and the
    one-process port's at 1e-4."""
    got, want = run
    outs = ranks_of(got, case)
    assert len(outs) == sharding.axis_size(DIMS[case[1]], ("data", "model"))
    for o in outs:
        a, b = o["rows"]
        for w in (want["logits"][case[0]], want["port_logits"][case[0]]):
            np.testing.assert_allclose(o["logits"], w[a:b], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_gradients_match_reference_and_one_process(run, case):
    """The loss of the global batch at 1e-5 and each rank's gradient of its
    part of each leaf at 1e-3 of the leaf's largest |g|, against
    ``jax.grad`` of the reference's loss and the one-process port's."""
    got, want = run
    key = case[0]
    for o in ranks_of(got, case):
        for loss, grads in ((want["loss"][key], want["grads"][key]),
                            (want["port_loss"][key],
                             want["port_grads"][key])):
            assert abs(o["loss"] - loss) <= LOSS_TOL
            for k, w in grads.items():
                w = np.asarray(w) if w is not None else None
                g = o["grads"][k]
                if g is None or w is None:  # the audio family's embed
                    assert g is None or not g.any(), k
                    assert w is None or not w.any(), k
                    continue
                assert _gap(g, w, o["parts"].get(k)) <= GRAD_TOL, k


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_greedy_tokens_match_reference_and_one_process(run, case):
    got, want = run
    for o in ranks_of(got, case):
        a, b = o["token_rows"]
        for w in (want["tokens"][case[0]], want["port_tokens"][case[0]]):
            np.testing.assert_array_equal(o["tokens"], w[a:b])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_parameter_bytes_equal_the_reference_specs(run, case):
    """Each rank holds, to the byte, what the reference's parameter specs
    put on one device of the mesh: every leaf over the sizes of the axes
    its spec names (the columns that cut a head are the reference's)."""
    import jax
    got, want = run
    shapes, specs = want["specs"][case[0]]
    dims = DIMS[case[1]]
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    total = 0
    for a, sp in zip(jax.tree.leaves(shapes),
                     jax.tree.leaves(specs, is_leaf=is_spec)):
        n = a.size * a.dtype.itemsize
        for e in sp:
            n //= 1 if e is None else sharding.axis_size(dims, e)
        total += n
    for o in ranks_of(got, case):
        assert o["param_bytes"] == total, (o["param_bytes"], total)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_cache_bytes_against_the_reference_specs(run, case):
    """Each rank's decode cache (the greedy prompt's 2 x 10 positions),
    stated against the reference's cache specs on the mesh:
    - a self-attention or cross layer holds the kv heads the rank keeps
      (``attention.kv_heads``), whole: kept / KVH of the whole leaf, M ·
      kept / KVH times the spec's where the spec splits it by M;
    - an mLSTM layer's C (B, heads, hd, w) holds the rank's own columns of
      each touched head (``layers.padded_layout``), the spec's bytes
      where they are as many in each head; n (B, heads, hd) and m (B,
      heads) are whole for the touched heads;
    - a Mamba layer's conv window (B, K - 1, di / M) is the spec's bytes,
      its state (B, heads, N, w) the rank's own columns of each touched
      head: the spec's bytes (which split P, or the heads, by M) where
      they are as many in each head, 4/3 of them on ranks 1 and 2 of
      jamba-3h (2 heads of 32 padded columns for 48 columns)."""
    got, want = run
    key, mesh = case
    cfg = port_cfg(key)
    dims, B, L = DIMS[mesh], PROMPT[0], PROMPT[1] + NEW
    M = dims["model"]
    D = dims["data"]
    spec = _spec_parts(cfg, B, L, dims)
    for r, o in enumerate(ranks_of(got, case)):
        b = B // D          # the decode batch splits over "data"
        r_model = r % M
        kv = attention.kv_heads(cfg, M, r_model)
        kept = kv.stop - kv.start if isinstance(kv, slice) else len(kv)
        sp = xlstm.mlstm_split(cfg, M, r_model)
        w = layers.padded_layout(sp)[0]
        di, H, P, N = mamba._dims(cfg)
        ms = layers.head_split(H, P, M, r_model)
        mw = layers.padded_layout(ms)[0]
        port = {"kv": 0, "C": 0, "n": 0, "m": 0, "conv": 0, "ssm": 0}
        for (mixer, *_), sh in zip(o["mixers"], o["cache"]):
            if mixer == "attn":
                assert sh["k"] == sh["v"] == (b, kept, L, cfg.hd), sh
                port["kv"] += 2 * b * kept * L * cfg.hd * 4
            elif mixer == "cross":
                assert sh["ck"][:2] == (b, kept), sh
            elif mixer == "mlstm":
                assert sh == {"C": (b, sp.n, sp.hd, w), "n": (b, sp.n, sp.hd),
                              "m": (b, sp.n)}, sh
                port["C"] += b * sp.n * sp.hd * w * 4
                port["n"] += b * sp.n * sp.hd * 4
                port["m"] += b * sp.n * 4
            elif mixer == "mamba":
                assert sh == {"conv": (b, cfg.ssm_conv - 1, di // M),
                              "ssm": (b, ms.n, N, mw)}, sh
                port["conv"] += b * (cfg.ssm_conv - 1) * di // M * 4
                port["ssm"] += b * ms.n * N * mw * 4
        n_attn = sum(m == "attn" for m, *_ in o["mixers"])
        whole_kv = n_attn * 2 * b * cfg.n_kv_heads * L * cfg.hd * 4
        assert port["kv"] * cfg.n_kv_heads == whole_kv * kept
        if n_attn and key == "musicgen":
            # the spec puts "model" on hd = 8: a quarter; the port 2 of 6
            assert spec["kv"] * 4 == whole_kv and kept == 2
            assert port["kv"] * 3 == spec["kv"] * 4
        if key in ("xlstm", "xlstm-1h"):
            assert port["C"] == spec["C"], (port, spec)
        if key == "xlstm-3h":
            # 24 columns a rank: all in one head on ranks 0 and 3, 8 + 16
            # in two heads on ranks 1 and 2 (padded to 2 x 16)
            assert w == (24 if r in (0, 3) else 16)
            assert port["C"] * 3 == spec["C"] * (3 if r in (0, 3) else 4)
        if port["ssm"]:
            assert port["conv"] == spec["conv"], (port, spec)
            uneven = key == "jamba-3h" and r in (1, 2)
            assert port["ssm"] * 3 == spec["ssm"] * (4 if uneven else 3), (
                r, port, spec)
        if port["n"]:
            n_mlstm = sum(m == "mlstm" for m, *_ in o["mixers"])
            assert port["n"] == n_mlstm * b * sp.n * sp.hd * 4
            assert port["m"] == n_mlstm * b * sp.n * 4


def test_heads_a_rank(run):
    """The heads each rank computes: musicgen's 1.5 heads a rank touch 2
    (32 head computations for 24 on (1, 16) FULL too); xlstm's half and
    quarter heads 1; the straddle config on (1, 2) repeats its kv heads
    to one a query head (heads 0, 1 use kv head 0, head 2 kv head 1)."""
    got, _ = run
    for o in ranks_of(got, ("musicgen", "m4")):
        assert {(m[1].n, m[3]) for m in o["mixers"]} == {(2, (2, 2))}
        assert not any(m[1].whole for m in o["mixers"])
    for key, own in (("xlstm", 16), ("xlstm-1h", 16)):
        for o in ranks_of(got, (key, "m4")):
            for mixer, sp, *_ in o["mixers"]:
                if mixer == "mlstm":
                    assert sp.n == 1 and sp.own.stop - sp.own.start == own
    kvs = [[m[2] for m in o["mixers"]] for o in ranks_of(got, ("straddle",
                                                                "a"))]
    assert kvs == [[[0, 0, 1]] * 2, [[1, 2, 2]] * 2]
    for r in range(4):
        sp = attention.head_split(6, 8, 4, r)
        assert sp.n == 2 and sp.own == (slice(0, 12) if r % 2 == 0
                                        else slice(4, 16))
    full = get_config("musicgen-medium")
    assert {attention.head_split(24, 64, 16, r).n for r in range(16)} == {2}
    x = get_config("xlstm-125m")
    for m in (8, 16):
        assert {xlstm.mlstm_split(x, m, r).n for r in range(m)} == {1}


def test_mamba_columns_a_rank(run):
    """The columns of Mamba's heads each rank scans
    (``HeadSplit.widths``): jamba-2h's half a head (32 of 64) on (1, 4)
    and a whole head on (2, 2) with FSDP; jamba-3h's 48 columns all in
    one head on ranks 0 and 3 and in two, 16 + 32 and 32 + 16, on ranks 1
    and 2; jamba-par's two whole heads of 16."""
    got, _ = run
    for key, mesh, want in (("jamba-2h", "m4", [[32]] * 4),
                            ("jamba-2h-fsdp", "m22", [[64]] * 2),
                            ("jamba-3h", "m4", [[48], [16, 32], [32, 16],
                                                [48]]),
                            ("jamba-par", "m4", [[16, 16]] * 4)):
        M = DIMS[mesh]["model"]
        for r, o in enumerate(ranks_of(got, (key, mesh))):
            widths = [sp.widths() for mixer, sp, *_ in o["mixers"]
                      if mixer == "mamba"]
            assert widths == [want[r % M]], (key, r, widths)


@pytest.mark.parametrize("form", ["plain", "chunked", "reference"])
def test_scan_of_a_heads_columns_is_those_columns_of_the_whole_scan(form):
    """The SSD recurrence is separable over a head's P columns (the decay
    is the head's, b and c are shared): the scan of any rank's block of
    the (heads · P) columns, laid out as its own columns of each touched
    head with zero columns where they lie unevenly
    (``layers.padded_layout``), equals those columns of the whole scan,
    output and final state, and its zero columns give zeros — for the
    sequential ``mamba_scan.plain``, ``mamba_scan.chunked`` (the
    kernel's three steps, on the CPU) and the reference's
    ``ref.ssd_scan``; 3 heads of 16 over 2 to 16 ranks."""
    from repro_torch.kernels import mamba_scan
    rng = np.random.default_rng(3)
    B, S, H, P, N = 2, 40, 3, 16, 4
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    a = rng.uniform(0.3, 1.0, (B, S, H)).astype(np.float32)
    b, c = (rng.standard_normal((B, S, N)).astype(np.float32)
            for _ in range(2))
    if form == "reference":
        import jax.numpy as jnp
        from repro.kernels import ref as jref

        def scan(*ts):
            y, h = jref.ssd_scan(*(jnp.asarray(t.numpy()) for t in ts))
            return torch.from_numpy(np.array(y)), torch.from_numpy(
                np.array(h))
    elif form == "chunked":
        scan = lambda *ts: mamba_scan.chunked(*ts, 8)  # noqa: E731
    else:
        scan = mamba_scan.plain
    x, a, b, c = (torch.from_numpy(t) for t in (x, a, b, c))
    y, h = scan(x, a, b, c)
    cols_y = y.flatten(-2)                                  # (B, S, H · P)
    cols_h = h.permute(0, 2, 1, 3).flatten(-2)              # (B, N, H · P)
    for m in (2, 3, 4, 6, 16):
        for r in range(m):
            sp = layers.head_split(H, P, m, r)
            lay = layers.padded_layout(sp)
            xr = layers.pad_heads(x.flatten(-2)[..., sp.cols], lay)
            yr, hr = scan(xr, a[..., sp.heads].contiguous(), b, c)
            assert yr.shape == xr.shape
            assert hr.shape == (B, sp.n, N, lay[0])
            got_y = layers.own_columns(yr.flatten(-2), lay)
            got_h = layers.own_columns(hr.permute(0, 2, 1, 3).flatten(-2),
                                       lay)
            torch.testing.assert_close(got_y, cols_y[..., sp.cols],
                                       rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(got_h, cols_h[..., sp.cols],
                                       rtol=1e-5, atol=1e-5)
            pad = layers.pad_heads(torch.ones(sp.cols.stop - sp.cols.start),
                                   lay) == 0                # (heads, w)
            assert not yr[..., pad].any()
            assert not hr.permute(0, 2, 1, 3)[..., pad].any()


def test_sequence_sharded_cache_inside_a_head(run):
    """Batch 1 on (2, 2), musicgen with 3 heads of 16 (1.5 heads a rank):
    the cache splits along the sequence over "data" (12 of 24 positions a
    rank) and holds the 2 heads the rank computes; greedy tokens equal the
    reference's and the one process's, every step's logits of a
    teacher-forced decode the one process's at 1e-4.  Its keys and values
    are 4/3 of the spec's (which splits the sequence over "data" and hd
    over "model")."""
    got, want = run
    cfg = port_cfg(SEQ_KEY)
    L = SEQ_PROMPT + NEW
    spec = _spec_parts(cfg, 1, L, DIMS["m22"])
    for r, o in enumerate(got):
        o = o["seq"]
        assert o["seq"] == (2, r // 2)
        for w in (want["tokens"][SEQ_KEY], want["port_tokens"][SEQ_KEY]):
            np.testing.assert_array_equal(o["tokens"], w)
        np.testing.assert_allclose(o["logits"], want["seq_logits"],
                                   rtol=TOL, atol=TOL)
        kv = sum(2 * np.prod(c["k"]) * 4 for c in o["cache"] if "k" in c)
        assert all(c["k"] == (1, 2, L // 2, cfg.hd) for c in o["cache"]
                   if "k" in c)
        assert kv * 3 == spec["kv"] * 4


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(
    map(str, d.values())))
def test_check_ported_accepts_every_full_config(dims):
    """No FULL config is refused on the meshes the reference runs
    (musicgen-medium's 24 heads at M = 16 and xlstm-125m's 4 heads from
    M = 8 included: their columns cut a head)."""
    for arch in ARCHS:
        transformer.check_ported(get_config(arch), dims)
