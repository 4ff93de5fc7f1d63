"""Port parity of tensor parallelism: every "model" entry of
``transformer.param_specs`` realized as a shard (``layers.layout``), in 4
gloo processes on the CPU against ``repro``.

One launch of 4 ranks (``launch.mesh.spawn``) runs every case while this
process computes the reference (one device) and, in a subprocess on 4
forced host devices, the reference's ``NamedSharding`` shard shapes.  The
weights are drawn once by the port's seeded ``transformer.init`` (the
reference's scheme) as the reference's tree, which the reference takes
as its parameters and every rank carries in
(``convert.params_from_reference`` keeps the rank's part of each leaf).

- Forward logits of the SMOKE config of every family against the
  reference's ``transformer.forward``: tinyllama on (1, 2) (kv heads
  split) and on (1, 4) (2 kv heads over 4 ranks: each rank gathers the
  keys and values and keeps the kv head its query head uses), stablelm
  (``parallel_block``), codeqwen (``qkv_bias``), musicgen (``embeds=``),
  llama-vision (cross attention), jamba (Mamba + MoE), deepseek without
  and with ``moe_ep``, xlstm (mLSTM + sLSTM) on (1, 2).  The two (1, 2)
  meshes, ranks 0-1 and 2-3, run half the cases each.
- The gradients of the loss against ``jax.grad`` of the reference's
  ``loss_fn``, each rank's part of a sharded leaf against that part of
  the reference's (``Layout.take``), a replicated leaf whole: the
  all-reduce both ways of Mamba's ``bc_proj`` / ``dt_proj`` and of the
  norms over a split dimension (trap 2), the replicated leaves used in
  part through ``copy_to`` (trap 3: ``dt_bias``, ``a_log``, the mLSTM's
  ``wi`` / ``wf`` / ``norm``, the sLSTM's ``down``), the gathered kv heads
  and the vocab-parallel embedding and head.
- Greedy tokens against the reference's ``greedy_generate`` (the caches
  of the rank's kv heads, Mamba channels, mLSTM heads, cross keys).
- ``params_to_reference`` after ``params_from_reference`` on every mesh
  gives the reference's tree back byte for byte (``convert.whole`` undoes
  the fused leaves' placement).
- ``fit`` on (2, 2) with a checkpoint, ``simulate_failure(n_lost=2)``
  and the restart on (1, 2) at the uninterrupted losses (1e-5), those at
  the one-process fit's (1e-5), and the checkpoint restored whole by the
  reference's ``Checkpointer``.
- Per-leaf shard shapes of every FULL config, as published and with
  ``moe_ep``, on (1, 4) and (2, 2) against ``NamedSharding(mesh,
  spec).shard_shape`` of the reference's whole spec; the fused leaves'
  permutation stated.
- ``check_ported`` building a split the reference makes of a head
  (tests/test_torch_split_heads.py runs them) and refusing what stays
  refused.

Tolerances are each family's one-process ones from its own test file:
logits 1e-4 (jamba's stack 1e-3, tests/test_torch_moe_hybrid.py), the
loss 1e-5 and each gradient leaf 1e-4 of its largest |g|, jamba's within
twice the reference's own one-ulp spread (tests/test_torch_train.py).
The reference is imported inside the fixtures: the ranks import this
module and run no JAX.
"""
import concurrent.futures
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import sharding
from repro_torch.core.sharding import P
from repro_torch.data import DataConfig, Loader, make_batch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve, train
from repro_torch.models import convert, layers, transformer
from repro_torch.runtime import elastic

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TOL, LOSS_TOL = 1e-4, 1e-5
STACK_TOL = {"jamba-1.5-large-398b": 1e-3}
#: families whose gradients are held within twice the reference's own
#: one-ulp spread (tests/test_torch_train.py)
SPREAD = {"jamba-1.5-large-398b"}
BATCH, SEQ = 2, 16
CE_CHUNKS = 3                   # 32 vocab columns a rank in chunks of 11
PROMPT, NEW = (2, 6), 4
FIT_STEPS, FIT_BATCH, FIT_SEQ = 4, 4, 16
FIT_OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=FIT_STEPS)
FIT_ARCH = "tinyllama-1.1b"

#: (arch, moe_ep, mesh): "a" / "b" the (1, 2) meshes of ranks 0-1 / 2-3,
#: "m4" the (1, 4) mesh of all four
CASES = [("tinyllama-1.1b", False, "a"), ("stablelm-12b", False, "a"),
         ("codeqwen1.5-7b", False, "a"), ("musicgen-medium", False, "a"),
         ("deepseek-moe-16b", True, "a"),
         ("llama-3.2-vision-11b", False, "b"),
         ("jamba-1.5-large-398b", False, "b"),
         ("deepseek-moe-16b", False, "b"), ("xlstm-125m", False, "b"),
         ("tinyllama-1.1b", False, "m4")]
#: the cases whose gradients and greedy tokens are compared too
GRAD = {("tinyllama-1.1b", False, "m4"), ("stablelm-12b", False, "a"),
        ("deepseek-moe-16b", True, "a"), ("jamba-1.5-large-398b", False, "b"),
        ("xlstm-125m", False, "b")}
#: seeded models built on a mesh (arch, moe_ep, mesh), their leaves drawn
#: in slabs of SLAB elements
SEEDED = [("stablelm-12b", False, "a"), ("jamba-1.5-large-398b", True, "b")]
SLAB = 1 << 10
GREEDY = {("tinyllama-1.1b", False, "m4"), ("jamba-1.5-large-398b", False, "b"),
          ("xlstm-125m", False, "b"), ("llama-3.2-vision-11b", False, "b")}

REF_SHARDS = r"""
import json, sys; sys.path.insert(0, sys.argv[1])
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, get_config
from repro.models import transformer as jtr

def flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out

out = {}
for arch in ARCHS:
    cfg = get_config(arch)
    box = {}
    def make(k):
        p, box["specs"] = jtr.init(k, cfg)
        return p
    shapes = flat(jax.eval_shape(make, jax.random.PRNGKey(0)))
    specs = flat(box["specs"])
    for dims in ((1, 4), (2, 2)):
        mesh = jax.make_mesh(dims, ("data", "model"))
        out[f"{arch}/{dims}"] = {k: [list(s.shape),
            list(NamedSharding(mesh, specs[k]).shard_shape(s.shape))]
            for k, s in shapes.items()}
json.dump(out, open(sys.argv[2], "w"))
"""


def port_cfg(arch: str, ep: bool):
    return dataclasses.replace(get_config(arch, smoke=True), moe_ep=ep)


def model_input(batch: dict) -> dict:
    """``batch``'s forward inputs (all but the labels)."""
    return {k: v for k, v in batch.items() if k != "labels"}


# -- the ranks ------------------------------------------------------------------------

def _case(mesh, ref: dict, case) -> dict:
    arch, ep, _ = case
    cfg = port_cfg(arch, ep)
    tree = ref["params"][arch]
    model = convert.params_from_reference(tree, cfg, device="cpu", mesh=mesh)
    b = train.to_device(ref["batch"][arch], cfg, "cpu")
    with torch.no_grad():
        logits, _ = transformer.forward(model, cfg, **model_input(b))
    out = {"logits": logits.numpy(),
           "shapes": {k: tuple(v.shape) for k, v in model.named_parameters()},
           "round_trip": convert.params_to_reference(model, cfg)}
    if case in GRAD:
        model.requires_grad_(True)
        loss, _ = transformer.loss_fn(model, cfg, b)
        named = dict(model.named_parameters())
        gs = torch.autograd.grad(loss, list(named.values()),
                                 allow_unused=True)
        out["loss"] = float(loss)
        out["grads"] = {k: None if g is None else g.numpy()
                        for k, g in zip(named, gs)}
        out["parts"] = {k: (lay, i) for k, (lay, i) in
                        transformer.leaf_parts(model).items()}
        if case[2] == "m4":     # the streamed CE over each rank's vocab
            loss, _ = transformer.loss_fn(model, cfg, b,
                                          loss_chunks=CE_CHUNKS)
            gs = torch.autograd.grad(loss, list(named.values()))
            out["chunked"] = (float(loss), {k: g.numpy()
                                            for k, g in zip(named, gs)})
        model.requires_grad_(False)
    if case in GREEDY:
        fr = ref["batch"][arch].get("frontend")
        out["tokens"] = serve.greedy_generate(
            model, cfg, ref["prompt"][arch], NEW,
            frontend=None if fr is None else fr[:PROMPT[0]]).numpy()
    return out


def _seeded(mesh, arch: str, ep: bool) -> dict:
    """The seeded model on ``mesh`` against the one-process model of the
    same seed: each rank's leaves, drawn a slab at a time, equal its parts
    of the whole leaves (``Layout.take`` of ``transformer.leaf_parts``)."""
    cfg = port_cfg(arch, ep)
    whole = transformer.init(port_cfg(arch, False), seed=3, device="cpu")
    model = transformer.init(cfg, seed=3, device="cpu", mesh=mesh)
    got = dict(model.named_parameters())
    cut = transformer.leaf_parts(model)
    parts = {k: v if k not in cut else cut[k][0].take(v, cut[k][1])
             for k, v in whole.named_parameters()}
    return {"names": set(got) == set(parts),
            "equal": [k for k, v in got.items()
                      if not torch.equal(v, parts[k])],
            "sharded": sorted(transformer.sharded_leaves(model))}


def _fit(cfg, mesh, steps, ck=None, every=0):
    return train.fit(cfg, steps=steps, data_loader=Loader(
        cfg, DataConfig(batch=FIT_BATCH, seq=FIT_SEQ)),
        ocfg=optim.AdamWConfig(**FIT_OCFG), checkpointer=ck,
        checkpoint_every=every, log_every=0, device="cpu", mesh=mesh)[2]


def _tp_rank(rank: int, ref: dict, ckdir: str) -> dict:
    """Every case on this rank; every rank builds every mesh in the same
    order (their groups are made on the whole world)."""
    meshes = {"a": elastic.carve_mesh([0, 1], 2, device_type="cpu"),
              "b": elastic.carve_mesh([2, 3], 2, device_type="cpu"),
              "m4": elastic.carve_mesh(model_parallel=4, device_type="cpu")}
    out = {}
    for case in CASES:
        if sharding.member(meshes[case[2]]):
            out[case] = _case(meshes[case[2]], ref, case)
    draw = layers.DRAW_ELEMS
    layers.DRAW_ELEMS = SLAB
    for arch, ep, key in SEEDED:
        if sharding.member(meshes[key]):
            out[("seeded", arch)] = _seeded(meshes[key], arch, ep)
    layers.DRAW_ELEMS = draw
    cfg = get_config(FIT_ARCH, smoke=True)
    m22 = elastic.carve_mesh(model_parallel=2, device_type="cpu")
    out["whole"] = _fit(cfg, m22, FIT_STEPS)
    ck = os.path.join(ckdir, "tp")
    out["first"] = _fit(cfg, m22, FIT_STEPS // 2, Checkpointer(ck),
                        FIT_STEPS // 2)
    m12 = elastic.simulate_failure(m22, n_lost=2, model_parallel=2)
    out["m12"] = dict(zip(m12.mesh_dim_names, m12.shape))
    if sharding.member(m12):
        out["resumed"] = _fit(cfg, m12, FIT_STEPS, Checkpointer(ck),
                              FIT_STEPS // 2)
    return out


# -- the reference and the run ------------------------------------------------------------

def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.launch import serve as jserve
    from repro.models import transformer as jtr
    from repro.runtime.elastic import carve_mesh as jcarve

    d = tmp_path_factory.mktemp("tp")
    child = subprocess.Popen(
        [sys.executable, "-c", REF_SHARDS, SRC, str(d / "shards.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    archs = sorted({a for a, _, _ in CASES})
    ref = {"params": {}, "batch": {}, "prompt": {}}
    jparams, jspecs = {}, {}
    rng = np.random.default_rng(5)
    for arch in archs:
        jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
        box = {}

        def init(k):
            p, box["specs"] = jtr.init(k, jcfg)
            return p
        jax.eval_shape(init, jax.random.PRNGKey(0))
        jspecs[arch] = box["specs"]
        # the weights: the port's seeded draw (the reference's scheme) in
        # the reference's tree, which jit would take minutes to draw here
        ref["params"][arch] = convert.params_to_reference(
            transformer.init(cfg, seed=1, device="cpu"), cfg)
        jparams[arch] = jax.tree.map(jnp.asarray, ref["params"][arch])
        ref["batch"][arch] = make_batch(cfg, DataConfig(batch=BATCH,
                                                        seq=SEQ), 0)
        ref["prompt"][arch] = rng.integers(0, jcfg.vocab,
                                           PROMPT).astype(np.int32)
    ranks = concurrent.futures.ThreadPoolExecutor(1).submit(
        tmesh.spawn, _tp_rank, 4, ref, str(d), timeout=300)

    want = {"logits": {}, "grads": {}, "loss": {}, "tokens": {}, "spread": {}}
    m1 = jcarve(jax.devices()[:1])
    for arch in archs:
        jcfg, p = jget(arch, smoke=True), jparams[arch]
        b = {k: jnp.asarray(v) for k, v in ref["batch"][arch].items()}
        fwd = lambda p, b: jtr.forward(p, jcfg, **model_input(b))[0]  # noqa: E731
        if any(c[0] == arch for c in GRAD):
            vg = jax.value_and_grad(lambda p, b: jtr.loss_fn(p, jcfg, b)[0])
            both = jax.jit(lambda p, b: (vg(p, b), fwd(p, b)))
            (loss, g), logits = both(p, b)
            want["loss"][arch] = float(loss)
            want["grads"][arch] = convert.from_reference_tree(
                _np_tree(g), get_config(arch, smoke=True))
            if arch in SPREAD:
                want["spread"][arch] = reference_spread(
                    lambda p, b: both(p, b)[0], p, b, g)
        else:
            logits = jax.jit(fwd)(p, b)
        want["logits"][arch] = np.asarray(logits)
        if any(c[0] == arch for c in GREEDY):
            fr = b.get("frontend")
            want["tokens"][arch] = np.asarray(jserve.greedy_generate(
                p, jcfg, m1, jspecs[arch], jnp.asarray(ref["prompt"][arch]),
                NEW, frontend=None if fr is None else fr[:PROMPT[0]]))
    fcfg = get_config(FIT_ARCH, smoke=True)
    want["fit"] = _fit(fcfg, None, FIT_STEPS, Checkpointer(str(d / "one")),
                       FIT_STEPS)
    got = ranks.result()
    _, err = child.communicate(timeout=300)
    assert child.returncode == 0, err[-3000:]
    with open(d / "shards.json") as f:
        want["shards"] = json.load(f)
    return got, want, ref, d


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


def ranks_of(got, case):
    return [o[case] for o in got if case in o]


# -- the cases -----------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-ep{c[1]}-{c[2]}")
def test_forward_matches_reference(run, case):
    """Every rank's logits (the vocab columns gathered) equal the
    reference's at the family's one-process tolerance, and every rank
    holds 1 / M of each leaf the specs shard."""
    got, want, _, _ = run
    outs = ranks_of(got, case)
    assert len(outs) == (4 if case[2] == "m4" else 2)
    tol = STACK_TOL.get(case[0], TOL)
    w = want["logits"][case[0]]
    for o in outs:
        np.testing.assert_allclose(o["logits"], w, rtol=tol, atol=tol)
    m = len(outs)
    cfg = port_cfg(*case[:2])
    whole = {k: tuple(v.shape) for k, v in
             transformer.Transformer(port_cfg(case[0], False),
                                     device="meta").named_parameters()}
    specs = transformer.param_specs(cfg)
    for k, shape in outs[0]["shapes"].items():
        lay = layers.layout(k, specs[k], whole[k], m)
        assert shape == (lay.local(whole[k]) if lay else whole[k]), k
    assert outs[0]["shapes"]["embed"][0] == cfg.vocab // m


@pytest.mark.parametrize("case", sorted(GRAD), ids=lambda c: f"{c[0]}-{c[2]}")
def test_gradients_match_reference(run, case):
    """The loss at 1e-5 and each rank's gradient of each leaf — its part
    of a sharded leaf, a replicated leaf whole — at 1e-4 of the
    reference's largest |g| of that leaf (jamba within twice the
    reference's own one-ulp spread)."""
    got, want, _, _ = run
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
            if k in o["parts"]:
                lay, i = o["parts"][k]
                full = w
                w = lay.take(torch.from_numpy(w.copy()), i).numpy()
                scale = np.abs(full).max()
            else:
                scale = np.abs(w).max()
            assert g.shape == w.shape, k
            if scale:
                gap = max(gap, float(np.abs(g - w).max() / scale))
    if arch in SPREAD:
        reach = want["spread"][arch]
        assert reach > TOL and gap <= 2 * reach, (gap, reach)
    else:
        assert gap <= TOL, gap


def test_streamed_ce_combines_the_ranks_vocab(run):
    """``loss_fn(loss_chunks=3)`` on (1, 4): each rank streams its 32
    vocab columns in chunks and the ranks' maxima, sums and gold logits
    are combined; the loss equals the reference's whole-logits loss at
    1e-5 and each gradient part its own whole-logits one at 1e-4 of the
    leaf's largest |g| (tests/test_torch_train.py's chunked-CE bounds)."""
    got, want, _, _ = run
    case = ("tinyllama-1.1b", False, "m4")
    for o in ranks_of(got, case):
        loss, grads = o["chunked"]
        assert abs(loss - want["loss"][case[0]]) <= LOSS_TOL
        for k, g in grads.items():
            w = o["grads"][k]
            assert np.abs(g - w).max() <= TOL * np.abs(w).max(), k


@pytest.mark.parametrize("case", sorted(GREEDY), ids=lambda c: f"{c[0]}-{c[2]}")
def test_greedy_tokens_match_reference(run, case):
    got, want, _, _ = run
    for o in ranks_of(got, case):
        np.testing.assert_array_equal(o["tokens"], want["tokens"][case[0]])


def test_round_trip_is_byte_identical(run):
    """``params_to_reference`` after ``params_from_reference``: the
    reference's tree back byte for byte on every rank of every mesh — the
    ranks' parts gathered and the fused leaves' halves put back."""
    import jax
    got, _, ref, _ = run
    for case in CASES:
        for o in ranks_of(got, case):
            w = ref["params"][case[0]]
            assert jax.tree.structure(w) == jax.tree.structure(
                o["round_trip"])
            for a, b in zip(jax.tree.leaves(w),
                            jax.tree.leaves(o["round_trip"])):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", [a for a, _, _ in SEEDED])
def test_seeded_parts_equal_the_one_process_draw(run, arch):
    """``transformer.init`` on a mesh: every rank draws each leaf as one
    process does, a slab of rows at a time (``layers.leaf``; slabs of
    1,024 elements here, so the embedding, the head and each expert take
    several), and keeps its part — the part of the one-process model of
    the same seed that ``Layout.take`` cuts, bit for bit; the
    dense leaves and (jamba, ``moe_ep``) the experts are sharded."""
    got, _, _, _ = run
    outs = [o[("seeded", arch)] for o in got if ("seeded", arch) in o]
    assert len(outs) == 2
    for o in outs:
        assert o["names"] and o["equal"] == [], o["equal"]
        assert {"embed", "lm_head", "layers.0.mixer.wq",
                "layers.0.mixer.wo"} <= set(o["sharded"])
        if arch.startswith("jamba"):
            assert {"layers.0.ffn.wi", "layers.1.mixer.in_proj",
                    "layers.1.mixer.norm"} <= set(o["sharded"])


def test_fit_restarts_onto_a_smaller_model_group(run):
    """``fit`` on (2, 2) (tensor parallel over 2, data parallel over 2):
    the uninterrupted losses at the one-process fit's (1e-5); stopped at a
    checkpoint, two ranks lost, resumed on (1, 2) at the uninterrupted
    losses (1e-5)."""
    got, want, _, _ = run
    whole = got[0]["whole"]
    np.testing.assert_allclose(whole, want["fit"], rtol=1e-5, atol=1e-5)
    for o in got:
        assert o["whole"] == whole and o["first"] == whole[:FIT_STEPS // 2]
        assert o["m12"] == {"data": 1, "model": 2}
    for o in got[:2]:
        np.testing.assert_allclose(o["resumed"], whole[FIT_STEPS // 2:],
                                   rtol=1e-5, atol=1e-5)
    assert all("resumed" not in o for o in got[2:])


def test_tp_checkpoint_restores_whole_in_the_reference(run):
    """The (1, 2) restart's last checkpoint, written by rank 0 with every
    sharded leaf gathered: the reference's ``Checkpointer`` restores the
    reference's tree whole (every leaf the shape and dtype of its
    ``init``'s), and it is the one-process fit's at 5e-3 (Adam's
    normalised steps amplify float32's last bits)."""
    import jax
    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro.configs import get_config as jget
    from repro.models import transformer as jtr
    _, _, _, d = run
    tree, man = JCheckpointer(str(d / "tp")).restore()
    one, man1 = JCheckpointer(str(d / "one")).restore()
    assert man["step"] == man1["step"] == FIT_STEPS
    shapes = jax.eval_shape(lambda k: jtr.init(k, jget(FIT_ARCH, smoke=True))[0],
                            jax.random.PRNGKey(0))
    assert jax.tree.structure(tree["params"]) == jax.tree.structure(shapes)
    for a, s, b in zip(jax.tree.leaves(tree["params"]),
                       jax.tree.leaves(shapes),
                       jax.tree.leaves(one["params"])):
        assert a.shape == s.shape and a.dtype == s.dtype
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=5e-3,
                                   atol=5e-3)


def _flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dims", [(1, 4), (2, 2)])
@pytest.mark.parametrize("ep", [False, True], ids=["published", "moe_ep"])
def test_shard_shapes_match_named_sharding(run, arch, dims, ep):
    """Every leaf of the FULL config, as published and with ``moe_ep``:
    the rank's shape under the layout rule equals ``NamedSharding(mesh,
    spec).shard_shape`` of the reference's whole spec on a (data, model)
    mesh of ``dims`` (a group leaf with its repeat axis), the experts'
    "model" entry and the FSDP configs' "data" entries included: no leaf
    is excepted."""
    _, want, _, _ = run
    ref = want["shards"][f"{arch}/{dims}"]
    cfg = dataclasses.replace(get_config(arch), moe_ep=ep)
    d, m = dims
    whole = {k: tuple(v.shape) for k, v in transformer.Transformer(
        dataclasses.replace(cfg, moe_ep=False),
        device="meta").named_parameters()}
    specs = transformer.param_specs(cfg)
    local, ranks = {}, {}
    for k, shape in whole.items():
        lay = layers.layout(k, specs[k], shape, m, d)
        local[k] = lay.local(shape) if lay else shape
        ranks[k] = math.prod(s.n for s in lay.splits) if lay else 1
    got = _flat(convert.reference_tree(
        local, cfg, stack=lambda ss: (len(ss), *ss[0])))
    ranks = _flat(convert.reference_tree(ranks, cfg, stack=lambda ss: ss[0]))
    assert set(got) == set(ref)
    for k, shape in got.items():
        full, shard = ref[k]
        assert tuple(shape) == tuple(shard), (k, shape, shard)
        assert math.prod(full) == ranks[k] * math.prod(shape), k


def test_fused_leaves_hold_a_block_of_each_half():
    """The fused leaves' permutation, stated: the reference's block r of
    ``wi`` (d, 2f) ``P(e, "model")`` is the contiguous columns [r·2f/M,
    (r+1)·2f/M); the port's rank r holds gate columns [r·f/M, (r+1)·f/M)
    and up columns [f + r·f/M, f + (r+1)·f/M) — the same number of
    bytes — and ``assemble`` of the ranks' parts is the whole, bit for
    bit.  The same for Mamba's ``in_proj`` (x | z) and the sLSTM's
    ``up`` (g | u); ``wq`` is contiguous, and so are the experts' leading
    dimension, with or without ``moe_ep``."""
    f, m = 12, 4
    w = torch.randn(5, 2 * f, generator=torch.Generator().manual_seed(0))
    for name in ("layers.0.ffn.wi", "layers.1.ffn.shared.wi",
                 "layers.2.mixer.in_proj", "layers.3.mixer.up"):
        lay = layers.layout(name, P(None, "model"), w.shape, m)
        split = lay.split("model")
        assert split.fused and lay.axes == ("model",)
        for r in range(m):
            assert split.parts(r) == [slice(r * f // m, (r + 1) * f // m),
                                      slice(f + r * f // m,
                                            f + (r + 1) * f // m)]
        parts = [lay.take(w, {"model": r}) for r in range(m)]
        assert all(p.shape == (5, 2 * f // m) for p in parts)
        assert torch.equal(split.assemble(parts), w)
    lay = layers.layout("layers.0.mixer.wq", P(None, "model"), w.shape, m)
    assert not lay.split("model").fused
    assert lay.split("model").parts(1) == [slice(6, 12)]
    assert layers.layout("layers.0.ffn.wi", P("model", None, None),
                         (8, 5, 2 * f), m).split("model").parts(3) == \
        [slice(6, 8)]
    with pytest.raises(ValueError, match="does not split"):
        layers.layout("layers.0.ffn.wi", P(None, "model"), (5, 2 * 6), 4)


def test_check_ported_refuses_a_split_head():
    """A split the reference makes of a head builds: musicgen SMOKE (6
    heads of 8 over a "model" axis of 4, 1.5 heads a rank), xlstm SMOKE (2
    heads over 4, half a head), a rank's query heads that straddle two
    kv heads, and Mamba heads that do not divide (jamba SMOKE with heads
    of 64: 2 over 4, half a head a rank; a head's columns scan apart);
    what stays refused raises and names the config and M: a vocab that
    does not divide."""
    cfg = get_config("musicgen-medium", smoke=True)
    transformer.check_ported(cfg, {"data": 1, "model": 4})
    transformer.check_ported(cfg, {"data": 2, "model": 2})
    transformer.check_ported(get_config("xlstm-125m", smoke=True),
                             {"data": 1, "model": 4})
    odd = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                              vocab=130)
    with pytest.raises(ValueError, match=r"tinyllama-smoke.* 4 model ranks"
                                         r".*embed"):
        transformer.check_ported(odd, {"data": 1, "model": 4})
    straddle = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                                   n_heads=6, n_kv_heads=3, d_model=48)
    transformer.check_ported(straddle, {"model": 2})
    wide = dataclasses.replace(get_config("jamba-1.5-large-398b", smoke=True),
                               ssm_head_dim=64)
    transformer.check_ported(wide, {"data": 1, "model": 4})
    transformer.check_ported(wide, {"data": 1, "model": 2})
    transformer.check_ported(dataclasses.replace(wide, fsdp=True),
                             {"data": 2, "model": 2})


def test_check_ported_refuses_a_parallel_block_mixer_other_than_attention():
    """A ``parallel_block`` layer with a dense FFN adds whatever its mixer
    returns to the FFN's, the ranks' partial sums of both in one
    all-reduce: jamba SMOKE (Mamba and attention mixers) made parallel
    builds on "model" axes of 2 and 4 and on one, and so do llama-vision
    SMOKE's cross layers; what stays refused raises and names the config
    and M: jamba's 4 experts over 8 model ranks."""
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b", smoke=True),
                              parallel_block=True)
    transformer.check_ported(cfg, {"data": 1, "model": 2})
    transformer.check_ported(cfg, {"data": 1, "model": 4})
    transformer.check_ported(cfg, {"data": 2, "model": 1})
    transformer.check_ported(dataclasses.replace(
        get_config("llama-3.2-vision-11b", smoke=True), parallel_block=True),
        {"data": 1, "model": 4})
    with pytest.raises(ValueError, match=r"jamba-smoke: the 4 experts do "
                                         r"not split over 8 'model' ranks"):
        transformer.check_ported(cfg, {"data": 1, "model": 8})
