"""Port parity for the MoE and hybrid families: ``repro_torch.models.moe``
(routing, capacity dispatch, shared experts, the ``moe_gmm`` kernel path),
``models.mamba`` (the ``ssd_scan`` kernel path, the O(1) decode) and the
transformer around them, against ``repro`` on the SMOKE configs of
deepseek-moe (a dense layer 0, then MoE with shared experts), kimi-k2 and
jamba (attention + MoE, Mamba + dense, Mamba + MoE blocks).

The reference's seeded weights go through
``models.convert.params_from_reference`` into the port's model on the CPU,
and the same numpy tokens through both packages, the reference's Pallas
kernels in interpret mode; on CPU tensors the port's ``moe_gmm`` runs its
plain version and ``ssd_scan`` its chunked form in plain PyTorch, so the
kernel path is compared with the reference's kernel path and the plain
path with its plain path.

Tolerances: float32 logits, aux losses and MoE outputs at rtol = atol =
1e-4 (both sides compute in float32 and differ in the order of their
sums).  One exception: jamba's whole-stack logits are held at 1e-3.  Fed
the same input, each of its 8 blocks agrees to 1e-4, but the stack is
ill-conditioned at these seeded weights: moving the reference's own
embedding table by one ulp moves the reference's logits about as far as
the port's gap, past 1e-4 (the Mamba mixers' RMSNorm scales rows of small
rms up with their last-bit errors).  A test holds the port's gap within
twice that move; ``PYTHONPATH=src python tests/test_torch_moe_hybrid.py``
prints both, and the gap of each block.  Teacher-forced decode (the sequential recurrence) against the
prefill (the chunked scan) is held at 5e-3 for jamba, the chunked-vs-
sequential tolerance of tests/test_kernels.py.  Greedy tokens are
identical.
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
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.runtime.elastic import carve_mesh
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import convert, moe, transformer

# the whole suite runs in 6 pytest workers on 8 cores: two intra-op threads
# a worker keep these modules from starving the reference's timing-gated tests
torch.set_num_threads(2)

MOE = ["deepseek-moe-16b", "kimi-k2-1t-a32b"]
HYBRID = ["jamba-1.5-large-398b"]
TOL = 1e-4
#: whole-stack logits of jamba's 8 blocks (see the module docstring)
STACK_TOL = {"jamba-1.5-large-398b": 1e-3}
#: decode (the sequential recurrence) against the chunked-scan prefill
CONSISTENCY_TOL = {"jamba-1.5-large-398b": 5e-3}


#: the reference's sharding specs of each arch's params (greedy_generate's)
SPECS: dict = {}


@functools.cache
def carried(arch: str, seed: int = 1):
    """(reference cfg, reference params, port cfg, port model) on one set
    of reference weights.  The reference's init runs jitted (op by op it
    takes ~10 s an arch); its specs are recorded while it is traced."""
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
    return jax.jit(lambda params, toks: jt.forward(
        params, jcfg, tokens=toks, use_kernel=use_kernel))


def jforward(params, jcfg, toks, use_kernel: bool):
    """The reference's ``forward`` (logits, aux), jitted once per config:
    op by op, every call of its scans and interpreted kernels would
    compile them anew."""
    return _jitted_forward(jcfg, use_kernel)(params, jnp.asarray(toks))


def tokens(cfg, B=2, S=20, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def moe_layer(arch: str):
    """Index of the first MoE layer and the reference's params of it."""
    jcfg, params, _, model = carried(arch)
    li = next(i for i, b in enumerate(model.layers) if b.desc["ffn"] == "moe")
    pro, _, _ = jt.layer_plan(jcfg)
    jp = (params["prologue"][li] if li < len(pro) else
          jax.tree.map(lambda a: a[0], params["group"][li - len(pro)]))
    return li, jp["ffn"]


# -- forward ----------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", MOE + HYBRID)
def test_forward_matches_reference(arch, use_kernel):
    """Logits and the summed load-balancing loss ``aux``; the kernel path
    against the reference's kernel path, the plain path against its plain
    path."""
    jcfg, params, tcfg, model = carried(arch)
    toks = tokens(tcfg)
    want, jaux = jforward(params, jcfg, toks, use_kernel)
    got, aux = transformer.forward(model, tcfg, torch.from_numpy(toks),
                                   use_kernel=use_kernel)
    assert got.shape == (2, 20, tcfg.vocab) and got.dtype == torch.float32
    close(got, want, STACK_TOL.get(arch, TOL))
    assert aux.dtype == torch.float32 and float(aux) > 0
    close(aux, jaux)


def jamba_blocks(use_kernel: bool):
    """Each jamba block (attention + MoE, then Mamba + dense and Mamba +
    MoE in turn) along the port's own hidden states: both packages apply
    it to the port's output of the block before, so that nothing
    compounds.  Yields (block, port out, reference out, port aux,
    reference aux)."""
    jcfg, params, tcfg, model = carried("jamba-1.5-large-398b")
    _, period, _ = jt.layer_plan(jcfg)
    x = torch.from_numpy(np.array(params["embed"][jnp.asarray(tokens(tcfg))]))
    for li, desc in enumerate(period):
        p = jax.tree.map(lambda a: a[0], params["group"][li])
        want, jaux = jt._block_apply(p, jcfg, desc, jnp.asarray(x.numpy()),
                                     None, use_kernel)
        x, aux = transformer._block_apply(model.layers[li], tcfg, x,
                                          use_kernel)
        yield li, x, want, aux, jaux


def jamba_spread(arch: str, use_kernel: bool, seeds=(0, 1)):
    """(the port's max logit gap from the reference, the largest move of
    the reference's own logits when its embedding table moves by one ulp,
    each entry up or down as ``seeds`` draw it)."""
    jcfg, params, tcfg, model = carried(arch)
    toks = tokens(tcfg)
    want = np.asarray(jforward(params, jcfg, toks, use_kernel)[0])
    got, _ = transformer.forward(model, tcfg, torch.from_numpy(toks),
                                 use_kernel=use_kernel)
    emb, reach = np.asarray(params["embed"]), 0.0
    for seed in seeds:
        up = np.random.default_rng(seed).random(emb.shape) < 0.5
        nudged = np.nextafter(emb, np.where(up, np.inf, -np.inf)
                              .astype(np.float32))
        moved = jforward({**params, "embed": jnp.asarray(nudged)}, jcfg,
                         toks, use_kernel)[0]
        reach = max(reach, float(np.abs(np.asarray(moved) - want).max()))
    return float(np.abs(got.numpy() - want).max()), reach


@pytest.mark.parametrize("use_kernel", [False, True])
def test_hybrid_blocks_match_reference(use_kernel):
    """Every jamba block, fed the same input on both sides (``jamba_blocks``):
    each block's output and aux at 1e-4."""
    jcfg = carried("jamba-1.5-large-398b")[0]
    pro, period, _ = jt.layer_plan(jcfg)
    assert not pro and {d["mixer"] for d in period} == {"attn", "mamba"}
    assert {d["ffn"] for d in period} == {"moe", "dense"}
    for _, x, want, aux, jaux in jamba_blocks(use_kernel):
        close(x, want)
        close(aux, jaux)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_jamba_stack_gap_is_the_references_own_spread(use_kernel):
    """Why jamba's whole-stack logits are held at 1e-3: the reference's own
    logits move further than 1e-4 when its embedding table moves by one
    ulp, and the port's gap from the reference is at most twice the larger
    such move over two seeds (``jamba_spread``)."""
    gap, reach = jamba_spread("jamba-1.5-large-398b", use_kernel)
    assert reach > TOL and gap <= 2 * reach, (gap, reach)


# -- decode -------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE + HYBRID)
def test_decode_step_matches_reference(arch):
    """Teacher-forced decode on both packages, step by step (the
    reference's step jitted, as its server runs it); each layer keeps the
    cache of its kind."""
    jcfg, params, tcfg, model = carried(arch)
    toks = tokens(tcfg, B=1, S=12)
    jstep = jax.jit(jt.decode_step, static_argnums=1)
    jcache = jt.init_cache(params, jcfg, 1, 16)
    tcache = transformer.init_cache(model, tcfg, 1, 16)
    for i in range(12):
        want, jcache = jstep(params, jcfg, jnp.asarray(toks[:, i:i + 1]),
                             jcache)
        got, tcache = transformer.decode_step(
            model, tcfg, torch.from_numpy(toks[:, i:i + 1]), tcache)
        assert got.shape == (1, 1, tcfg.vocab)
        close(got, want)
    for blk, c in zip(model.layers, tcache["layers"]):
        if blk.desc["mixer"] == "mamba":
            assert set(c) == {"conv", "ssm"}
            assert c["ssm"].dtype == torch.float32
            assert c["conv"].shape[1] == tcfg.ssm_conv - 1
        else:
            assert int(c["len"][0]) == 12


@pytest.mark.parametrize("arch", MOE + HYBRID)
def test_prefill_decode_consistency(arch):
    """The reference's tests/test_models.py check on the port: teacher-forced
    ``decode_step`` reproduces ``forward(use_kernel=True)``'s logits.  The
    SMOKE configs' capacity factor of 8.0 keeps every pair at 24 tokens,
    so the prefill drops nothing and routes as decode does."""
    _, _, tcfg, model = carried(arch)
    toks = torch.from_numpy(tokens(tcfg, B=1, S=24, seed=5))
    assert moe._capacity(tcfg, 24) >= 24
    full, _ = transformer.forward(model, tcfg, toks, use_kernel=True)
    cache = transformer.init_cache(model, tcfg, 1, 28)
    outs = []
    for i in range(24):
        lt, cache = transformer.decode_step(model, tcfg, toks[:, i:i + 1],
                                            cache)
        outs.append(lt)
    close(torch.cat(outs, dim=1), full.numpy(), CONSISTENCY_TOL.get(arch, TOL))


@pytest.mark.parametrize("arch", MOE + HYBRID)
def test_greedy_generate_matches_reference(arch):
    """``launch.serve.greedy_generate`` needs nothing new for these
    families: the same tokens as the reference's, 2 streams x (4 + 6)."""
    jcfg, params, tcfg, model = carried(arch)
    prompt = tokens(tcfg, B=2, S=4, seed=11)
    mesh = carve_mesh(jax.devices(), model_parallel=1)
    want = np.asarray(jserve.greedy_generate(params, jcfg, mesh, SPECS[arch],
                                             jnp.asarray(prompt), max_new=6))
    got = serve.greedy_generate(model, tcfg, prompt, 6)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)


# -- building --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE + HYBRID)
def test_moe_and_hybrid_families_build(arch):
    """Built and run where they used to raise; the full configs pass
    ``check_ported`` too (built only at SMOKE size here)."""
    transformer.check_ported(get_config(arch))
    cfg = get_config(arch, smoke=True)
    model = transformer.init(cfg, device="cpu")
    kinds = {(b.desc["mixer"], b.desc["ffn"]) for b in model.layers}
    assert ("attn", "moe") in kinds
    logits, aux = transformer.forward(
        model, cfg, torch.zeros((1, 4), dtype=torch.int32))
    assert torch.isfinite(logits).all() and float(aux) > 0


def test_expert_parallelism_raises(tmp_path):
    """``moe_ep=True`` shards the experts over a mesh's "model" axis (the
    reference's ``apply_ep``): without a mesh the model refuses to build,
    naming expert parallelism; on a (1, 1) mesh (a world of one gloo
    process) it builds, holds all 8 experts, and its forward equals the
    one-process model's of the same seed (every collective runs over one
    rank).  A config without a MoE layer has nothing to shard."""
    import torch.distributed as dist

    from repro_torch.runtime.elastic import carve_mesh

    cfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                              moe_ep=True)
    with pytest.raises(ValueError, match="expert parallelism"):
        transformer.init(cfg, device="cpu")
    with pytest.raises(ValueError, match="expert parallelism"):
        transformer.check_ported(cfg)
    dense = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                                moe_ep=True)
    transformer.check_ported(dense)          # no MoE layer: nothing to shard
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = carve_mesh(model_parallel=1, device_type="cpu")
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == \
            {"data": 1, "model": 1}
        transformer.check_ported(cfg, mesh)
        model = transformer.init(cfg, device="cpu", mesh=mesh)
        assert model.layers[1].ffn.wi.shape[0] == cfg.moe_experts
        toks = torch.arange(12, dtype=torch.int32).reshape(2, 6) % cfg.vocab
        got, aux = transformer.forward(model, cfg, toks)
        plain = dataclasses.replace(cfg, moe_ep=False)
        one = transformer.init(plain, device="cpu")
        want, want_aux = transformer.forward(one, plain, toks)
        assert torch.equal(got, want) and torch.equal(aux, want_aux)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", MOE + HYBRID)
def test_weight_carry_of_moe_and_mamba_leaves(arch):
    """Every port parameter equals its reference leaf, under the
    reference's key: deepseek's and kimi's real prologue (layer 0, a dense
    FFN) and their stacked MoE group (``router``, ``wi``, ``wo``,
    ``shared.*``), jamba's Mamba leaves.  The router, ``dt_bias`` and
    ``a_log`` stay float32 in a bfloat16 model."""
    jcfg, params, tcfg, model = carried(arch)
    pro, period, _ = jt.layer_plan(jcfg)
    tree = jax.tree.map(np.asarray, params)
    for li, blk in enumerate(model.layers):
        leaf = convert._layer_tree(tree, len(pro), len(period), li)
        flat = {".".join(str(getattr(k, "key", k)) for k in path): v
                for path, v in jax.tree_util.tree_flatten_with_path(leaf)[0]}
        got = dict(blk.named_parameters())
        assert set(got) == set(flat), li
        for name, p in got.items():
            np.testing.assert_array_equal(p.numpy(), flat[name])
    if pro:
        assert model.layers[0].desc["ffn"] == "dense"
        assert hasattr(model.layers[1].ffn, "router")
    bf16 = transformer.init(dataclasses.replace(tcfg, dtype=torch.bfloat16),
                            device="cpu")
    for name, p in bf16.named_parameters():
        keep32 = name.rsplit(".", 1)[-1] in ("router", "dt_bias", "a_log")
        assert p.dtype == (torch.float32 if keep32 else torch.bfloat16), name


# -- capacity and dispatch --------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", MOE + HYBRID)
def test_capacity_drops_match_reference(arch, use_kernel):
    """At capacity factor 0.5 pairs drop.  Which ones is decided by each
    pair's rank in its expert, so by the sort's stability (jnp.argsort is
    stable; torch.argsort only with ``stable=True``): the MoE layer on 40
    tokens and the whole forward against the reference's."""
    jcfg, params, tcfg, model = carried(arch)
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.5)
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=0.5)
    li, jp = moe_layer(arch)
    x = np.random.default_rng(9).normal(size=(2, 20, tcfg.d_model)
                                        ).astype(np.float32)
    xt = torch.from_numpy(x)
    _, _, topk = moe.route(model.layers[li].ffn, tcfg, xt.reshape(40, -1))
    counts = torch.bincount(topk.reshape(-1), minlength=tcfg.moe_experts)
    C = moe._capacity(tcfg, 40)
    assert C == jmoe._capacity(jcfg, 40)
    assert int((counts - C).clamp(min=0).sum()) > 0      # pairs do drop
    want, jaux = jmoe.apply(jp, jcfg, jnp.asarray(x), use_kernel=use_kernel)
    got, aux = moe.apply(model.layers[li].ffn, tcfg, xt, use_kernel=use_kernel)
    close(got, want)
    close(aux, jaux)
    toks = tokens(tcfg)
    want, _ = jforward(params, jcfg, toks, use_kernel)
    got, _ = transformer.forward(model, tcfg, torch.from_numpy(toks),
                                 use_kernel=use_kernel)
    close(got, want, STACK_TOL.get(arch, TOL))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_dispatch_keeps_token_order_within_an_expert(use_kernel):
    """Every token routed to experts 0 and 1 with capacity for a quarter of
    them: the first C tokens, in token order, keep their slots and the
    rest drop in both experts, as the reference's stable sort decides.
    With an unstable sort the kept set would be an arbitrary C."""
    jcfg = dataclasses.replace(jget("deepseek-moe-16b", smoke=True),
                               moe_shared_experts=0, moe_capacity_factor=1.0)
    tcfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                               moe_shared_experts=0, moe_capacity_factor=1.0)
    p = moe.MoE(tcfg, gen=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        p.router.zero_()
        p.router[:, 0], p.router[:, 1] = 0.5, 0.25
    T = 64
    x = 1.0 + 0.01 * torch.randn((1, T, tcfg.d_model),
                                 generator=torch.Generator().manual_seed(1))
    C = moe._capacity(tcfg, T)
    assert C < T
    y, _ = moe.apply(p, tcfg, x, use_kernel=use_kernel)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.named_parameters()}
    jy, _ = jmoe.apply(jp, jcfg, jnp.asarray(x.numpy()), use_kernel=use_kernel)
    close(y, jy)
    assert bool((y[0, C:] == 0).all()) and bool((y[0, :C] != 0).all(-1).any())


def test_routing_log_records_top_k_sets_and_drops():
    """``moe.apply.routing``, when it is a list, gets each call's sorted
    top-k sets and the pairs past capacity (what chip_smoke.py prints),
    and nothing is recorded when it is None."""
    tcfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                               moe_capacity_factor=0.5)
    p = moe.MoE(tcfg, gen=torch.Generator().manual_seed(4), device="cpu")
    x = torch.randn((2, 20, tcfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    _, _, topk = moe.route(p, tcfg, x.reshape(40, -1))
    counts = torch.bincount(topk.reshape(-1), minlength=tcfg.moe_experts)
    drops = int((counts - moe._capacity(tcfg, 40)).clamp(min=0).sum())
    assert drops > 0 and moe.apply.routing is None
    moe.apply.routing = []
    try:
        want = moe.apply(p, tcfg, x)
        log = moe.apply.routing
    finally:
        moe.apply.routing = None
    assert len(log) == 1
    assert torch.equal(log[0][0], topk.sort(-1).values) and log[0][1] == drops
    got = moe.apply(p, tcfg, x)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)


def test_dropped_pairs_stay_out_of_the_expert_buffer():
    """A dropped pair goes to a spare row past the E x C slots (where the
    reference's ``.at[slot].set(mode="drop")`` drops it), never into a
    live slot: with all but a few pairs dropped the kernel and plain
    paths agree and match a direct per-token product."""
    tcfg = dataclasses.replace(get_config("kimi-k2-1t-a32b", smoke=True),
                               moe_shared_experts=0, moe_capacity_factor=0.01)
    p = moe.MoE(tcfg, gen=torch.Generator().manual_seed(2), device="cpu")
    x = torch.randn((1, 200, tcfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    assert moe._capacity(tcfg, 200) == 8        # 800 pairs, 128 slots
    y_k, _ = moe.apply(p, tcfg, x, use_kernel=True)
    y_p, _ = moe.apply(p, tcfg, x, use_kernel=False)
    torch.testing.assert_close(y_k, y_p, rtol=TOL, atol=TOL)
    _, gate, topk = moe.route(p, tcfg, x[0])
    kept = torch.zeros(tcfg.moe_experts, dtype=torch.int64)
    want = torch.zeros_like(x[0])
    for t in range(200):
        for k in range(tcfg.moe_top_k):
            e = int(topk[t, k])
            if kept[e] < 8:
                kept[e] += 1
                h = x[0, t] @ p.wi[e]
                g, u = h.chunk(2)
                want[t] += gate[t, k] * ((torch.nn.functional.silu(g) * u)
                                         @ p.wo[e])
    torch.testing.assert_close(y_p[0], want, rtol=TOL, atol=TOL)


if __name__ == "__main__":
    # the numbers behind jamba's tolerance (see the module docstring)
    for use_kernel in (False, True):
        for li, x, want, _, _ in jamba_blocks(use_kernel):
            want = np.asarray(want)
            print(f"use_kernel={use_kernel} block {li}: max |port - ref| "
                  f"{np.abs(x.numpy() - want).max():.3e} of values up to "
                  f"{np.abs(want).max():.3g}")
        for arch in ("jamba-1.5-large-398b", "deepseek-moe-16b"):
            gap, reach = jamba_spread(arch, use_kernel)
            print(f"use_kernel={use_kernel} {arch}: logits, port gap "
                  f"{gap:.3e}; reference moved by one ulp of its embeddings "
                  f"{reach:.3e}")
