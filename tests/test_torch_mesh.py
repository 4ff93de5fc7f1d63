"""Port parity of the mesh layer: ``repro_torch.core.sharding``,
``launch.mesh``, ``runtime.elastic``'s mesh helpers, ``launch.serve``'s
cache specs and ``transformer.param_specs`` against ``repro``.

The pure functions are compared byte for byte (tuple equality of every
spec) with the reference's, on ``jax.sharding.AbstractMesh`` meshes of
the same axis sizes (the port's take a ``{axis: size}`` mapping, so no
process group is needed).  The elastic case is the reference's own
(tests/test_multibank.py:86-94) in 8 gloo processes on the CPU:
``carve_mesh(model_parallel=2)``, ``simulate_failure(n_lost=2)`` down to
6 ranks, and ``reshard`` of a (12, 2) leaf over ("data", "model")
returning its input.  The reference is imported inside the tests: the
ranks import this module and run no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.sharding import P, axis_size, data_axes
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve
from repro_torch.models import convert, transformer
from repro_torch.runtime import elastic

MESHES = [{"data": 1, "model": 1}, {"data": 2, "model": 1},
          {"data": 1, "model": 4}, {"data": 2, "model": 4},
          {"data": 16, "model": 16}, {"pod": 2, "data": 2, "model": 4},
          {"pod": 2, "data": 16, "model": 16}]


def abstract(shape: dict):
    from jax.sharding import AbstractMesh
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def as_tuple(spec):
    """A spec's entries, the reference's or the port's."""
    return tuple(spec)


def same_specs(got, want) -> None:
    """Two spec trees: the same structure and every spec equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (got, want)
        for k in want:
            same_specs(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            same_specs(a, b)
    else:
        assert isinstance(got, P), got
        assert as_tuple(got) == as_tuple(want), (got, want)


# -- pure functions ---------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
def test_data_axes_and_axis_size(shape):
    from repro.launch import mesh as jmesh
    m = abstract(shape)
    assert data_axes(shape) == jmesh.data_axes(m)
    for names in (data_axes(shape), "model", tuple(shape)):
        assert axis_size(shape, names) == jmesh.axis_size(m, names)
    assert tmesh.data_axes is data_axes and tmesh.axis_size is axis_size


@pytest.mark.parametrize("sizes", [(1, 1), (2, 1), (1, 2), (2, 4), (4, 2),
                                   (3, 5), (16, 16), (8, 1)])
def test_cache_spec_for_matches_reference(sizes):
    """Every shape of up to 4 dims over sizes {1, 2, 3, 4, 6, 8, 16, 32},
    data axes "data" and ("pod", "data"), with and without the scan axis
    skipped."""
    from repro.launch import serve as jserve
    nd, nm = sizes
    rng = np.random.default_rng(nd * 100 + nm)
    dims = [1, 2, 3, 4, 6, 8, 16, 32]
    shapes = [tuple(int(d) for d in rng.choice(dims, n))
              for n in (1, 2, 3, 4) for _ in range(40)]
    for shape in shapes:
        for dp in ("data", ("pod", "data")):
            for skip in (False, True):
                got = serve.cache_spec_for(shape, nd, nm, dp, skip)
                want = jserve.cache_spec_for(shape, nd, nm, dp, skip)
                assert isinstance(got, P)
                assert as_tuple(got) == as_tuple(want), (shape, dp, skip)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [{"data": 2, "model": 4},
                                   {"pod": 2, "data": 2, "model": 2},
                                   {"data": 4, "model": 1}],
                         ids=["d2m4", "p2d2m2", "d4m1"])
def test_cache_specs_match_reference(arch, shape):
    """The spec tree of the reference's decode cache (``eval_shape`` of
    ``init_cache``: the stacked ``group`` leaves keep their scan axis
    whole) at batch 4, 16 positions, from the port's ``cache_specs``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.launch import serve as jserve
    from repro.models import transformer as jtr
    cfg = jget(arch, smoke=True)
    params = jax.eval_shape(lambda k: jtr.init(k, cfg)[0],
                            jax.random.PRNGKey(0))
    front = (jax.ShapeDtypeStruct((4, cfg.n_frontend_tokens, cfg.d_model),
                                  jnp.float32)
             if cfg.family == "vlm" else None)
    shapes = jax.eval_shape(lambda p, f: jtr.init_cache(p, cfg, 4, 16,
                                                        frontend=f),
                            params, front)
    same_specs(serve.cache_specs(shapes, shape),
               jserve.cache_specs(shapes, abstract(shape)))


def test_cache_specs_of_the_ports_cache():
    """The port's own cache layout ({"layers": [...]}, no scan axis):
    each leaf's spec is ``cache_spec_for`` of its shape."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    model = transformer.init(cfg, device="cpu")
    cache = serve.make_cache(model, cfg, 4, 16)
    specs = serve.cache_specs(cache, {"data": 2, "model": 2})
    k = cache["layers"][0]["k"]
    assert specs["layers"][0]["k"] == serve.cache_spec_for(
        tuple(k.shape), 2, 2, "data")
    assert specs["layers"][0]["len"] == P("data")     # (batch,)


@pytest.mark.parametrize("shape", MESHES[3:], ids=["d2m4", "d16m16",
                                                   "p2d2m4", "p2d16m16"])
def test_shardings_for_drops_missing_axes(shape):
    """``fold_spec`` keeps what the reference's ``shardings_for`` keeps
    (the "pod" axis folds away on a mesh without it), and ``placements``
    shards each mesh dimension on the tensor dimension that names it."""
    from jax.sharding import PartitionSpec as JP
    from repro.runtime.elastic import shardings_for as jshardings_for
    specs = {"a": P(("pod", "data"), "model"), "b": P("model", None),
             "c": [P(None), P(("pod", "data"), None, "model")],
             "d": P(), "e": P("pod", ("data", "model"))}
    jspecs = {"a": JP(("pod", "data"), "model"), "b": JP("model", None),
              "c": [JP(None), JP(("pod", "data"), None, "model")],
              "d": JP(), "e": JP("pod", ("data", "model"))}
    want = jshardings_for(abstract(shape), jspecs)
    names = set(shape)
    for k in ("a", "b", "d", "e"):
        assert as_tuple(elastic.fold_spec(specs[k], names)) == \
            as_tuple(want[k].spec), k
    for got, w in zip(specs["c"], want["c"]):
        assert as_tuple(elastic.fold_spec(got, names)) == as_tuple(w.spec)
    pl = elastic.shardings_for(shape, specs)
    pod = ["pod"] if "pod" in shape else []
    dims = pod + ["data", "model"]
    assert pl["a"] == tuple(Shard(0) if a in ("pod", "data") else Shard(1)
                            for a in dims)
    assert pl["b"] == tuple(Shard(0) if a == "model" else Replicate()
                            for a in dims)
    assert pl["c"][1] == tuple(Shard(2) if a == "model" else Shard(0)
                               for a in dims)
    assert pl["d"] == (Replicate(),) * len(dims)
    with pytest.raises(ValueError, match="order"):
        elastic.placements(shape, P(("model", "data")))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_specs_match_reference(arch, fsdp):
    """``transformer.param_specs`` names every port parameter, and in the
    reference's layout (``convert.reference_specs``: a stacked group
    leaf's spec gains the leading None of its repeat axis) equals the
    spec tree ``repro.models.transformer.init`` returns."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import transformer as jtr
    jcfg = dataclasses.replace(jget(arch, smoke=True), fsdp=fsdp)
    cfg = dataclasses.replace(get_config(arch, smoke=True), fsdp=fsdp)
    box = {}

    def make(k):
        p, box["specs"] = jtr.init(k, jcfg)
        return p
    jax.eval_shape(make, jax.random.PRNGKey(0))
    specs = transformer.param_specs(cfg)
    names = dict(transformer.init(cfg, device="cpu").named_parameters())
    assert set(specs) == set(names)
    for k, s in specs.items():
        assert len(s) == names[k].ndim, (k, s)
    same_specs(convert.reference_specs(specs, cfg), box["specs"])


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_opt_state_specs_match_reference(arch):
    """``train.batch_specs`` (each family's batch keys over the data axes,
    "pod" folded in on a multi-pod mesh) and ``opt_state_specs`` of the
    parameter specs equal the reference's."""
    import jax
    from repro.configs import get_config as jget
    from repro.launch import train as jtrain
    from repro.models import transformer as jtr
    from repro_torch.launch import train
    jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    for shape in ({"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 2}):
        same_specs(train.batch_specs(cfg, shape),
                   jtrain.batch_specs(jcfg, abstract(shape)))
    box = {}

    def make(k):
        p, box["specs"] = jtr.init(k, jcfg)
        return p
    jax.eval_shape(make, jax.random.PRNGKey(0))
    got = train.opt_state_specs(convert.reference_specs(
        transformer.param_specs(cfg), cfg))
    same_specs(got, jtrain.opt_state_specs(box["specs"]))


def test_production_mesh_names_the_world_it_needs():
    """Outside a world of 256 (512 multi-pod) ranks the production mesh
    refuses and names that size; it never shrinks to fit."""
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs a world of 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")


# -- elastic, in 8 gloo processes -----------------------------------------------------

def _elastic_rank(rank: int):
    """The reference's elastic case on this rank."""
    m8 = elastic.carve_mesh(model_parallel=2, device_type="cpu")
    m6 = elastic.simulate_failure(m8, n_lost=2, model_parallel=2)
    out = {"m8": dict(zip(m8.mesh_dim_names, m8.shape)),
           "m6": dict(zip(m6.mesh_dim_names, m6.shape)),
           "ranks6": m6.mesh.flatten().tolist(),
           "member": m6.get_coordinate() is not None}
    if out["member"]:
        w = torch.arange(24.0).reshape(12, 2)
        got = elastic.reshard({"w": w, "r": [w[:3]]}, m6,
                              {"w": P("data", "model"), "r": [P(None)]})
        out["local"] = tuple(got["w"].to_local().shape)
        out["placements"] = tuple(got["w"].placements)
        out["whole"] = torch.equal(got["w"].full_tensor(), w)
        out["replicated"] = torch.equal(got["r"][0].to_local(), w[:3])
    return out


def test_elastic_carve_fail_reshard_on_8_ranks():
    out = tmesh.spawn(_elastic_rank, 8, timeout=120)
    assert all(o["m8"] == {"data": 4, "model": 2} for o in out)
    assert all(o["m6"] == {"data": 3, "model": 2} for o in out)
    assert all(o["ranks6"] == list(range(6)) for o in out)
    assert [o["member"] for o in out] == [True] * 6 + [False] * 2
    for o in out[:6]:
        assert o["local"] == (4, 1)
        assert o["placements"] == (Shard(0), Shard(1))
        assert o["whole"] and o["replicated"]
