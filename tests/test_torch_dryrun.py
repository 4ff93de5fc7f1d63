"""The port's dry-run (``repro_torch.launch.dryrun``) and
``configs.input_specs`` against the reference's pure functions.

- ``input_specs``: the reference's keys, shapes and dtypes for every arch
  and shape; the 80 cells and their 14 skips;
- one rank of every FULL config on the reference's (16, 16) and (2, 16,
  16) meshes, built on the meta device over a fake process group: its
  parameter bytes equal the reference's per-device bytes (``jax.eval_shape``
  of ``repro.models.transformer.init`` and its specs, each leaf over the
  sizes of the axes its spec names);
- ``model_flops_*`` and ``min_hbm_bytes_*`` of the 66 cells that run
  against the reference's ``perfmodel``, the decode cache's bytes from
  ``jax.eval_shape`` of the reference's ``init_cache`` (its dry-run's
  ``_cache_bytes``);
- each decode cell's cache a rank against the reference's
  ``cache_specs``: the keys and values of the kv heads the rank keeps
  (``attention.kv_heads``) over its rows, or at a replicated batch its
  block of positions, M · kept / KVH times the spec's where the spec
  splits the leaf over both axes (ROADMAP queue 3, the decode caches);
  the mLSTM's C the spec's at a split batch, D times it where the batch
  is replicated;
- ``Measure``'s one pass against ``MemTracker`` and ``FlopCounterMode``
  on the same step; the CLI (the counterpart of the reference's
  ``test_dryrun_smoke_cell``), the DeepSeek cell's collectives;
- the spec flags ``tp1`` / ``dp_all``: TinyLlama's cell on both meshes
  through the CLI; every FULL config's parameter bytes a rank on both
  meshes against the reference's per-device bytes of its specs stripped
  by its own rule (copied: ``strip_model_axis``); each decode cell's
  cache a rank, every kv head whole (ROADMAP queue 3); ``dp_all``'s
  refusal of prefill_32k's batch, held to ``jit``'s own refusal in a
  subprocess on 8 forced host devices.
The reference's dry-run module is not imported: it forces 512 host
devices in the environment of every process that imports it.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import input_specs as jinput_specs
from repro.core import perfmodel as jperf
from repro.launch import serve as jserve
from repro.models import transformer as jtr
from repro_torch.configs import (ARCHS, SHAPES, get_config, input_specs,
                                 skip_reason)
from repro_torch.core import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention, transformer, xlstm
from repro_torch.models.layers import padded_layout

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
          jnp.float32: torch.float32}
CELLS = [(a, s) for a in ARCHS for s in SHAPES]
RUN = [(a, s) for a, s in CELLS if not skip_reason(get_config(a), SHAPES[s])]
DECODE = [(a, s, m) for a, s in RUN if SHAPES[s].kind == "decode"
          for m in MESHES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    got = input_specs(get_config(arch), SHAPES[shape])
    want = jinput_specs(jget(arch), JSHAPES[shape])
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].is_meta
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].dtype == DTYPES[jnp.dtype(w.dtype).type], k


def test_cells_and_skips_are_the_references():
    """10 archs x 4 shapes x 2 meshes: 80 cells, 14 skipped
    (long_500k on the 7 full-attention archs)."""
    assert [s.__dict__ for s in SHAPES.values()] == \
        [s.__dict__ for s in JSHAPES.values()]
    skips = [skip_reason(get_config(a), SHAPES[s]) for a, s in CELLS]
    assert skips == [dryrun.skip_reason(get_config(a), SHAPES[s])
                     for a, s in CELLS]
    from repro.configs import skip_reason as jskip
    assert skips == [jskip(jget(a), JSHAPES[s]) for a, s in CELLS]
    assert 2 * len(CELLS) == 80 and 2 * (len(CELLS) - len(RUN)) == 14
    assert set(skips) == {None, "SKIP(full-attention)"}


@functools.lru_cache(maxsize=None)
def reference_params(arch: str):
    """(shapes, specs) of the reference's ``init`` of the FULL config."""
    box = {}

    def init(k):
        p, box["specs"] = jtr.init(k, jget(arch))
        return p
    return jax.eval_shape(init, jax.random.PRNGKey(0)), box["specs"]


def strip_model_axis(sp):
    """The reference's ``tp1`` rule for one spec, copied from
    ``repro/launch/dryrun.py:60-66`` (``_strip_model_axis``; importing that
    module forces 512 host devices): an entry equal to "model" becomes
    None, a tuple entry stays."""
    return type(sp)(*[None if p == "model" else p for p in tuple(sp)])


def reference_bytes(arch: str, dims: dict, tp1: bool = False) -> int:
    shapes, specs = reference_params(arch)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    total = 0
    for a, sp in zip(jax.tree.leaves(shapes),
                     jax.tree.leaves(specs, is_leaf=is_spec)):
        n = a.size * a.dtype.itemsize
        for e in strip_model_axis(sp) if tp1 else sp:
            n //= 1 if e is None else sharding.axis_size(dims, e)
        total += n
    return total


def _cache_layout(cache: dict) -> list[dict]:
    return [{k: (tuple(v.shape), v.numel() * v.element_size())
             for k, v in lc.items()} for lc in cache["layers"]]


@pytest.fixture(scope="module")
def ranks():
    """Rank 0 of every FULL config on both meshes (meta, fake group):
    {mesh: {"params": {arch: bytes}, "cache": {(arch, shape): layout}}}."""
    out = {}
    for name, dims in MESHES.items():
        multi = "pod" in dims
        got = out[name] = {"params": {}, "cache": {}}
        with dryrun.fake_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            for arch in ARCHS:
                cfg = get_config(arch)
                for shape in ("decode_32k", "long_500k"):
                    if skip_reason(cfg, SHAPES[shape]):
                        continue
                    t = dryrun.trace_cell(cfg, SHAPES[shape], mesh)
                    got["params"][arch] = sum(
                        p.numel() * p.element_size()
                        for p in t.model.parameters())
                    got["cache"][arch, shape] = _cache_layout(
                        t.held["cache"])
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_bytes_a_rank_equal_the_references(ranks, arch, mesh):
    assert ranks[mesh]["params"][arch] == reference_bytes(arch, MESHES[mesh])


@functools.lru_cache(maxsize=None)
def reference_cache(arch: str, shape: str):
    """The reference's whole decode cache (shapes) of the cell."""
    cfg, sh = jget(arch), JSHAPES[shape]
    fr = None
    if cfg.family == "vlm":
        fr = jax.ShapeDtypeStruct((sh.batch, cfg.n_frontend_tokens,
                                   cfg.d_model), cfg.dtype)
    return jax.eval_shape(
        lambda p, f: jtr.init_cache(p, cfg, sh.batch, sh.seq, frontend=f),
        reference_params(arch)[0], fr)


@pytest.mark.parametrize("arch,shape", RUN)
def test_model_terms_equal_the_references(arch, shape):
    """``model_flops_*`` and ``min_hbm_bytes_*`` as the reference's
    dry-run computes them (``analyse``)."""
    cfg, sh = jget(arch), JSHAPES[shape]
    tokens = sh.batch * sh.seq
    if sh.kind == "train":
        want = (jperf.model_flops_train(cfg.active_params(), tokens),
                jperf.min_hbm_bytes_train(cfg, tokens))
    elif sh.kind == "prefill":
        want = (jperf.model_flops_decode(cfg.active_params(), tokens),
                jperf.min_hbm_bytes_prefill(cfg, tokens))
    else:
        cache = float(sum(np.prod(a.shape) * a.dtype.itemsize
                          for a in jax.tree.leaves(reference_cache(arch,
                                                                   shape))))
        want = (jperf.model_flops_decode(cfg.active_params(), sh.batch),
                jperf.min_hbm_bytes_decode(cfg, sh.batch, cache))
    assert dryrun.model_terms(get_config(arch), SHAPES[shape]) == want


def _spec_bytes(leaf, spec, dims) -> int:
    n = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
    for e in spec:
        n //= 1 if e is None else sharding.axis_size(dims, e)
    return n


def _split(spec, dims) -> int:
    return int(np.prod([sharding.axis_size(dims, e) for e in spec
                        if e is not None]))


@pytest.mark.parametrize("arch,shape,mesh", DECODE)
def test_cache_bytes_a_rank_against_the_reference_specs(ranks, arch, shape,
                                                         mesh):
    """Each self-attention layer holds the keys and values of its kept kv
    heads over its rows (a batch that splits over the D data ranks) or
    its block of positions (a replicated batch): kept / (KVH · D) of the
    whole leaf, which is ``split`` · kept / (KVH · D) times the spec's
    bytes, ``split`` the ranks the spec divides the leaf over (M · kept /
    KVH where it divides it over both axes); the mLSTM's C the spec's
    where the batch splits, D times it where it is replicated."""
    from jax.sharding import AbstractMesh

    dims = MESHES[mesh]
    cfg, sh = get_config(arch), SHAPES[shape]
    D = dims["data"] * dims.get("pod", 1)
    M = dims["model"]
    whole = reference_cache(arch, shape)
    specs = jserve.cache_specs(whole, AbstractMesh(tuple(dims.values()),
                                                   tuple(dims)))
    got = ranks[mesh]["cache"][arch, shape]
    assert len(got) == cfg.n_layers
    kv = attention.kv_heads(cfg, M, 0)
    kept = kv.stop - kv.start if isinstance(kv, slice) else len(kv)
    split_batch = sh.batch % D == 0
    seen = set()
    for li, lc in enumerate(got):
        for key in ("k", "v", "C"):
            if key not in lc:
                continue
            leaf, spec = _layer_leaf(whole, specs, cfg, li, key)
            port, spec_b = lc[key][1], _spec_bytes(leaf, spec, dims)
            if key == "C":
                assert port == spec_b * (1 if split_batch else D), (li, key)
            else:
                whole_b = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                assert port * cfg.n_kv_heads * D == whole_b * kept, (li, key)
                assert port * cfg.n_kv_heads * D == \
                    spec_b * _split(spec, dims) * kept, (li, key)
            seen.add(key)
    assert seen, got


def _layer_leaf(whole, specs, cfg, li: int, key: str):
    """Layer ``li``'s leaf ``key`` of the reference's cache (which stacks
    the repeating group) and its spec, without the repeat axis."""
    from repro.models.transformer import layer_plan

    pro, period, repeats = layer_plan(jget(cfg.name))
    if li < len(pro):
        return whole["prologue"][li][key], specs["prologue"][li][key]
    j = (li - len(pro)) % len(period)
    leaf, spec = whole["group"][j][key], specs["group"][j][key]
    return (jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype),
            type(spec)(*tuple(spec)[1:]))


# (arch, shape, layers, positions or None for the shape's own): the
# attention and MoE paths at their shapes, and the recurrent loops over
# positions (the Jamba cut's Mamba layer, xLSTM's mLSTM and sLSTM), where
# Measure's shape memo serves every step after the first
ONE_PASS = [("tinyllama-1.1b", "train_4k", 2, None),
            ("deepseek-moe-16b", "prefill_32k", 2, None),
            ("jamba-1.5-large-398b", "train_4k", 2, 64),
            ("jamba-1.5-large-398b", "prefill_32k", 2, 64),
            ("xlstm-125m", "train_4k", 4, 64),
            ("xlstm-125m", "prefill_32k", 4, 64)]


@pytest.mark.parametrize("arch,shape,layers,seq", ONE_PASS)
def test_one_pass_equals_memtracker_and_flop_counter(arch, shape, layers,
                                                      seq, monkeypatch):
    """``Measure``'s peak and its split, and its FLOPs, equal
    ``MemTracker``'s and ``FlopCounterMode``'s over the same step on the
    (16, 16) mesh, full width at a few layers (and, on the recurrent
    paths, a few positions); every count, its bytes too, equals that of a
    pass with the shape memo off."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        sh = SHAPES[shape] if seq is None else \
            dataclasses.replace(SHAPES[shape], seq=seq)
        t = dryrun.trace_cell(cfg, sh, mesh)
        costs = dryrun._cell_costs(t)
        mem, flops = costs["memory"], costs["flops"]
        mt = MemTracker()
        mt.track_external(t.model, *dryrun._tensors(t.held))
        with mt:
            t.step()
        peak = {getattr(k, "value", k): v for k, v in
                mt.get_tracker_snapshot("peak")[torch.device("meta")].items()}
        assert mem["total_per_device"] == peak["Total"], (arch, mem, peak)
        assert mem["activations"] == peak["Activation"]
        assert mem["temporaries"] == peak["Temp"]
        with FlopCounterMode(display=False) as fc:
            t.step()
        assert flops == fc.get_total_flops() > 0
        monkeypatch.setattr(dryrun, "_pure", lambda func: False)
        assert dryrun._cell_costs(t) == costs


def test_cli_traces_the_tinyllama_cell(tmp_path):
    """The counterpart of the reference's ``test_dryrun_smoke_cell``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "train_4k", "--mesh", "single",
         "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "[dryrun] tinyllama-1.1b × train_4k × 16x16: OK" in out.stdout
    assert out.stdout.strip().endswith("[dryrun] all requested cells "
                                       "traced OK")
    rec = json.loads((tmp_path / "tinyllama-1.1b_train_4k_16x16.json")
                     .read_text())
    # the reference's keys; its compile_seconds is the port's trace_seconds
    assert set(rec) == {"arch", "shape", "mesh", "chips", "cost_per_device",
                        "memory_per_device", "hbm_ok", "collectives",
                        "roofline", "status", "trace_seconds", "card"}
    assert rec["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert rec["status"] == "OK" and rec["chips"] == 256
    mem = rec["memory_per_device"]
    assert mem["parameters"] == reference_bytes("tinyllama_1_1b",
                                                MESHES["16x16"])
    assert mem["gradients"] == mem["parameters"]
    # master, mu, nu in float32 and the int32 step
    assert mem["optimizer_state"] == 6 * mem["parameters"] + 4
    assert rec["hbm_ok"] == (mem["total_per_device"] <= 80 * 10**9)
    assert set(rec["roofline"]) == {
        "t_compute_s", "t_memory_s", "t_collective_s", "bound", "hlo_flops",
        "hlo_bytes", "collective_bytes", "model_flops", "model_bytes",
        "useful_flop_frac", "useful_byte_frac", "roofline_frac"}


def test_deepseek_cell_counts_its_collectives_by_kind(tmp_path):
    """DeepSeek-MoE FULL at prefill_32k on (2, 16, 16): the experts split
    over "model" (4 a rank of 64), the MoE layers' all-reduces and the
    logits' all-gather, operand and ring wire bytes by the reference's
    rule."""
    rec = dryrun.run_cell("deepseek-moe-16b", "prefill_32k", True,
                          out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "OK" and rec["chips"] == 512
    assert rec["memory_per_device"]["parameters"] == reference_bytes(
        "deepseek_moe_16b", MESHES["2x16x16"])
    c = rec["collectives"]
    kinds = c["by_kind"]
    assert set(kinds) == {"all-reduce", "all-gather"}
    assert kinds["all-gather"]["count"] == 1          # the logits
    assert c["count"] == sum(k["count"] for k in kinds.values())
    assert c["operand_bytes"] == sum(k["bytes"] for k in kinds.values())
    # each of the 27 MoE layers sums its count table (32 data ranks x 64
    # experts, int64) and its aux (a float32) over "pod" (2 ranks), then
    # over "data" (16); every other collective runs over "model" (16)
    small = 27 * (32 * 64 * 8 + 4)
    model = kinds["all-reduce"]["bytes"] - 2 * small
    assert c["wire_bytes"] == pytest.approx(
        model * 2 * 15 / 16 + small * 2 * 1 / 2 + small * 2 * 15 / 16
        + kinds["all-gather"]["bytes"] * 15 / 16, rel=1e-12)
    # the logits (1, 32768, 102400 / 16) in bf16, gathered
    assert kinds["all-gather"]["bytes"] == 32768 * 102400 // 16 * 2
    assert rec["cost_per_device"]["flops"] > 0
    assert rec["roofline"]["collective_bytes"] == c["operand_bytes"] * 512


@pytest.fixture(scope="module")
def tp1_ranks():
    """Rank 0 of every FULL config under ``tp1`` on both meshes (meta,
    fake group): {mesh: {"params": {arch: bytes}, "cache": {(arch,
    shape): layout}}}, the decode cells traced on (16, 16)."""
    out = {}
    for name, dims in MESHES.items():
        multi = "pod" in dims
        got = out[name] = {"params": {}, "cache": {}}
        with dryrun.fake_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            for arch in ARCHS:
                cfg = get_config(arch)
                model = transformer.Transformer(cfg, device="meta",
                                                mesh=mesh, tp1=True)
                got["params"][arch] = sum(p.numel() * p.element_size()
                                          for p in model.parameters())
                del model
                for shape in ("decode_32k", "long_500k"):
                    if multi or skip_reason(cfg, SHAPES[shape]):
                        continue
                    t = dryrun.trace_cell(cfg, SHAPES[shape], mesh,
                                          opt_flags=("tp1",))
                    got["cache"][arch, shape] = _cache_layout(
                        t.held["cache"])
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp1_parameter_bytes_a_rank_equal_the_references(tp1_ranks, arch,
                                                         mesh):
    """Every FULL config under ``tp1``: a rank holds the reference's
    per-device bytes of its stripped specs (FSDP's "data" blocks kept,
    every "model" dimension and expert whole)."""
    dims = MESHES[mesh]
    got = tp1_ranks[mesh]["params"][arch]
    assert got == reference_bytes(arch, dims, tp1=True)
    if "model" in dims and got != reference_bytes(arch, dims):
        assert got > reference_bytes(arch, dims)


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, m in DECODE
                                        if m == "16x16"])
def test_tp1_decode_cache_holds_the_whole_kv_heads(tp1_ranks, arch, shape):
    """ROADMAP queue 3's finding: under ``tp1`` the reference's
    ``cache_specs`` still split each KV leaf over "model", while a port
    rank, which holds the whole attention, keeps every kv head over its
    rows (or its block of positions): 1 / D of the whole leaf, ``split`` /
    D times the spec's bytes (M where the spec splits the leaf over both
    axes)."""
    from jax.sharding import AbstractMesh

    dims = MESHES["16x16"]
    cfg, sh = get_config(arch), SHAPES[shape]
    D = dims["data"]
    whole = reference_cache(arch, shape)
    specs = jserve.cache_specs(whole, AbstractMesh(tuple(dims.values()),
                                                   tuple(dims)))
    got = tp1_ranks["16x16"]["cache"][arch, shape]
    seen = 0
    for li, lc in enumerate(got):
        if "k" not in lc:
            continue
        for key in ("k", "v"):
            leaf, spec = _layer_leaf(whole, specs, cfg, li, key)
            whole_b = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
            spec_b = _spec_bytes(leaf, spec, dims)
            assert lc[key][1] * D == whole_b, (li, key)
            assert lc[key][1] * D == spec_b * _split(spec, dims), (li, key)
            seen += 1
    assert seen or cfg.family == "ssm", got


def test_spec_flags_trace_tinyllama_on_both_meshes(tmp_path, monkeypatch,
                                                   capsys):
    """``--opt tp1`` and ``--opt dp_all`` (TinyLlama train_4k, where
    ``dp_all`` is ``tp1``): the reference's record names, parameters a
    rank the stripped specs', gradients the same, optimizer state six
    times them and the step; no "model" collective left but the FSDP-free
    step's data-parallel all-reduces."""
    for flag in dryrun.SPEC_FLAGS:
        monkeypatch.setattr(sys, "argv", [
            "dryrun", "--arch", "tinyllama-1.1b", "--shape", "train_4k",
            "--mesh", "both", "--opt", flag, "--out", str(tmp_path)])
        dryrun.main()
        assert capsys.readouterr().out.rstrip().endswith(
            "[dryrun] all requested cells traced OK")
        for mesh, dims in MESHES.items():
            rec = json.loads((tmp_path / f"opt-{flag}_tinyllama-1.1b_"
                                         f"train_4k_{mesh}.json").read_text())
            mem = rec["memory_per_device"]
            assert rec["status"] == "OK"
            assert mem["parameters"] == reference_bytes("tinyllama_1_1b",
                                                        dims, tp1=True)
            assert mem["gradients"] == mem["parameters"]
            assert mem["optimizer_state"] == 6 * mem["parameters"] + 4
            assert set(rec["collectives"]["by_kind"]) == {"all-reduce"}


REF_DP_ALL = r"""
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 4), ("data", "model"))
sh = NamedSharding(mesh, P(("data", "model"), None))
f = jax.jit(lambda x: x * 2, in_shardings=(sh,))
for b in (4, 8):
    try:
        f.lower(jax.ShapeDtypeStruct((b, 16), jnp.int32)).compile()
        print(b, "OK")
    except ValueError as e:
        print(b, "REFUSED", str(e).replace("\n", " "))
"""


def test_dp_all_refuses_prefill_32k_where_jax_does(monkeypatch, capsys):
    """The reference's ``dp_all`` prefill puts its batch on
    ``P((*data_axes, "model"), ...)``: ``jit`` refuses a batch that the
    product of those axes does not divide (8 forced host devices in a
    subprocess: a batch of 4 over (2, 4) refused, 8 accepted).  The port
    refuses the same batch at the same rule (``train.rows``), naming the
    batch and the rank count: prefill_32k's 32 over 256 and 512 ranks."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_DP_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert lines["8"] == "OK"
    assert lines["4"].startswith("REFUSED") and \
        "divisible by 8, but it is equal to 4" in lines["4"]
    with dryrun.fake_world(8):
        from torch.distributed.device_mesh import DeviceMesh
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                          mesh_dim_names=("data", "model"))
        axes = dryrun.prefill_axes(mesh, ("dp_all",))
        assert axes == ("data", "model")
        assert dryrun.train.rows(8, mesh, axes) == slice(0, 1)
        with pytest.raises(ValueError, match=r"batch 4 does not split over 8 "
                                             r"ranks of \('data', 'model'\)"):
            dryrun.train.rows(4, mesh, axes)
    for mp, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"batch 32 does not split over "
                                             f"{n} ranks"):
            dryrun.run_cell("tinyllama-1.1b", "prefill_32k", mp,
                            opt_flags=("dp_all",), verbose=False)
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "deepseek-moe-16b", "--shape", "prefill_32k",
        "--mesh", "single", "--opt", "dp_all"])
    with pytest.raises(SystemExit, match="1 dry-run failures"):
        dryrun.main()
    assert "batch 32 does not split over 256 ranks" in capsys.readouterr().out


def test_opt_flags_replace_the_config_fields():
    cfg = dryrun.apply_opt_flags(
        get_config("deepseek-moe-16b"),
        ("remat_dots", "nofsdp", "fast_decode", "moe_shard", "chunked_mlstm",
         "cap1", "moe_ep", "microbatch", "chunked_loss"))
    assert (cfg.remat_policy, cfg.fsdp, cfg.fast_decode,
            cfg.moe_dispatch_sharded, cfg.mlstm_chunk,
            cfg.moe_capacity_factor, cfg.moe_ep) == \
        ("dots", False, True, True, 256, 1.0, True)
    with pytest.raises(ValueError, match="unknown opt flag"):
        dryrun.apply_opt_flags(cfg, ("fast",))


def test_fake_world_is_torn_down():
    import torch.distributed as dist

    with dryrun.fake_world(4):
        assert dist.get_world_size() == 4 and dist.get_rank() == 0
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="256 ranks"):
        with dryrun.fake_world(4):
            make_production_mesh(device_type="cpu")
    assert not dist.is_initialized()


def test_mlstm_columns_of_xlstm_on_the_model_axis():
    """xlstm-125m's 4 heads of 192 columns over 16 model ranks: a quarter
    of a head a rank (the cache test's C)."""
    sp = xlstm.mlstm_split(get_config("xlstm-125m"), 16, 0)
    assert (sp.n, padded_layout(sp)[0]) == (1, 48)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_trace_cell_on_a_device_feeds_token_ids_in_range(shape):
    """A rank traced on a device that runs its step (the CPU here, the
    card in ``chip_smoke.py``'s legs b and b') gets token ids and labels
    of zero, not whatever its allocator held, so that the embedding's and
    the loss's gathers stay in range; on the meta device they stay
    uninitialised.  TinyLlama SMOKE under ``tp1``, the sequence cut to
    64, one rank of (16, 16)."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    sh = dataclasses.replace(SHAPES[shape], seq=64)
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        t = dryrun.trace_cell(cfg, sh, mesh, opt_flags=("tp1",),
                              device="cpu")
        ints = {k: v for k, v in t.held["inputs"].items()
                if not v.is_floating_point()}
        assert ints and all(not v.any() for v in ints.values()), ints
        t.step()
        meta = dryrun.trace_cell(cfg, sh, mesh, opt_flags=("tp1",))
        assert {v.device.type for v in meta.held["inputs"].values()} == \
            {"meta"}
