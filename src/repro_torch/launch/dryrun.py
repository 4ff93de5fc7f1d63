"""Dry-run of the port — the counterpart of ``repro.launch.dryrun``: one
rank of every (arch × shape × mesh) cell, traced on the meta device.

The reference lowers and compiles each cell on 512 forced host devices
and reads XLA's memory and cost analyses.  The port has no compiler to
ask and needs no device: ``run_cell`` joins PyTorch's ``fake`` process
group (``torch.testing._internal.distributed.fake_pg``, imported here
alone) of 256 or 512 ranks as rank 0, builds the reference's production
mesh over it (``launch.mesh.make_production_mesh``), builds the model on
the meta device (shapes without memory; no weights drawn) and runs the
cell's step (``trace_cell``): the train step of ``launch.train`` on the
rank's rows, the prefill ``transformer.forward(use_kernel=False)``, as
the reference lowers it, or one ``launch.serve`` decode step over the
rank's cache.  Over the fake group a collective returns at once and
moves nothing; ``core.sharding`` sends it down the path of a mesh of
cards (NCCL's), so every tensor is the one a card of that mesh holds.

The step runs once, under ``Measure`` (one pass: the counters nested
in one another stall, and a pass apiece multiplies the time of the
recurrent cells, whose Python loops over the positions dispatch an op a
position and layer):
- memory: the peak of the bytes alive over the step, counted as
  ``MemTracker`` counts them (storages as ops make them and as they
  die), split into activations (forward) and temporaries (backward and
  optimizer) at that peak, beside the exact bytes of the parameters,
  their gradients, the optimizer state, the decode cache and the inputs;
- FLOPs: ``FlopCounterMode``'s formulas (matmuls, attention,
  convolutions);
- bytes: the input and output bytes of every aten op dispatched (an
  eager program reads and writes each in memory: the port's counterpart
  of XLA's "bytes accessed"; views and bare allocations move nothing),
  and every collective of ``core.sharding`` (its ``TAPE``): count,
  operand bytes, ring wire bytes and each kind's, as the reference's
  ``core/hlo.py`` counts them.
On the meta device ``Measure`` also memoises each pure op's output
shapes, so a recurrent loop infers its step's shapes once.

``analyse`` turns them into the reference's record: ``hbm_ok`` against
one H100's 80 GB, the three-term roofline over the card's data-sheet
peaks (``core.perfmodel``), ``model_flops_*`` and ``min_hbm_bytes_*``;
each record names that card (``CARD``).  Records go to
``experiments/dryrun_torch/`` under the reference's file names.  The
reference's ``extrapolated_costs`` has no counterpart: XLA counts a
scanned layer once, so the reference lowers two reduced depths and
extends them; the port traces every layer.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import time
import traceback
import weakref
from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import optim
from repro_torch.configs import (ARCHS, SHAPES, get_config, input_specs,
                                 skip_reason)
from repro_torch.core import sharding
from repro_torch.core.perfmodel import (GpuModel, RooflineTerms,
                                        min_hbm_bytes_decode,
                                        min_hbm_bytes_prefill,
                                        min_hbm_bytes_train,
                                        model_flops_decode, model_flops_train)
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

#: the card whose peaks and memory the records use (``GpuModel``: the
#: data sheet's H100 SXM at its 700 W limit), as ``nvidia-smi
#: --query-gpu=name,power.limit --format=csv,noheader`` names it
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"

#: the reference's opt flags that replace config fields
CONFIG_FLAGS = {"remat_dots": {"remat_policy": "dots"},
                "nofsdp": {"fsdp": False},
                "fast_decode": {"fast_decode": True},
                "moe_shard": {"moe_dispatch_sharded": True},
                "chunked_mlstm": {"mlstm_chunk": 256},
                "cap1": {"moe_capacity_factor": 1.0},
                "moe_ep": {"moe_ep": True}}
#: the flags of the train step: 4 microbatches, the CE over 16 vocab chunks
STEP_FLAGS = ("microbatch", "chunked_loss")
#: the reference's flags that rewrite its parameter specs: both strip
#: "model" from them (``transformer.param_specs(cfg, tp1=True)``), and
#: ``dp_all`` also splits the prefill batch over "model"
SPEC_FLAGS = ("tp1", "dp_all")

#: ring traffic a rank per operand byte over a group of n ranks
_WIRE = {"all-reduce": lambda n: 2.0 * (n - 1) / n,
         "all-gather": lambda n: (n - 1) / n,
         "reduce-scatter": lambda n: (n - 1) / n}

_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                torch.ops.aten.new_empty_strided}


def apply_opt_flags(cfg, opt_flags):
    """``cfg`` with the config fields of ``opt_flags`` replaced (the
    reference's levers); the step's and the specs' flags change no field
    (``trace_cell`` reads them)."""
    known = sorted(CONFIG_FLAGS) + list(STEP_FLAGS) + list(SPEC_FLAGS)
    for f in opt_flags:
        if f not in known:
            raise ValueError(f"unknown opt flag {f!r}; known: {known}")
    for f in opt_flags:
        cfg = dataclasses.replace(cfg, **CONFIG_FLAGS.get(f, {}))
    return cfg


def prefill_axes(mesh, opt_flags) -> tuple | None:
    """The axes that split the prefill batch: the data axes (None), or
    under ``dp_all`` the data axes and "model" (the reference's
    ``P((*data_axes, "model"), ...)``, ``repro/launch/dryrun.py:124-131``)."""
    if "dp_all" not in opt_flags:
        return None
    dp = sharding.data_axes(mesh)
    return ((dp,) if isinstance(dp, str) else tuple(dp)) + ("model",)


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a ``fake`` process group of
    ``world_size`` ranks, torn down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class Traced:
    """One rank's step of a cell: ``step()`` runs it once; ``model``;
    ``held``, the other tensors alive across it by kind
    ("optimizer_state", "cache", "inputs"; each as the step takes it);
    ``grads``, the bytes of each parameter's gradient, noted as the train
    step makes it."""
    step: Callable[[], object]
    model: torch.nn.Module
    held: dict
    grads: dict


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for v in tree for t in _tensors(v)] \
        if isinstance(tree, (list, tuple)) else []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _local(t: torch.Tensor, device, rows: slice | None = None):
    """A tensor of ``t``'s dtype and the shape of its ``rows``, on
    ``device``, with storage of its own: uninitialised, but for an integer
    tensor (token ids, labels) on a device that runs the step, which is
    zero, so that every index it holds is in range."""
    t = t if rows is None else t[rows]
    if torch.device(device).type != "meta" and not t.is_floating_point():
        return torch.zeros_like(t, device=device)
    return torch.empty_like(t, device=device)


def _note_grad(grads: dict, name: str, g: torch.Tensor) -> None:
    grads[name] = g.numel() * g.element_size()


def trace_cell(cfg, shape, mesh, *, opt_flags=(), device="meta") -> Traced:
    """Build one rank of ``cfg`` on ``mesh`` (uninitialised, on
    ``device``: meta for the dry-run) and its step of ``shape``: train
    (``launch.train.make_train_step`` with its optimizer state, on the
    rank's rows; ``microbatch`` 4 microbatches, ``chunked_loss`` the CE
    over 16 vocab chunks), prefill (``transformer.forward``, no kernel,
    on the rank's rows) or decode (``launch.serve.make_cache`` and
    ``make_serve_step`` of the batch, on the rank's streams or, where the
    batch is replicated, its block of positions; the VLM family's cache
    holds its frontend's keys and values).  ``tp1`` or ``dp_all`` builds
    the model on the reference's specs without "model"
    (``transformer.Transformer(tp1=True)``), and ``dp_all`` splits the
    prefill's rows over "model" too (``prefill_axes``; a batch that does
    not divide raises, as the reference's ``jit`` refuses it).  The
    model's constructor raises first where ``transformer.check_ported``
    refuses the mesh."""
    cfg = apply_opt_flags(cfg, opt_flags)
    tp1 = any(f in SPEC_FLAGS for f in opt_flags)
    axes = prefill_axes(mesh, opt_flags) if shape.kind == "prefill" else None
    if axes:
        train.rows(shape.batch, mesh, axes)
    model = transformer.Transformer(cfg, device=device, mesh=mesh, tp1=tp1)
    specs = input_specs(cfg, shape)
    B, S = shape.batch, shape.seq
    grads: dict = {}
    if shape.kind == "train":
        model.requires_grad_(True)
        for name, p in model.named_parameters():
            p.register_hook(functools.partial(_note_grad, grads, name))
        opt_state = optim.init(dict(model.named_parameters()))
        step = train.make_train_step(
            cfg, optim.AdamWConfig(), mesh,
            microbatches=4 if "microbatch" in opt_flags else 1,
            loss_chunks=16 if "chunked_loss" in opt_flags else 0)
        r = train.rows(B, mesh)
        batch = {k: _local(v, device, r) for k, v in specs.items()}
        return Traced(lambda: step(model, opt_state, batch), model,
                      {"optimizer_state": opt_state, "inputs": batch}, grads)
    if shape.kind == "prefill":
        r = train.rows(B, mesh, axes)
        batch = {k: _local(v, device, r) for k, v in specs.items()}

        def prefill():
            with torch.no_grad():
                return transformer.forward(
                    model, cfg, tokens=batch.get("tokens"),
                    embeds=batch.get("embeds"), frontend=batch.get("frontend"),
                    use_kernel=False, batch_axes=axes)
        return Traced(prefill, model, {"inputs": batch}, grads)
    frontend = None
    if cfg.family == "vlm":
        frontend = torch.empty((B, cfg.n_frontend_tokens, cfg.d_model),
                               dtype=cfg.dtype, device=device)
    with torch.no_grad():
        cache = serve.make_cache(model, cfg, B, S, frontend=frontend,
                                 mesh=mesh)
    bm = serve.batch_mesh(mesh, B)
    r = train.rows(B, bm) if bm and "data" in bm.mesh_dim_names else None
    batch = {k: _local(v, device, r) for k, v in specs.items()}
    if frontend is not None:
        batch["frontend"] = _local(frontend, device, r)
    del frontend
    step = serve.make_serve_step(cfg, mesh, batch=B, max_len=S)

    def decode():
        with torch.no_grad():
            return step(model, cache, batch.get("tokens"), batch.get("embeds"),
                        batch.get("frontend"))
    return Traced(decode, model, {"cache": cache, "inputs": batch}, grads)


def _shape_key(x):
    """A hashable key of an op argument: a tensor by its shape, strides
    and dtype (its device is meta)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_shape_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _shape_key(v)) for k, v in x.items())
    return x


def _on_meta(args, kwargs) -> bool:
    """Whether an op's tensors are on the meta device (its first tensor
    argument decides; a factory op, its ``device``)."""
    for a in args:
        if isinstance(a, (list, tuple)) and a:
            a = a[0]
        if isinstance(a, torch.Tensor):
            return a.is_meta
    return kwargs.get("device") == torch.device("meta")


def _spec(out):
    """The shapes of an op's meta output: a tensor's (shape, strides,
    dtype), a sequence's (type, [each item's or None]); None for anything
    else."""
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype) \
            if out.is_meta else None
    if isinstance(out, (list, tuple)) and all(
            o is None or isinstance(o, torch.Tensor) and o.is_meta
            for o in out):
        return (type(out), [None if o is None else _spec(o) for o in out])
    return None


def _build(spec):
    """New meta tensors of the shapes ``_spec`` gave."""
    if len(spec) == 2:
        kind, items = spec
        return kind(None if i is None else _build(i) for i in items)
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _pure(func) -> bool:
    """An aten op whose outputs are new tensors that its inputs' shapes
    decide: no mutation, no view, no randomness, no data-dependent
    shape."""
    sch = func._schema
    return (func.namespace == "aten" and not sch.is_mutable
            and all(r.alias_info is None for r in sch.returns)
            and not {torch.Tag.nondeterministic_seeded,
                     torch.Tag.dynamic_output_shape,
                     torch.Tag.data_dependent_output} & set(func.tags))


class Measure(TorchDispatchMode):
    """One pass over a step, every aten op seen once:
    - ``flops``: FlopCounterMode's formulas (``flop_counter.flop_registry``:
      matmuls, attention, convolutions);
    - ``bytes``: each tensor input and output of an op once (a view or a
      bare allocation: none);
    - memory: the bytes of the storages alive, beyond those of
      ``held`` (the tensors alive across the step, counted apart), as
      MemTracker counts them: each new storage when an op makes it, freed
      when it dies; ``peak`` the most alive after any op, and its
      ``split`` into "activations" (made before the backward pass) and
      "temporaries" (made from the backward pass on: gradients and the
      optimizer's work).
    On the meta device an op's output shapes are memoised by its inputs'
    (``_pure`` ops): a recurrent loop's steps cost one shape inference."""

    def __init__(self, held=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary

        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = WeakIdKeyDictionary()
        for t in held:
            self.live[t.untyped_storage()] = None
        self.alive = {"activations": 0, "temporaries": 0}
        self.peak, self.split = 0, dict(self.alive)
        self.backward = False
        self.pure: dict = {}
        self.memo: dict = {}

    def _free(self, kind: str, n: int) -> None:
        self.alive[kind] -= n

    def _run(self, func, args, kwargs):
        pure = self.pure.get(func)
        if pure is None:
            pure = self.pure[func] = _pure(func)
        if not pure:
            return func(*args, **kwargs)
        key = (func, _shape_key(args), _shape_key(kwargs))
        spec = self.memo.get(key)
        if spec is not None:
            return _build(spec)
        out = func(*args, **kwargs)
        spec = _spec(out)
        if spec is not None:
            self.memo[key] = spec
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs) if _on_meta(args, kwargs) else \
            func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        if func.overloadpacket in self.registry:
            self.flops += self.registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        if not (func.is_view or func.overloadpacket in _ALLOCATIONS):
            self.bytes += _nbytes(list(args)) + _nbytes(kwargs) + \
                _nbytes(out)
        self.backward = self.backward or \
            torch._C._current_graph_task_id() != -1
        kind = "temporaries" if self.backward else "activations"
        for t in _tensors(out):
            st = t.untyped_storage()
            if st not in self.live:
                n = st.nbytes()
                self.live[st] = kind
                self.alive[kind] += n
                weakref.finalize(st, self._free, kind, n)
        total = sum(self.alive.values())
        if total > self.peak:
            self.peak, self.split = total, dict(self.alive)
        return out


def collective_stats(tape: list) -> dict:
    """The reference's collective record (``core/hlo.py``
    ``CollectiveStats``) of ``sharding.TAPE``'s (kind, operand bytes,
    group ranks) entries."""
    out = {"operand_bytes": 0.0, "wire_bytes": 0.0, "count": 0,
           "by_kind": {}}
    for kind, nbytes, n in tape:
        out["count"] += 1
        out["operand_bytes"] += nbytes
        out["wire_bytes"] += nbytes * (_WIRE[kind](n) if n > 1 else 0.0)
        k = out["by_kind"].setdefault(kind, {"bytes": 0.0, "count": 0})
        k["bytes"] += nbytes
        k["count"] += 1
    return out


def _cell_costs(t: Traced) -> dict:
    """Run ``t``'s step once under ``Measure`` and ``sharding.TAPE`` ->
    {"flops", "bytes", "memory", "operand_bytes", "wire_bytes", "count",
    "by_kind"}, all a rank."""
    held = list(t.model.parameters()) + _tensors(t.held)
    m, sharding.TAPE = Measure(held), []
    try:
        with m:
            t.step()
        coll = collective_stats(sharding.TAPE)
    finally:
        sharding.TAPE = None
    base = {"parameters": _nbytes(list(t.model.parameters())),
            **{k: _nbytes(t.held.get(k, []))
               for k in ("optimizer_state", "cache", "inputs")}}
    memory = {**base, "gradients": sum(t.grads.values()), **m.split,
              "total_per_device": sum(base.values()) + m.peak}
    return {"flops": float(m.flops), "bytes": float(m.bytes),
            "memory": memory, **coll}


def _cache_bytes(cfg, shape) -> float:
    """The bytes of the whole decode cache of ``shape``'s batch."""
    whole = transformer.Transformer(cfg, device="meta")
    fr = None
    if cfg.family == "vlm":
        fr = torch.empty((shape.batch, cfg.n_frontend_tokens, cfg.d_model),
                         dtype=cfg.dtype, device="meta")
    with torch.no_grad():
        cache = transformer.init_cache(whole, cfg, shape.batch, shape.seq,
                                       frontend=fr)
    return float(_nbytes(cache))


def model_terms(cfg, shape) -> tuple[float, float]:
    """The cell's useful FLOPs and least memory traffic, all ranks
    (``core.perfmodel``'s ``model_flops_*`` and ``min_hbm_bytes_*``)."""
    tokens = shape.batch * shape.seq
    if shape.kind == "train":
        return (model_flops_train(cfg.active_params(), tokens),
                min_hbm_bytes_train(cfg, tokens))
    if shape.kind == "prefill":
        return (model_flops_decode(cfg.active_params(), tokens),
                min_hbm_bytes_prefill(cfg, tokens))
    return (model_flops_decode(cfg.active_params(), shape.batch),
            min_hbm_bytes_decode(cfg, shape.batch, _cache_bytes(cfg, shape)))


def analyse(cfg, shape, mesh, costs: dict) -> dict:
    """The reference's record of a cell from its costs a rank."""
    dims = sharding.mesh_shape(mesh)
    chips = sharding.axis_size(dims, tuple(dims))
    mflops, mbytes = model_terms(cfg, shape)
    terms = RooflineTerms(flops=costs["flops"] * chips,
                          hbm_bytes=costs["bytes"] * chips,
                          collective_bytes=costs["operand_bytes"] * chips,
                          chips=chips, model_flops=mflops,
                          model_bytes=mbytes)
    mem = costs["memory"]
    return {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "x".join(str(n) for n in dims.values()),
        "chips": chips, "card": CARD,
        "cost_per_device": {"flops": costs["flops"], "bytes": costs["bytes"]},
        "memory_per_device": mem,
        "hbm_ok": bool(mem["total_per_device"] <= GpuModel().hbm_bytes),
        "collectives": {k: costs[k] for k in ("operand_bytes", "wire_bytes",
                                              "count", "by_kind")},
        "roofline": terms.row(),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, opt_flags=(),
             out_dir: str | None = None, verbose: bool = True) -> dict:
    """Trace one cell in a fake world of its mesh's ranks (or record its
    ``skip_reason``) and write its record -> the record."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    skip = skip_reason(cfg, shape)
    if skip:
        rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
               "status": skip}
    else:
        t0 = time.time()
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            costs = _cell_costs(trace_cell(cfg, shape, mesh,
                                           opt_flags=opt_flags))
            rec = analyse(apply_opt_flags(cfg, opt_flags), shape, mesh,
                          costs)
        rec["status"] = "OK"
        rec["trace_seconds"] = time.time() - t0
        if verbose:
            print({k: round(v / 1e9, 3)
                   for k, v in rec["memory_per_device"].items()}, "GB")
            print({"flops": rec["cost_per_device"]["flops"],
                   "bytes": rec["cost_per_device"]["bytes"],
                   "collective_bytes": rec["collectives"]["operand_bytes"]})
    if verbose:
        print(json.dumps({k: v for k, v in rec.items()
                          if k in ("arch", "shape", "mesh", "status")}))
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    tag = "opt-" + "-".join(opt_flags) + "_" if opt_flags else ""
    fname = f"{tag}{cfg.name}_{shape.name}_{mesh_name}.json".replace("/", "_")
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", default="", help="comma-joined opt flags")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    archs = ARCHS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    opt_flags = tuple(f for f in args.opt.split(",") if f)
    try:
        apply_opt_flags(get_config(archs[0]), opt_flags)
    except ValueError as e:
        raise SystemExit(f"[dryrun] {e}") from None

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                label = f"{arch} × {shape} × {'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, shape, mp, opt_flags=opt_flags,
                                   out_dir=args.out)
                    print(f"[dryrun] {label}: {rec['status']}", flush=True)
                except Exception as e:
                    failures.append((label, repr(e)))
                    traceback.print_exc()
                    print(f"[dryrun] {label}: FAIL {e}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: "
                         + "; ".join(label for label, _ in failures))
    print("[dryrun] all requested cells traced OK")


if __name__ == "__main__":
    main()
