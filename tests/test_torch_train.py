"""Port parity of the training path's model side: ``transformer.loss_fn``
(whole logits and ``_chunked_ce``), its gradients for every config
family, remat, and the two repairs the training path needed
(``kernels/ref.attention`` backpropagates; parameters take gradients when
training asks) — against ``repro``.

The reference's seeded weights go through
``models.convert.params_from_reference`` into the port's model on the
CPU, trainable (``requires_grad_(True)``, as ``launch.train`` makes it);
the same numpy batch (``data.make_batch``) goes through the reference's
jitted ``jax.value_and_grad(loss_fn)`` and the port's ``loss_fn`` +
``torch.autograd.grad``.  The port's gradients, mapped into the
reference's tree by ``convert.reference_tree``, are compared leaf by
leaf.

Tolerances: the loss at 1e-5 (absolute; both sides compute in float32
and differ in the order of their sums); each gradient leaf at 1e-4 of that
leaf's largest |g|.  One exception: jamba's gradients.  Its SMOKE stack is
ill-conditioned at these seeded weights (its logits are held at 1e-3 in
tests/test_torch_moe_hybrid.py for that reason), and moving every weight
of the reference by one ulp moves the reference's own gradients past
1e-4; the port's gap is held within twice that move
(``reference_spread``).  The MoE family runs at capacity factor 0.5, so
that pairs drop.
"""
import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget
from repro.data import DataConfig as JDataConfig
from repro.data import make_batch as jmake_batch
from repro.kernels import ref as jref
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.kernels import cuda_lib, ref
from repro_torch.launch import train
from repro_torch.models import convert, transformer
from repro_torch import optim

# the whole suite runs in 6 pytest workers on 8 cores: two intra-op threads
# a worker keep these modules from starving the reference's timing-gated tests
torch.set_num_threads(2)

#: one SMOKE config of each family: dense, MoE, hybrid, VLM, xLSTM, audio
FAMILIES = ["tinyllama-1.1b", "deepseek-moe-16b", "jamba-1.5-large-398b",
            "llama-3.2-vision-11b", "xlstm-125m", "musicgen-medium"]
LOSS_TOL = 1e-5
TOL = 1e-4
#: families whose gradients are held within twice the reference's own
#: one-ulp spread (module docstring)
SPREAD = {"jamba-1.5-large-398b"}


def configs(arch: str):
    jcfg, tcfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    if jcfg.family == "moe":        # pairs drop at capacity factor 0.5
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.5)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=0.5)
    return jcfg, tcfg


@functools.cache
def carried(arch: str, seed: int = 1):
    """(reference cfg, reference params, port cfg, trainable port model)."""
    jcfg, tcfg = configs(arch)
    params = jax.jit(lambda k: jt.init(k, jcfg)[0])(jax.random.PRNGKey(seed))
    model = convert.params_from_reference(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu")
    return jcfg, params, tcfg, model.requires_grad_(True)


def batch(cfg, step: int = 0) -> dict:
    return jmake_batch(cfg, JDataConfig(seed=0, batch=2, seq=16), step)


@functools.cache
def _jvalue_and_grad(jcfg, loss_chunks: int = 0):
    return jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(p, jcfg, b, loss_chunks=loss_chunks),
        has_aux=True))


@functools.cache
def reference(arch: str):
    """The reference's ((loss, {"ce", "aux"}), grads) on ``batch``."""
    jcfg, params, _, _ = carried(arch)
    return _jvalue_and_grad(jcfg)(params, batch(jcfg))


def port(arch: str, **kw):
    """The port's (loss, {"ce", "aux"}, grads as the reference's tree of
    numpy arrays; a parameter the loss does not reach as zeros)."""
    _, _, tcfg, model = carried(arch)
    loss, aux = transformer.loss_fn(
        model, tcfg, train.to_device(batch(tcfg), tcfg, "cpu"), **kw)
    named = dict(model.named_parameters())
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(named.items(), gs)}
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            convert._map(convert._numpy, convert.reference_tree(grads, tcfg)))


def leaf_gaps(want, got) -> list[float]:
    """Each leaf's max |got - want| over its largest |want|."""
    return [float(np.abs(np.asarray(w) - g).max() / np.abs(np.asarray(w)).max())
            for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got))]


def reference_spread(arch: str, seeds=(0, 1)) -> float:
    """The largest move of the reference's own gradients (as
    ``leaf_gaps``) when every weight moves by one ulp, up or down as
    ``seeds`` draw it."""
    jcfg, params, _, _ = carried(arch)
    want = reference(arch)[1]
    reach = 0.0
    for seed in seeds:
        rng = np.random.default_rng(seed)

        def nudge(a):
            a = np.asarray(a)
            up = rng.random(a.shape) < 0.5
            return jnp.asarray(np.nextafter(
                a, np.where(up, np.inf, -np.inf).astype(a.dtype)))

        moved = _jvalue_and_grad(jcfg)(jax.tree.map(nudge, params),
                                       batch(jcfg))[1]
        reach = max(reach, max(leaf_gaps(want, jax.tree.map(np.asarray,
                                                             moved))))
    return reach


# -- loss and gradients, every family -----------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_matches_reference(arch):
    (jloss, jaux), _ = reference(arch)
    loss, aux, _ = port(arch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    for got, want in ((loss, jloss), (aux["ce"], jaux["ce"]),
                      (aux["aux"], jaux["aux"])):
        assert abs(float(got) - float(want)) <= LOSS_TOL, (got, want)
    if carried(arch)[2].family == "moe":
        assert float(aux["aux"]) > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_grads_match_reference(arch):
    """Every leaf of the reference's tree, its largest |g| nonzero (the
    audio family's ``embed`` gets none on either side: it feeds
    ``embeds=``, so the port's gradient is None and counts as zeros)."""
    _, jgrads = reference(arch)
    _, _, grads = port(arch)
    assert jax.tree.structure(jgrads) == jax.tree.structure(grads)
    for w, g in zip(jax.tree.leaves(jgrads), jax.tree.leaves(grads)):
        assert np.asarray(w).shape == g.shape and g.dtype == np.float32
    if carried(arch)[2].family == "audio":
        assert not np.asarray(jgrads["embed"]).any() and \
            not grads["embed"].any()
        jgrads, grads = ({k: v for k, v in t.items() if k != "embed"}
                         for t in (jgrads, grads))
    gap = max(leaf_gaps(jgrads, grads))
    if arch in SPREAD:
        reach = reference_spread(arch)
        assert reach > TOL and gap <= 2 * reach, (gap, reach)
    else:
        assert gap <= TOL, gap


@pytest.mark.parametrize("arch", FAMILIES)
def test_weights_and_state_round_trip_byte_identical(arch):
    """``params_to_reference`` after ``params_from_reference`` gives the
    reference's tree back byte for byte, and so do
    ``opt_state_to_reference`` after ``opt_state_from_reference`` for the
    reference's ``optim.init`` of it (a non-zero step)."""
    from repro import optim as joptim

    _, params, tcfg, model = carried(arch)
    want = jax.tree.map(np.asarray, params)
    got = convert.params_to_reference(model, tcfg)
    jstate = jax.tree.map(np.asarray, joptim.init(params))
    jstate["step"] = np.int32(7)
    state = convert.opt_state_from_reference(jstate, tcfg, device="cpu")
    assert int(state["step"]) == 7 and state["step"].dtype == torch.int32
    assert set(state["master"]) == {k for k, _ in model.named_parameters()}
    for w, g in ((want, got),
                 (jstate, convert.opt_state_to_reference(state, tcfg))):
        assert jax.tree.structure(w) == jax.tree.structure(g)
        for a, b in zip(jax.tree.leaves(w), jax.tree.leaves(g)):
            assert np.asarray(a).dtype == b.dtype and np.asarray(a).shape == b.shape
            assert np.asarray(a).tobytes() == b.tobytes()


def test_bfloat16_weights_round_trip_byte_identical():
    """A bfloat16 model's leaves come back as ``ml_dtypes`` bfloat16, the
    reference's leaf type, bit for bit."""
    jcfg = dataclasses.replace(jget("deepseek-moe-16b", smoke=True),
                               dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                               dtype=torch.bfloat16)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: jt.init(k, jcfg)[0])(jax.random.PRNGKey(2)))
    got = convert.params_to_reference(
        convert.params_from_reference(params, tcfg, device="cpu"), tcfg)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- chunked CE --------------------------------------------------------------------

@pytest.mark.parametrize("n_chunks", [1, 3, 4, 5])
def test_chunked_ce_matches_reference(n_chunks):
    """V = 37 divides by none of 3, 4, 5: the padded columns read -1e30.
    Loss and its gradients in x and the head at 1e-5."""
    rng = np.random.default_rng(n_chunks)
    x = rng.normal(size=(2, 5, 8)).astype(np.float32)
    w = rng.normal(size=(8, 37)).astype(np.float32)
    labels = rng.integers(0, 37, (2, 5)).astype(np.int32)
    labels[0, 0], labels[1, 4] = 36, 0       # the edges of the vocab
    jl, (jgx, jgw) = jax.value_and_grad(
        lambda a, b: jt._chunked_ce(a, b, jnp.asarray(labels), n_chunks),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    loss = transformer._chunked_ce(tx, tw, torch.from_numpy(labels).long(),
                                   n_chunks)
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    for got, want in ((gx, jgx), (gw, jgw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-moe-16b"])
def test_loss_chunks_match_the_whole_logits(arch):
    """``loss_fn(loss_chunks=3)`` (a vocab of 128 in chunks of 43) against
    the whole-logits loss and against the reference's chunked loss, 1e-5."""
    jcfg, params, tcfg, model = carried(arch)
    b = train.to_device(batch(tcfg), tcfg, "cpu")
    with torch.no_grad():
        whole, _ = transformer.loss_fn(model, tcfg, b)
        chunked, _ = transformer.loss_fn(model, tcfg, b, loss_chunks=3)
    (jl, _), _ = _jvalue_and_grad(jcfg, 3)(params, batch(jcfg))
    assert abs(float(chunked) - float(whole)) <= LOSS_TOL
    assert abs(float(chunked) - float(jl)) <= LOSS_TOL


# -- remat -------------------------------------------------------------------------

def saved_bytes(fn) -> int:
    """Bytes of the tensors autograd saves outside any checkpoint while
    ``fn`` runs."""
    seen = []

    def pack(t):
        seen.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen)


class OpCount(TorchDispatchMode):
    """Counts the aten ops that run under it."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-moe-16b"])
def test_remat_gives_the_same_loss_and_grads(arch):
    """``remat=True`` (each repeat of the layer group recomputed in the
    backward pass; deepseek's dense layer 0 is its prologue, outside)
    with both policies gives the loss and gradients of ``remat=False``
    bit for bit on the CPU.  Autograd keeps less outside the checkpoints
    than without remat; the backward pass under "full" recomputes the
    group's plain matmuls (more ``aten.mm`` than without remat), under
    "dots" it recomputes the rest (more ``aten.rsqrt``, the norms) but
    no matmul it saved (as many ``aten.mm`` as without remat)."""
    _, _, tcfg, model = carried(arch)
    b = train.to_device(batch(tcfg), tcfg, "cpu")
    named = dict(model.named_parameters())
    out, saved, ops_ = {}, {}, {}
    for policy in (None, "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=policy is not None,
                                  remat_policy=policy or "full")
        box = {}

        def run():
            box["loss"], _ = transformer.loss_fn(model, cfg, b)

        saved[policy] = saved_bytes(run)
        with OpCount() as count:
            grads = torch.autograd.grad(box["loss"], list(named.values()))
        out[policy], ops_[policy] = (box["loss"], grads), count.n
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out[None][0])
        for g, g0 in zip(out[policy][1], out[None][1]):
            assert torch.equal(g, g0)
        assert saved[policy] < saved[None], saved
    mm, rsqrt = torch.ops.aten.mm.default, torch.ops.aten.rsqrt.default
    assert ops_["full"][mm] > ops_[None][mm] == ops_["dots"][mm]
    assert ops_["full"][rsqrt] == ops_["dots"][rsqrt] > ops_[None][rsqrt]


# -- refusals ----------------------------------------------------------------------

def test_train_step_refuses_the_kernel():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        train.make_train_step(cfg, optim.AdamWConfig(), use_kernel=True)


def test_require_cuda_refuses_inputs_that_require_grad():
    """A kernel's output has no ``grad_fn``: under grad, an input that
    requires grad is refused before anything launches (checked first, so
    a CPU tensor shows it here); under ``no_grad`` it passes this check."""
    x = torch.ones(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_lib.require_cuda("flash_attention", x)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lib.require_cuda("flash_attention", x)


def test_serving_parameters_stay_frozen():
    """Serving takes no gradients: a model is built frozen, and
    ``init_state`` makes it trainable."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    served = transformer.init(cfg, seed=0, device="cpu")
    assert not any(p.requires_grad for p in served.parameters())
    model, state = train.init_state(0, cfg, "cpu")
    assert all(p.requires_grad for p in model.parameters())
    assert set(state["master"]) == {k for k, _ in model.named_parameters()}


# -- the ref.attention repair ----------------------------------------------------------

def attention_before(q, k, v, *, causal=True, window=None):
    """``kernels/ref.attention`` as it was: the fully masked rows' NaN
    zeroed in place in the softmax output."""
    B, H, S, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    group = H // KVH
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32),
                          kr.to(torch.float32)) * (1.0 / np.sqrt(D))
    qpos = torch.arange(S)[:, None] + (T - S)
    kpos = torch.arange(T)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits.masked_fill_(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    del logits
    p.nan_to_num_(nan=0.0)
    return torch.einsum("bhst,bhtd->bhsd", p,
                        vr.to(torch.float32)).to(q.dtype)


def qkv(S, T, dtype=torch.float32, seed=0, grad=False):
    rng = np.random.default_rng(seed)
    shapes = ((2, 4, S, 8), (2, 2, T, 8), (2, 2, T, 8))
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(dtype).requires_grad_(grad) for s in shapes)


# (S, T, window): S > T puts the first S - T queries before every key, so
# their rows are fully masked under the causal mask
CASES = [(12, 12, None), (12, 12, 4), (12, 7, None), (12, 7, 3), (3, 12, 5)]


@pytest.mark.parametrize("S,T,window", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ref_attention_forward_is_unchanged(S, T, window, dtype):
    q, k, v = qkv(S, T, dtype)
    got = ref.attention(q, k, v, causal=True, window=window)
    assert torch.equal(got, attention_before(q, k, v, window=window))
    if S > T:
        assert not got[:, :, :S - T].any()


@pytest.mark.parametrize("S,T,window", CASES)
def test_ref_attention_backpropagates(S, T, window):
    """Gradients in q, k and v, finite, against ``jax.grad`` of the
    reference's oracle at 1e-5; a fully masked row gives its query zero
    gradient and leaks no NaN, as ``jnp.where`` does."""
    q, k, v = qkv(S, T, grad=True)
    w = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, 4, S, 8)).astype(np.float32))
    out = ref.attention(q, k, v, causal=True, window=window)
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    want = jax.grad(lambda a, b, c: jnp.sum(jref.attention(
        a, b, c, causal=True, window=window) * jnp.asarray(w.numpy())),
        argnums=(0, 1, 2))(*(jnp.asarray(t.detach().numpy())
                             for t in (q, k, v)))
    for g, jg in zip(grads, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-5)
    if S > T:
        assert not grads[0][:, :, :S - T].any()


@pytest.mark.parametrize("impl", ["ref", "grouped"])
def test_ref_decode_attention_backpropagates(impl):
    """Decode attention over caches of lengths 1, 5 and 9 (window 4), both
    forms, against ``jax.grad`` of the reference's oracles at 1e-5."""
    rng = np.random.default_rng(4)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((3, 4, 1, 8), (3, 2, 9, 8), (3, 2, 9, 8))]
    lengths = np.array([1, 5, 9], np.int32)
    fn, jfn = ((ref.decode_attention, jref.decode_attention) if impl == "ref"
               else (ref.decode_attention_grouped,
                     jref.decode_attention_grouped))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts, torch.from_numpy(lengths), window=4)
    grads = torch.autograd.grad((out ** 2).sum(), ts)
    want = jax.grad(lambda a, b, c: jnp.sum(jfn(
        a, b, c, jnp.asarray(lengths), window=4) ** 2),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    for g, jg in zip(grads, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "h2o-danube-3-4b"])
def test_serving_forward_is_unchanged(arch, monkeypatch):
    """``forward`` on the repaired ``ref.attention`` gives the logits of
    the old one, bit for bit (h2o-danube: a window of 16)."""
    cfg = get_config(arch, smoke=True)
    model = transformer.init(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32))
    with torch.no_grad():
        now, _ = transformer.forward(model, cfg, toks)
        monkeypatch.setattr(ref, "attention", attention_before)
        before, _ = transformer.forward(model, cfg, toks)
    assert torch.equal(now, before)
