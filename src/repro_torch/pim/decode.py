"""PIM-offloaded LLM decode serving — the PyTorch counterpart of
``repro.pim.decode``.

Autoregressive decode is one long stream of matvecs against weights that
never change, so each weight matrix crosses the host↔bank boundary once,
at engine setup, and every later token moves only its activation vector.
:class:`DecodeEngine` is that serving path, assembled from the session:

* **weight residency** — every (layer, projection) operand pytree from
  :mod:`repro_torch.models.pim_bridge` is wrapped in one
  :class:`~repro_torch.runtime.resident.ResidentHandle` and pinned through
  :meth:`~repro_torch.pim.session.PimSession.pin`, so the first token is
  already warm and no step rehashes the weights;
* **rank-sharded matvecs** — the pinned GEMV-B / GEMV-G chunks are output
  rows; on a ranked session the contiguous chunk blocks shard attention
  heads and FFN columns across ranks;
* **multi-stream serving** — each decode stream is its own tenant; every
  step submits each projection for all streams in one group;
* **phase accounting** — every request is tagged ``layer=i,
  proj=q|k|v|o|up|down``, and each step keeps a :class:`StepRecord` of
  where its wall time went.

Host/PIM split per layer; the host half runs on the CPU (the host), in
the model's own torch functions, as the reference runs it in jnp:

    host: rms_norm ─ PIM: q,k,v ─ host: rope + KV append + attention
    ─ PIM: o ─ host: residual + rms_norm ─ PIM: gate|up ─ PIM: down
    ─ host: residual    (per layer; then final norm + lm_head + argmax)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.models import attention
from repro_torch.models.layers import ModelConfig, rms_norm, rope
from repro_torch.models.pim_bridge import LayerWeights, extract_decode_weights
from repro_torch.runtime.qos import RequestOptions
from repro_torch.runtime.resident import ResidentHandle
from repro_torch.runtime.trace import get_tracer

from .session import PimSession, session as open_session

#: projection label -> PrIM workload that serves it
PROJ_WORKLOADS = {"q": "GEMV-B", "k": "GEMV-B", "v": "GEMV-B",
                  "o": "GEMV-B", "up": "GEMV-G", "down": "GEMV-B"}

#: engine-measured step phases: the four PIM groups + everything else
PIM_GROUPS = ("qkv", "o", "up", "down")

_HOST = torch.device("cpu")


@dataclasses.dataclass
class StepRecord:
    """Where one engine step's wall time went — measured by the engine
    around each submit→drain group and each host segment, independently of
    the telemetry rows the same step produces."""

    step: int
    tokens: int              # newly *generated* tokens (0 while prefilling)
    wall_s: float
    pim_s: dict              # group ("qkv"|"o"|"up"|"down") -> seconds
    host_s: float


class _Stream:
    """One decode stream: its tenant name, emitted tokens, and per-layer
    KV caches on the host (``attention.init_cache``'s layout)."""

    __slots__ = ("name", "tokens", "caches")

    def __init__(self, name: str, cfg: ModelConfig, max_len: int,
                 first_token: int):
        self.name = name
        self.tokens = [int(first_token)]
        self.caches = [attention.init_cache(cfg, 1, max_len, torch.float32,
                                            device=_HOST)
                       for _ in range(cfg.n_layers)]


class DecodeEngine:
    """Continuous multi-stream greedy decode with session-resident weights.

    ``model`` is the port's ``Transformer`` (any device; the engine copies
    what the host half needs to the CPU).  ``session=`` reuses an open
    :class:`PimSession` (it must allow residency for pinning); otherwise
    the engine opens its own from ``banks=`` / ``ranks=`` / ``n_chunks=`` /
    ``device=`` and closes it with :meth:`close`.  Every projection is
    pinned at setup when the session keeps residents; with
    ``resident=False`` nothing is pinned and every step re-scatters every
    weight.
    """

    def __init__(self, model, cfg: ModelConfig, *,
                 session: PimSession | None = None,
                 banks: int | None = None, ranks: int | None = None,
                 n_chunks: int = 2, resident: bool = True, device=None):
        self.cfg = cfg
        self.layers: list[LayerWeights] = extract_decode_weights(model, cfg)
        self.host = {name: getattr(model, name).detach().to(_HOST)
                     for name in ("embed", "final_norm", "lm_head")}
        self._own = session is None
        if session is None:
            session = open_session(banks=banks, ranks=ranks,
                                   n_chunks=n_chunks, resident=resident,
                                   device=device)
        self.session = session
        self.steps: list[StepRecord] = []
        # one handle per (layer, proj): the digest is computed once here;
        # every submit and the pin below reuse it (no per-step rehash)
        self.handles: dict[tuple[int, str], ResidentHandle] = {}
        for li, lw in enumerate(self.layers):
            for proj in PROJ_WORKLOADS:
                attr = "gate_up" if proj == "up" else proj
                self.handles[(li, proj)] = ResidentHandle(getattr(lw, attr))
        self.pins: list[str] = []
        self.setup_s = 0.0
        if session.cache is not None:
            t0 = time.perf_counter()
            for (li, proj), handle in self.handles.items():
                x = np.zeros(self._in_dim(li, proj), np.float32)
                self.pins.append(
                    session.pin(PROJ_WORKLOADS[proj], handle, x))
            self.setup_s = time.perf_counter() - t0

    def _in_dim(self, li: int, proj: str) -> int:
        lw = self.layers[li]
        if proj == "o":
            return lw.o["w"].shape[1]          # H * hd
        if proj == "down":
            return lw.down["w"].shape[1]       # d_ff
        return self.cfg.d_model

    # -- one projection group across all streams -------------------------------

    def _group(self, li: int, projs: Sequence[str],
               vecs_per_stream: Sequence[Sequence[np.ndarray]],
               streams: Sequence[_Stream]) -> tuple[list, float]:
        """Submit ``projs`` (e.g. ``("q","k","v")``) for every stream, run
        the group to completion, and return (results stream-major in proj
        order, group wall seconds)."""
        t0 = time.perf_counter()
        reqs = []
        for s, vecs in zip(streams, vecs_per_stream):
            for proj, vec in zip(projs, vecs):
                opts = RequestOptions(tenant=s.name,
                                      tags={"layer": li, "proj": proj})
                reqs.append(self.session.submit(
                    PROJ_WORKLOADS[proj], self.handles[(li, proj)],
                    np.asarray(vec, np.float32), options=opts))
        if not self.session.serving:
            self.session.drain()
        results = [r.result() for r in reqs]
        return results, time.perf_counter() - t0

    # -- one step: every stream advances one token -----------------------------

    def _attend(self, stream: _Stream, li: int, qv, kv, vv) -> np.ndarray:
        """Host half of the attention block for one stream: rope, KV append
        at the cache cursor, softmax attention — ``attention.decode`` with
        the three projections supplied."""
        cfg = self.cfg
        H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        cache = stream.caches[li]
        q = torch.from_numpy(qv).reshape(1, 1, H, hd).transpose(1, 2)
        k = torch.from_numpy(kv).reshape(1, 1, KVH, hd).transpose(1, 2)
        v = torch.from_numpy(vv).reshape(1, 1, KVH, hd).transpose(1, 2)
        positions = cache["len"][:, None]
        q = rope(q, positions[:, None, :], cfg.rope_theta)
        k = rope(k, positions[:, None, :], cfg.rope_theta)
        o, stream.caches[li] = attention.attend_cached(cfg, q, k, v, cache)
        return o.reshape(-1).numpy()

    def _step(self, streams: Sequence[_Stream], toks: np.ndarray,
              step: int, generated: bool) -> np.ndarray:
        """Advance every stream one position on input tokens ``toks``
        ((B,) int32); returns next tokens (B,) int32 by greedy argmax and
        appends this step's :class:`StepRecord`."""
        d = self.cfg.d_model
        t0 = time.perf_counter()
        host_s = 0.0
        pim_s = dict.fromkeys(PIM_GROUPS, 0.0)

        th = time.perf_counter()
        xs = [self.host["embed"][int(t)].reshape(1, 1, d) for t in toks]
        host_s += time.perf_counter() - th

        for li, lw in enumerate(self.layers):
            th = time.perf_counter()
            hv = [rms_norm(x, lw.norm1).reshape(-1).numpy() for x in xs]
            host_s += time.perf_counter() - th

            qkv, dt = self._group(li, ("q", "k", "v"),
                                  [(h, h, h) for h in hv], streams)
            pim_s["qkv"] += dt

            th = time.perf_counter()
            ov = [self._attend(s, li, *qkv[3 * b:3 * b + 3])
                  for b, s in enumerate(streams)]
            host_s += time.perf_counter() - th

            mo, dt = self._group(li, ("o",), [(o,) for o in ov], streams)
            pim_s["o"] += dt

            th = time.perf_counter()
            xs = [x + torch.from_numpy(m).reshape(1, 1, d)
                  for x, m in zip(xs, mo)]
            h2 = [rms_norm(x, lw.norm2).reshape(-1).numpy() for x in xs]
            host_s += time.perf_counter() - th

            hidden, dt = self._group(li, ("up",), [(h,) for h in h2],
                                     streams)
            pim_s["up"] += dt
            down, dt = self._group(li, ("down",), [(h,) for h in hidden],
                                   streams)
            pim_s["down"] += dt

            th = time.perf_counter()
            xs = [x + torch.from_numpy(dn).reshape(1, 1, d)
                  for x, dn in zip(xs, down)]
            host_s += time.perf_counter() - th

        th = time.perf_counter()
        nxt = []
        for x in xs:
            h = rms_norm(x, self.host["final_norm"])
            logits = h @ self.host["lm_head"]               # (1, 1, V)
            nxt.append(int(logits[:, -1, :].argmax(dim=-1)[0]))
        host_s += time.perf_counter() - th

        wall = time.perf_counter() - t0
        self.steps.append(StepRecord(
            step=step, tokens=len(streams) if generated else 0,
            wall_s=wall, pim_s=pim_s, host_s=host_s))
        tr = get_tracer()
        if tr.enabled:
            tr.emit("decode_step", "session", t0, t0 + wall, track="decode",
                    step=step, streams=len(streams),
                    generated=int(generated))
        return np.asarray(nxt, np.int32)

    # -- public API ------------------------------------------------------------

    @torch.no_grad()
    def generate(self, prompts, max_new: int) -> np.ndarray:
        """Greedy-decode ``max_new`` tokens per stream after teacher-forced
        token-by-token prefill — the schedule of
        :func:`repro_torch.launch.serve.greedy_generate`.  ``prompts`` is
        (B, S) int; returns (B, S + max_new) int32."""
        prompts = np.asarray(prompts, np.int32)
        B, S = prompts.shape
        streams = [_Stream(f"stream-{b}", self.cfg, S + max_new,
                           prompts[b, 0]) for b in range(B)]
        toks = prompts[:, 0]
        for i in range(S + max_new - 1):
            nxt = self._step(streams, toks, step=i, generated=i + 1 >= S)
            toks = prompts[:, i + 1] if i + 1 < S else nxt
            for s, t in zip(streams, toks):
                s.tokens.append(int(t))
        return np.asarray([s.tokens for s in streams], np.int32)

    def report(self) -> dict:
        """Serving metrics over every step so far: tokens/sec and
        time-per-output-token over the *generation* steps (prefill and
        setup reported separately), plus the engine-side phase breakdown
        (summed :class:`StepRecord` buckets)."""
        gen = [s for s in self.steps if s.tokens]
        pre = [s for s in self.steps if not s.tokens]
        gen_wall = sum(s.wall_s for s in gen)
        new_tokens = sum(s.tokens for s in gen)
        pim_s = dict.fromkeys(PIM_GROUPS, 0.0)
        for s in self.steps:
            for k, v in s.pim_s.items():
                pim_s[k] += v
        return {
            "steps": len(self.steps),
            "new_tokens": new_tokens,
            "tokens_per_s": (new_tokens / gen_wall) if gen_wall else 0.0,
            "time_per_output_token_s": (gen_wall / new_tokens)
            if new_tokens else 0.0,
            "prefill_s": sum(s.wall_s for s in pre),
            "generate_s": gen_wall,
            "setup_s": self.setup_s,
            "host_s": sum(s.host_s for s in self.steps),
            "pim_s": pim_s,
        }

    def proj_seconds(self) -> dict[tuple[int, str], float]:
        """(layer, proj) -> summed telemetry service seconds, grouped from
        the tagged request rows — the telemetry-side view to reconcile with
        the engine-side :class:`StepRecord` buckets."""
        out: dict[tuple[int, str], float] = {}
        for rec in list(self.session.telemetry.records):
            proj = rec.tags.get("proj")
            if proj is None:
                continue
            key = (rec.tags.get("layer"), proj)
            out[key] = out.get(key, 0.0) + max(0.0, rec.t_finish
                                               - rec.t_start)
        return out

    def close(self) -> None:
        """Release the engine's session if it owns one (unpins and frees
        the resident weights); a shared session is left untouched."""
        if self._own and not self.session.closed:
            self.session.close()

    def __enter__(self) -> "DecodeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
