"""PIM-offloaded decode serving on the port: session-resident weights,
per-token matvec offload, tokens/sec end to end (DESIGN.md §14).

Builds a small float32 decoder on the card, pins every layer's q/k/v/o
and MLP projection matrices on the banks once (``DecodeEngine``), then
drives continuous multi-stream greedy decode — each stream a tenant of
the session's scheduler — and checks that the generated tokens are
identical to ``launch.serve.greedy_generate`` on the same weights and
prompt.

    PYTHONPATH=src python examples/torch_serve_decode.py
    PYTHONPATH=src python examples/torch_serve_decode.py --banks 8 \
        --ranks 2 --streams 4 --max-new 24 [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import transformer
from repro_torch.pim.decode import DecodeEngine


def main(args):
    cfg = dataclasses.replace(get_config(args.model, smoke=True),
                              n_layers=args.layers, d_model=256, n_heads=8,
                              n_kv_heads=4, d_ff=512, vocab=256,
                              dtype=torch.float32, fast_decode=True)
    model = transformer.init(cfg, seed=0, device=args.device)
    B, S, max_new = args.streams, args.prompt_len, args.max_new
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)

    ref = serve_mod.greedy_generate(model, cfg, prompt,
                                    max_new=max_new).cpu().numpy()

    with DecodeEngine(model, cfg, banks=args.banks or None,
                      ranks=args.ranks or None, device=args.device) as eng:
        print(f"decode engine: {eng.session.n_banks} bank(s), "
              f"{eng.session.n_ranks} rank(s), {cfg.n_layers} layers, "
              f"{len(eng.pins)} pinned projections "
              f"(setup {eng.setup_s * 1e3:.0f} ms)")
        out = eng.generate(prompt, max_new)
        rep = eng.report()
        cs = eng.session.stats().get("cache", {})

    for b in range(B):
        print(f"  stream-{b}: {out[b].tolist()}")
    assert (out == ref).all(), "PIM decode diverged from greedy_generate"
    print(f"token-identical to greedy_generate across {B} stream(s)")
    print(f"{rep['new_tokens']} new tokens at {rep['tokens_per_s']:.1f} "
          f"tok/s ({rep['time_per_output_token_s'] * 1e3:.1f} ms/token); "
          f"prefill {rep['prefill_s']:.2f}s, "
          f"cache hits {cs.get('hits', 0)} / misses {cs.get('misses', 0)}")
    print("per-step PIM phases (s):",
          {k: round(v, 3) for k, v in rep["pim_s"].items()})


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tinyllama-1.1b",
                    help="arch id for the smoke config base")
    ap.add_argument("--banks", type=int, default=0,
                    help="banks of the engine's session (0 = one)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="rank count for rank-sharded matvecs (0 = flat)")
    ap.add_argument("--streams", type=int, default=4,
                    help="concurrent decode streams (one tenant each)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; cpu when asked")
    main(ap.parse_args())
