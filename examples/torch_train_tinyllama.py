"""End-to-end training on the port: a ~100M-parameter member of the
TinyLlama family trained for a few hundred steps on the card with the
production substrate — AdamW with warmup-cosine, deterministic seekable
data, atomic async checkpointing in the reference's tree layout,
straggler monitoring, and restart-on-relaunch (a run finds the latest
checkpoint in ``--ckpt-dir`` and resumes from it).  A checkpoint is saved
every 100 steps, and at the last step of a run of fewer.

    PYTHONPATH=src python examples/torch_train_tinyllama.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_tinyllama.py --steps 3 \
        --seq 64 --batch 2 --ckpt-dir DIR [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, Loader
from repro_torch.launch import train as train_mod
from repro_torch.runtime.straggler import StepMonitor


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_tinyllama_ckpt"))
    ap.add_argument("--device", default=None,
                    help="default cuda:0; cpu when asked")
    args = ap.parse_args()

    # ~100M-param member of the tinyllama family (full width, fewer layers)
    cfg = dataclasses.replace(
        get_config("tinyllama-1.1b"),
        n_layers=4, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
        vocab=32000, dtype=torch.float32, remat=False)
    print(f"model: {cfg.total_params()/1e6:.1f}M params")

    monitor = StepMonitor()
    ck = Checkpointer(args.ckpt_dir, keep=2, async_mode=True)
    loader = Loader(cfg, DataConfig(batch=args.batch, seq=args.seq))

    _, _, hist = train_mod.fit(
        cfg, steps=args.steps, data_loader=loader,
        ocfg=optim.AdamWConfig(lr=3e-4, warmup_steps=20,
                               total_steps=args.steps),
        checkpointer=ck, checkpoint_every=min(100, args.steps),
        monitor=monitor, log_every=20, device=args.device)
    if hist:
        print(f"\nloss: {hist[0]:.3f} → {hist[-1]:.3f} over {len(hist)} "
              f"steps")
    print(f"straggler flags: {monitor.flagged}")
    print(f"checkpoints: {ck.all_steps()} in {args.ckpt_dir} "
          "(re-run to resume from the latest)")


if __name__ == "__main__":
    main()
