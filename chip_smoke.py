#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain PyTorch
version at the shapes its path gives it and times it, drives the suite's
banked path (all 16 PrIM workloads of the registry) at 2,048 banks and at
1 bank, checks every result against ``ref()``, shows that the suite went
through the kernels, and then drives the same workloads through the
session façade, ``repro_torch.pim.session(ranks=32, banks_per_rank=64)``:
``run`` of all 16, ``map``, ``pin`` with warm hits (GEMV, SpMV and MLP
scatter nothing; BS skips its broadcast but scatters its queries), a
two-tenant serving block and a trace export, and then a flat 2,048-bank
session, every result checked with the registry's comparator.  NW runs at
scale 32 and TRNS on 64 banks in the 2,048-bank leg (``suite_plan``).
Then the tune phase: the paper's characterization sweeps on the flat
2,048 banks (one line a sweep, the fitted stage models and CostModel, the
measured HBM rate beside the data sheet's), and ``pim.session(...)
.autotune`` on the suite's scale-1024 arguments — the 14 pipelineable
workloads (TRNS on 64 banks), the cost-model pre-filter on GEMV / RED /
SpMV, and the rank count over 32 ranks — each plan held to tuned >=
default and each served result to ``ref()``.  Then the LM
serving stack on TinyLlama 1.1B at its published width (seeded weights):
the prefill ``transformer.forward(use_kernel=True)`` through the
``flash_attention`` kernel, checked against the plain forward and timed,
teacher-forced ``decode_step`` against the prefill logits, and
``greedy_generate`` on the card against the ``DecodeEngine`` on a flat
session, token for token.  Then the MoE family on DeepSeek-MoE 16B at its
published width: float32 at 4 layers (kernel against plain forward, and
decode against prefill at a capacity factor that drops nothing), bfloat16
at all 28 layers (the prefill through ``moe_gmm`` and ``flash_attention``,
timed beside the plain forward, its dropped pairs and the top-k sets the
two forwards route differently) and ``greedy_generate``.  Then the hybrid
family on Jamba 1.5 Large at full width cut to 2 layers (one card holds
11.9 B of its 397.5 B parameters): the same legs, its prefill through
``ssd_scan``, ``moe_gmm`` and ``flash_attention`` in one forward.  Then
the VLM family on Llama 3.2 Vision 11B at its published width over
seeded frontend tokens (1,600 of them): float32 at 5 layers (kernel
against plain forward, decode against prefill through the cross layer's
cached frontend keys and values), bfloat16 at all 40 (32
``flash_attention`` launches a prefill) and ``greedy_generate(frontend=)``.
Last the xLSTM family on xlstm-125m, all 12 layers, no kernel (the
reference runs none there): each mLSTM layer's parallel form against its
chunked one, decode against prefill, the bfloat16 prefill timed, and
``greedy_generate``.  For the bfloat16 prefills of the MoE, hybrid, VLM
and xLSTM phases it prints a ``torch.profiler`` breakdown of one forward:
the top device operations and the device's busy share.  Then the train
phase: TinyLlama 1.1B FULL (bfloat16, remat) trained 8 steps at 4 x
2,048 tokens through ``launch.train.make_train_step`` (each step's loss,
gradient norm, learning rate, host ms and tokens/s, the peak memory, one
step profiled), the loss required to fall; the eval loss through
``flash_attention`` against the plain one, and the kernel's refusal
under grad; 2 steps at 2 microbatches; a float32 step of 2 layers on the
card against the CPU; and, in a child process with deterministic
algorithms (``--restart-child``), a run stopped at a checkpoint and
resumed, bit for bit against an uninterrupted one.  Last the dist phase:
expert and data parallelism over ``torch.distributed``, 4 ranks
(processes from ``launch.mesh.spawn``) on the one card over gloo with
CUDA tensors: DeepSeek-MoE 16B FULL with ``moe_ep`` on a (1, 4) mesh
(float32 at 4 layers against the one-process port, bfloat16 at 28
timed, with its all-reduces' host time and each rank's peak memory,
``flash_attention`` launched a layer a rank and ``moe_gmm`` never),
``greedy_generate`` on that mesh against one process's tokens, and
training on (4, 1) (TinyLlama at full width, 2 layers: float32
gradients against one process, a compressed step, ``fit`` restored onto
(2, 1) after ``simulate_failure``, bfloat16 steps) and on (2, 2)
(DeepSeek at 2 layers with ``moe_ep``); and tensor parallelism, every
"model" entry of the specs a shard: StableLM 2 12B FULL on (1, 4) (each
rank's 6.07 GB of bfloat16 weights equal to the byte to the reference's
specs on one device; float32 at 4 layers and greedy tokens against one
process; the 40-layer bfloat16 prefill timed), the Jamba cut with
``moe_ep`` on (1, 4) in float32 (``ssd_scan`` and ``flash_attention`` on
each rank's heads), and TinyLlama at 2 layers on (2, 2) (gradients
against one process, ``fit`` restored onto (1, 2)).  Leg A's DeepSeek
shards its attention, dense layer 0 and shared experts too; its float32
logits, and the Jamba cut's, are held to one process at every position,
with one process's top-k sets replayed into the ranks' routing (the
ranks' float32 sums run in another order and flip near-tied sets, which
the phase counts beside their largest probability margin).  Then the
rest of the reference's placement: G, DeepSeek-MoE 16B FULL as published
(``moe_ep`` off: its experts split over "model", 16 a rank through
``moe_gmm``) on (1, 4), each rank's 8.20 GB equal to the reference's
specs, as legs A and B; H, FSDP on (2, 2): DeepSeek with ``fsdp=True``
(float32 at 4 layers against one process at every position; one timed
bfloat16 prefill of 2 x 2,048 at 4 of its 28 layers, its parameters a
rank the reference's specs', with the FSDP gathers' counts and no
gathered leaf alive between layers) and the Jamba cut at
its published placement (5.95 GB a rank); I, TinyLlama at 2 layers with
``fsdp=True`` on (2, 2) (gradient parts, a quarter of the optimizer
state a rank, greedy tokens, ``fit`` restored onto (2, 1)).  Last leg J,
the sequence-sharded batch-1 cache: H2O-Danube3 4B at its published
width over a seeded cache of long_500k's 524,288 positions, each data
rank holding its block (float32 at 2 layers on (4, 1) and (2, 2), every
step of 16 greedy tokens against the one-process port on the whole cache
and each rank's bytes of keys and values against the reference's cache
specs; bfloat16 at 4 layers on (2, 2) timed, with the merges'
collectives and the peak memory a rank), beside the one process's
prefill of 1 x 8,192 through ``flash_attention``; and leg L, the
placements no published config reaches, at SMOKE width on (1, 4) in
float32: Mamba heads that the "model" axis cuts (each rank scans its own
columns of a head, ``ssd_scan`` at each rank's cut shape, held against
its plain version in float32 and bfloat16 and timed there) and
``parallel_block`` layers whose mixer is Mamba or cross attention, each
prefill of 1 x 2,048 against one process, greedy tokens, parameter
bytes the reference's specs'.  Last the split
phase, leg K: tensor parallelism inside a head, 16 ranks on the one card
in one launch: musicgen-medium at its published width on (1, 16), each
rank's 96 columns 1.5 heads, so it computes the 2 heads they touch
(float32 at 4 layers over seeded frame embeddings against one process,
greedy tokens, one ``flash_attention`` launch a layer a rank; bfloat16
at 12 layers timed, with the head gathers' collectives), and xlstm-125m
whole on (1, 16), a quarter of an mLSTM head a rank, and on (2, 8), half
a head with the batch over "data" (float32 against one process, greedy
tokens); each rank's parameter bytes the reference's specs', its cache's
bytes beside the specs'.  Last the dryrun phase: the port's dry-run
(``python3 -m repro_torch.launch.dryrun``: one rank of a cell of the
reference's (16, 16) or (2, 16, 16) mesh traced on the meta device over
a fake process group) on three cells, one process each, all at once —
TinyLlama at train_4k on (16, 16), DeepSeek-MoE 16B at prefill_32k on
(2, 16, 16) (the experts), H2O-Danube3 4B at long_500k on (16, 16) (the
sequence-sharded cache) — each record read back, its parameter bytes a
rank the reference's specs'; TinyLlama at train_4k and decode_32k with
``--opt tp1`` (the reference's specs without "model": parameters a rank
the stripped specs', the decode rank's keys and values 16 times the cache
specs') and at prefill_32k with ``--opt dp_all``, which must fail naming
the batch of 32 that 256 ranks do not split; beside them, each in a child
on the card over the same fake group with its weights uninitialised,
TinyLlama's train_4k rank 0 (leg b) and its tp1 decode_32k rank 0 (leg
b', a cell whose record fits 80 GB), their parameter, gradient,
optimizer-state and cache bytes the meta trace's to the byte, and
``torch.cuda.max_memory_allocated`` over the step beside the trace's
peak.  Last the examples phase, its processes started with the dry-run's:
``examples/torch_quickstart.py`` and ``torch_serve_decode.py`` on the
card as a user starts them, each to its closing check line (the other
three examples are checked on the CPU alone).

    python3 chip_smoke.py [--build | --only PHASE[,PHASE...]]

Needs one CUDA device and ``nvcc``; exits non-zero without them.  The
build prints each kernel's ``-Xptxas -v`` summary (registers, spills,
static shared memory); ``--build`` stops there, the first and short call
after a kernel changes.  ``--only kernels,hybrid`` runs those of PHASES
alone, e.g. to time a parent commit's kernels in the same call
(``--only tune`` makes the suite's arguments itself).  After each phase
a line gives the device memory still allocated.  The last
line is ``{"ok": true, "device": {...}}``; the line before it is the card's
name and power limit from ``nvidia-smi``, and the one before that a JSON
``{"kernels": [...]}`` with each kernel's launches in the tune phase
(``tune_launches``) and on its path (``launches``: the suite;
for flash_attention one TinyLlama prefill forward, and
``vision_launches`` one Llama 3.2 Vision forward, ``train_eval_launches``
the train phase's eval loss, for moe_gmm one
DeepSeek-MoE forward, for ssd_scan one forward of the Jamba cut; for
flash_attention and moe_gmm ``dist_launches_per_rank``, one rank's
expert-parallel prefill in the dist phase, for flash_attention and
ssd_scan ``tp_launches_per_rank``, one rank's StableLM prefill and one
rank's forward of the Jamba cut, and for moe_gmm one rank's prefill of
DeepSeek as published on (1, 4); for ssd_scan ``cut_launches_per_rank``,
one rank's leg L prefills; for flash_attention
``split_launches_per_rank``, one rank's bfloat16 musicgen prefill in leg
K), its error against its plain version, and its times beside its bound: ``ms``
(CUDA events around back-to-back calls of the wrapper) and ``device_ms``
(the device operations those calls launched, from ``torch.profiler``), the
same two for the library call, the CUDA launches of the port's kernels per
wrapper call, and for the short rows (reduce_sum at 2,048 banks and at 1
bank, gemv, scan at 1 bank, spmv_ell at 256 rows per bank,
flash_attention at TinyLlama's shape) min / median / max over REPEATS
measurements, each time over the repeats whose profile recorded it (their
count beside it).  gemv's row says whether it loses to ``torch.mv`` by
more than the two rows' spread, on the device times when VERDICT_MIN
repeats of both rows have them.
"""
import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: HBM3 bandwidth, and the float32 rate outside the
# tensor cores (the int32 adds of RED / SCAN / HST are counted at it too;
# the data sheet lists no int32 rate).  Every kernel here is far below the
# ridge point, so its bound is the bytes.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# ... and its dense bfloat16 tensor-core rate, the bound of attention's
# operations (the flash_attention rows are bfloat16)
BF16_TC_OPS_PER_S = 989e12

SUITE = ((2048, 1024), (1, 64))     # (banks, make_args scale)
# NW in every leg and phase: 2,048 bases a sequence, a 2,049^2 int32 score
# matrix in 127 block diagonals.  Its ref() is an O(m n) Python loop, and
# at scale 1024 the host's score matrix alone would be 17 GB.
NW_SCALE = 32
# TRNS in the 2,048-bank leg: make_args fixes N = 512, so N' = 64 rows of
# tiles, and the reference's assertion asks N' to divide across the banks
TRNS_BANKS = 64
TRNS_NP = 512 // 8
# the kernels' shapes on the suite's 2,048-bank run: RED / SCAN / HST hold
# 65536 * 1024 int32 values, 32,768 per bank; GEMV 256 rows of 256 per
# bank; SpMV 256 ELL rows of k = 8 per bank over an x of 256
BANKS, PER, ROWS, COLS = 2048, 32768, 256, 256
SPMV_K, SPMV_LARGE_ROWS = 8, 4096   # and a per-bank height past the L2
# the suite's 1-bank run: SCAN on 65536 * 64 values in one bank, the
# longest chain of tiles on the main path
SCAN_ONE_BANK = 65536 * SUITE[1][1]
TIMED_ITERS = 20
REPEATS = 5                         # measurements of each short row
VERDICT_MIN = 3                     # gemv's verdict on device times from
                                    # this many repeats of both rows
# the suite's 1-bank GEMV: 32,768 rows of 256 (make_args at scale 64)
GEMV_ONE_BANK_ROWS = 32768
# the session phase: the suite's 2,048 banks as 32 ranks of 64 DPUs
RANKS, BANKS_PER_RANK = 32, 64
TRACE = os.path.join(ROOT, "build", "repro_torch", "chip_smoke_trace.json")
# the LM phase: TinyLlama 1.1B (configs/tinyllama_1_1b.py:FULL) prefill of
# 2,048 tokens, and the H2O-Danube3 attention shape as a second kernel row
LM_ARCH, PREFILL = "tinyllama-1.1b", 2048
DANUBE = dict(H=32, KVH=8, S=8192, D=120, window=4096)
CONSIST = 32                        # teacher-forced decode tokens
DECODE_STREAMS, DECODE_PROMPT, DECODE_NEW = 2, 8, 8
DECODE_BANKS = 256                  # flat session: one rank, 8 GB budget
# the MoE phase: DeepSeek-MoE 16B (configs/deepseek_moe_16b.py:FULL); its
# float32 legs at 4 layers (the dense layer 0 and 3 MoE layers, ~9 GB: all
# 28 in float32 are 65.5 GB and leave no room for a plain forward)
MOE_ARCH, MOE_F32_LAYERS = "deepseek-moe-16b", 4
# the hybrid phase: Jamba 1.5 Large (configs/jamba_1_5_large_398b.py:FULL)
# at full width cut to 2 layers, attention + MoE and Mamba + dense: 11.9 B
# parameters (47.6 GB in float32, 23.8 GB in bfloat16) of its 397.5 B
HYBRID_ARCH, HYBRID_LAYERS = "jamba-1.5-large-398b", 2
# the VLM phase: Llama 3.2 Vision 11B (configs/llama_3_2_vision_11b.py:FULL)
# on seeded frontend tokens (B, 1,600, 4,096), the stub's patch embeddings;
# its float32 legs at 5 layers (4 self-attention, 1 cross: 2.14 B
# parameters, 8.6 GB), bfloat16 at all 40 (9.77 B, 19.5 GB)
VLM_ARCH, VLM_F32_LAYERS = "llama-3.2-vision-11b", 5
# the xLSTM phase: xlstm-125m (configs/xlstm_125m.py:FULL) at all 12 layers,
# the chunked mLSTM at the reference's default chunk of 256.  Each mLSTM
# layer's parallel and chunked forms agree within the reference's 1e-4
# (tests/test_kernels.py, 64 positions) scaled by the 2,048 / 64 times as
# many terms in each float32 sum; through 12 layers the stack moves
# further (PERF.md), so the stack's gap is printed and the model held to
# decode against prefill
XLSTM_ARCH, MLSTM_CHUNK = "xlstm-125m", 256
MLSTM_TOL = 1e-4 * PREFILL / 64
BIG_ITERS = 3                       # timed launches of the largest rows
# the tune phase: characterization on the flat 2,048 banks, then the
# autotuner on the suite's scale-1024 arguments: 13 workloads on a flat
# 2,048-bank session, TRNS on 64 banks (its N' = 64), the constructor's
# autotune= on 64 banks at scale 64, a cost-model leg and a ranked leg
TUNE_SCALE, TUNE_REPS = 1024, 2
COST_TUNE = ("GEMV", "RED", "SpMV")
RANK_TUNE = ("GEMV", "RED", "SpMV")
# stream_wram and rank_parallel_sweep at sizes past the card's 50 MB L2
# (the reference's defaults, 4 MB, would time the L2)
STREAM_N = 1 << 28                  # int32 elements: 1 GiB an array
RANK_SWEEP_BYTES = 1 << 28
TRANSFER_MB_PER_BANK = 1            # transfer_sweep: 2 GiB over 2,048 banks
# the train phase: TinyLlama 1.1B FULL (bfloat16, remat) trained TRAIN_STEPS
# steps on make_batch(cfg, DataConfig(seed=0, batch, seq), step) at AdamW
# warmup 2 to TRAIN_LR, TinyLlama's published peak (arXiv 2401.02385; at
# 1e-3 the loss climbs to 16 by step 4, in the reference as in the port:
# PERF.md, PR 22); the mean of the last 3 losses must lie TRAIN_MARGIN
# below the first 3's (at SMOKE size the same 8 steps fall by 1.06-1.52,
# tests/test_torch_chip_smoke.py); then MICRO_STEPS steps at 2 microbatches
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MARGIN = 8, 4, 2048, 0.5
TRAIN_LR = 4e-4
MICRO_STEPS = 2
# its eval leg: loss_fn through flash_attention against the plain loss, in
# bfloat16, at the reference's bf16 rtol = atol = 2e-2 (tests/test_models.py)
EVAL_TOL = 2e-2
# its float32 leg, the card against the CPU: TinyLlama's width at 2 layers,
# batch 1 x F32_SEQ; the loss at 1e-4, each gradient leaf at GRAD_TOL of its
# largest |g|; AdamW's update on identical gradients at rtol = atol = 1e-6;
# the chunked CE (8 chunks) against the whole logits at rtol = atol = 1e-5
F32_LAYERS, F32_SEQ, GRAD_TOL, LOSS_CHUNKS = 2, 256, 1e-3, 8
# its restart leg, in a child process with deterministic algorithms: 1
# layer, float32, batch 1 x RESTART_SEQ, RESTART_STEPS uninterrupted against
# half of them, a checkpoint, and the rest resumed
RESTART_SEQ, RESTART_STEPS = 512, 4
# the dist phase: DIST_WORLD ranks on the one card over DIST_BACKEND with
# CUDA tensors (NCCL refuses two ranks a device; tests/test_torch_gpu.py
# runs NCCL where there are 2 cards).  Leg B: greedy tokens, 2 x
# (DIST_PROMPT + DIST_NEW); leg C: TinyLlama FULL cut to DIST_TRAIN_LAYERS,
# float32 at 4 x DIST_F32_SEQ (one row a rank) for DIST_STEPS steps, bfloat16
# at 4 x TRAIN_SEQ; DeepSeek FULL cut to 2 layers with moe_ep at 2 x
# DIST_EP_SEQ on (2, 2), its losses against one process at DIST_EP_TOL
# (1 + |loss|), the reference's bfloat16 tolerance (tests/test_models.py):
# one process's aux is the whole batch's, the mesh's the mean of the data
# shards' (the reference's apply_ep)
DIST_WORLD, DIST_BACKEND = 4, "gloo"
# (DIST_STEPS 3, not 4: the script's time, ~4 s a step of leg C's, F's
# and I's fits, whose collectives go through the host; with 3 the fits
# restart after 1 step and the resumed run's 2nd loss follows an update
# made with the restored optimizer state)
DIST_PROMPT, DIST_NEW = 16, 16
DIST_TRAIN_LAYERS, DIST_F32_SEQ, DIST_STEPS = 2, 256, 3
DIST_EP_SEQ, DIST_EP_TOL = 512, 2e-2
# its tensor-parallel legs on a (1, DIST_WORLD) mesh: D, StableLM 2 12B
# (configs/stablelm_12b.py:FULL: 12.14 B parameters, 24.3 GB in bfloat16,
# so four whole replicas would not fit the card) in float32 at
# TP_F32_LAYERS, prefill 1 x TP_F32_SEQ, against one process at 1e-3, and
# in bfloat16 at all 40 layers, prefill 1 x PREFILL, timed; E, the Jamba
# cut (HYBRID_LAYERS at full width) with moe_ep in float32 at 1 x
# TP_F32_SEQ, against one process at the hybrid phase's 5e-3; F,
# TinyLlama at DIST_TRAIN_LAYERS on (2, 2)
TP_ARCH, TP_F32_LAYERS, TP_F32_SEQ = "stablelm-12b", 4, 512
# its legs of the rest of the reference's placement: G, DeepSeek-MoE 16B
# FULL as published (moe_ep off) on (1, DIST_WORLD), as legs A and B; H,
# FSDP on (2, 2): DeepSeek with fsdp=True in float32 at MOE_F32_LAYERS, 2 x
# DIST_FSDP_SEQ (a row a data rank), against one process at 1e-3, and in
# bfloat16 at FSDP_BF16_LAYERS of its 28 layers (the script's time: ~1 s
# a layer, nearly all gloo's gathers), 2 x PREFILL, one timed prefill
# (over gloo each rank moves its model block of every leaf through the
# host); the Jamba cut at its published placement (fsdp=True) in
# bfloat16, 2 x DIST_FSDP_SEQ; I, TinyLlama at DIST_TRAIN_LAYERS with
# fsdp=True on (2, 2)
DIST_FSDP_SEQ, FSDP_BF16_LAYERS = 512, 4
# its leg of the sequence-sharded decode cache: J, H2O-Danube3 4B at its
# published width, a batch-1 cache of long_500k's SEQ_MAX_LEN positions
# seeded a slab of SEQ_SLAB positions at a time, SEQ_NEW greedy tokens
# decoded from position SEQ_START (the window of 4,096 straddles a block
# boundary on (4, 1) and on (2, 2)): float32 at SEQ_F32_LAYERS on (4, 1)
# and (2, 2), every step's logits against the one-process port on the
# whole cache at 1e-3; bfloat16 at SEQ_BF16_LAYERS on (2, 2), timed; the
# one process also prefills 1 x SEQ_PREFILL through flash_attention
SEQ_ARCH, SEQ_MAX_LEN, SEQ_START, SEQ_NEW = ("h2o-danube-3-4b", 524288,
                                             263144, 16)
# (SEQ_BF16_LAYERS of its 24 layers: the time the whole run's phases have)
SEQ_F32_LAYERS, SEQ_BF16_LAYERS, SEQ_SLAB, SEQ_PREFILL = 2, 4, 4096, 8192
SEQ_SEED = 17
# its leg of the placements no published config reaches, L: Mamba heads
# that a "model" axis cuts and parallel_block layers whose mixer is not
# self-attention, on (1, DIST_WORLD) in float32 through the kernels: a
# prefill of 1 x PREFILL (the scan's 16 chunks of 128) against one process
# at every position, at the hybrid phase's 5e-3 for Jamba (its ranks routed
# to one process's top-k sets) and 1e-3 for Llama 3.2 Vision, and greedy 2
# x (DIST_PROMPT + CUT_NEW) tokens (4, not DIST_NEW's 16: the leg's time,
# ~0.5 s a Jamba step of ~45 gloo collectives); the ssd_scan kernel
# against its plain version at each rank's cut shape (1, PREFILL, heads,
# w) in float32 and bfloat16, timed there.  SMOKE configs, since no
# published width reaches these placements: Jamba's di of 16,384 is 256
# heads of 64, which every power-of-two "model" axis up to 256 divides (a
# cut on 4 ranks needs heads wider than a rank's 4,096 columns, P =
# 8,192), and no config sets parallel_block beside another mixer.  (a)
# heads of 64, 2 heads: half a head a rank; (b) ssm_expand 3, 3 heads of
# 64: 48 columns a rank, 16 + 32 in two heads on ranks 1 and 2 (the
# zero-padded layout); (c) no experts, parallel_block: attention and
# Mamba layers; (d) parallel_block: the cross layer too
CUT_CASES = {"a": ("jamba-1.5-large-398b", dict(ssm_head_dim=64)),
             "b": ("jamba-1.5-large-398b", dict(ssm_expand=3,
                                                ssm_head_dim=64)),
             "c": ("jamba-1.5-large-398b", dict(moe_experts=0,
                                                parallel_block=True)),
             "d": ("llama-3.2-vision-11b", dict(parallel_block=True))}
CUT_SEED, CUT_NEW = 23, 4
# the split phase, leg K: tensor parallelism inside a head, SPLIT_WORLD
# ranks on the one card over DIST_BACKEND with CUDA tensors, one launch:
# musicgen-medium FULL (24 heads of 64: 1.5 heads, 2 touched, a rank) on
# (1, 16), float32 at SPLIT_F32_LAYERS over seeded frame embeddings of 1 x
# PREFILL against one process at 1e-3 and SPLIT_NEW greedy steps from a
# prompt of SPLIT_PROMPT tokens (every step a collective of 16 processes
# through the host, ~0.1 s each), equal tokens; bfloat16 at
# SPLIT_BF16_LAYERS (of 48: the leg's time) timed; xlstm-125m FULL (12
# layers, 4 mLSTM heads of 192) on (1, 16), a quarter of a head a rank,
# and on (2, 8), half a head, the batch over "data": float32 prefill of 2
# x SPLIT_XLSTM_SEQ against one process at 1e-3, SPLIT_NEW greedy steps
SPLIT_WORLD, SPLIT_ARCH = 16, "musicgen-medium"
SPLIT_F32_LAYERS, SPLIT_BF16_LAYERS = 4, 12
SPLIT_XLSTM_SEQ, SPLIT_PROMPT, SPLIT_NEW, SPLIT_SEED = 512, 1, 8, 19
# the dryrun phase: the port's dry-run (src/repro_torch/launch/dryrun.py,
# one rank of a cell traced on the meta device over a fake process group)
# on DRYRUN_CELLS, one CLI process a cell (leg a); the reference's spec
# lever tp1 on DRYRUN_TP1 (leg a'), and dp_all on DRYRUN_REFUSED, whose
# prefill batch of 32 does not split over 256 ranks (the CLI must fail and
# say so); and beside them, each in a child over the same fake group with
# its weights uninitialised (``--dryrun-child``), the first cell's rank 0
# on the card (leg b) and the tp1 decode cell's (leg b', a cell whose
# record fits 80 GB): eight processes started together
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k", "single"),
                ("deepseek-moe-16b", "prefill_32k", "multi"),
                ("h2o-danube-3-4b", "long_500k", "single"))
DRYRUN_TP1 = (("tinyllama-1.1b", "train_4k", "single"),
              ("tinyllama-1.1b", "decode_32k", "single"))
DRYRUN_REFUSED = ("tinyllama-1.1b", "prefill_32k", "single")
#: leg -> (cell, opt flags) of the children on the card
DRYRUN_CHILDREN = {"b": (DRYRUN_CELLS[0], ()),
                   "b'": (DRYRUN_TP1[1], ("tp1",))}
DRYRUN_MESHES = {"single": {"data": 16, "model": 16},
                 "multi": {"pod": 2, "data": 16, "model": 16}}
# the examples phase: two of the port's user scripts (examples/torch_*.py,
# the reference's examples/*.py) on the card at their own arguments, each
# a process of its own started as a user starts it, together with the
# dryrun phase's processes: name -> its closing check line.  The other
# three (serve_prim, prim_suite, train_tinyllama) are checked on the CPU
# alone (tests/test_torch_examples.py): no cut that keeps every gate was
# found to pay for their seconds here (PERF.md §6)
EXAMPLES = {
    "torch_quickstart": "all results match the gold references.",
    "torch_serve_decode": "token-identical to greedy_generate across 4 "
                          "stream(s)",
}
# the phases, in order; ``--only a,b`` runs those alone (the session phase
# needs the suite's arguments; the tune phase makes them itself when the
# suite did not run)
PHASES = ("kernels", "suite", "session", "tune", "lm", "moe", "hybrid",
          "vlm", "xlstm", "train", "dist", "split", "dryrun", "examples")
# a forward's device time spent in each kernel of the port: the part of the
# CUDA kernels' names that marks them
SHARES = {"flash_attention": "flash_", "moe_gmm": "gmm_", "ssd_scan": "ssd_"}


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name cut to its own name and template numbers:
    ``flash_bf16_k<64,128>``."""
    i = mangled.find("_ZN")
    if i < 0:
        return mangled
    i, parts = i + 3, []
    while i < len(mangled) and mangled[i].isdigit():   # <length><name> ...
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    if not parts:
        return mangled
    args = (re.findall(r"Li(\d+)E", mangled[i:mangled.find("EE", i) + 2])
            if mangled[i:i + 1] == "I" else [])
    return parts[-1] + (f"<{','.join(args)}>" if args else "")


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel of the compilers' ``-Xptxas -v`` output: the
    source, the kernel (its mangled name cut to the base name and template
    numbers), its registers, spills and shared memory, and any
    performance note ptxas gave."""
    out, name = [], "?"
    for line in log.splitlines():
        if line.startswith("=="):
            out.append(line.strip())
        elif "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
        elif "bytes stack frame" in line:
            spill = line.strip()
        elif "Used" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
        elif "Potential Performance Loss" in line or "warning" in line:
            out.append(line.strip())
    return out


def cuda_ms(fn, iters: int = TIMED_ITERS) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls between two
    CUDA events, after warm-up: the device's time when the device is the
    slower side, the host's when each call's host work is longer."""
    for _ in range(min(3, iters)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ops(prof) -> list[tuple[float, int, str]]:
    """(device ms, count, name) of each device operation (kernel, memset,
    copy) in a profile: operations that ran on the device only, never the
    host operations that launched them, whose self device time would count
    the same work twice."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((us / 1e3, e.count, e.key))
    return rows


def device_ms(fn, iters: int = TIMED_ITERS,
              ops_seen: list | None = None) -> float | None:
    """Device time of one call of ``fn``: the sum of the device time of
    every device operation that ``iters`` calls launched, under
    ``torch.profiler``, over ``iters``, after a warm-up call.  Every call
    launches the same operations, so each count is a multiple of
    ``iters``; a profile where one is not has lost records (an H100 run
    without this check read a row below its bound), and one that records
    no device time at all has lost every record: either is taken again, up
    to 3 attempts, each printed.  None when no attempt gives a whole
    profile: a lossy one reads low, so its time is left out.  ``ops_seen``
    receives the operations of the whole profile (``device_ops``) and is
    left as it was when there is none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            rows = device_ops(prof)
        lost = [(n, name) for _, n, name in rows if n % iters]
        if rows and not lost:
            if ops_seen is not None:
                ops_seen[:] = rows
            return sum(r[0] for r in rows) / iters
        print("    profiler: " + (f"counts {lost} are no multiple of {iters} "
                                  f"calls" if rows else "no device time "
                                  "recorded") + f" (attempt {attempt + 1})")
    print("    profiler: no whole profile in 3 attempts: device time left out")
    return None


def own_launches(ops_seen: list, iters: int) -> float | None:
    """Launches of the port's own kernels per call in a ``device_ms``
    profile of ``iters`` calls: every device operation but PyTorch's
    (``at::``: the fills of ``torch.zeros``) and memsets or copies."""
    if not ops_seen:
        return None
    own = sum(n for _, n, name in ops_seen if "at::" not in name
              and not name.startswith(("Memset", "Memcpy")))
    return own / iters


def bound(nbytes: int, nops: int,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check(name: str, got: torch.Tensor, want: torch.Tensor, allowed) -> float:
    """Max |got - want| in float32; every element must be within
    ``allowed`` of ``want`` (0: exact)."""
    assert got.shape == want.shape and got.dtype == want.dtype, (
        name, got.shape, want.shape, got.dtype, want.dtype)
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all(), name
    err = (g - w).abs()
    worst = float(err.max())
    assert bool((err <= allowed).all()), (
        f"{name}: max abs error {worst} over what is allowed")
    print(f"  check {name:28s} max_abs_err={worst:.3e}")
    return worst


def rel(want: torch.Tensor, tol: float) -> torch.Tensor:
    """tol * (1 + |want|): rtol = atol = tol."""
    return tol * (1 + want.float().abs())


def random_ell(banks: int, rows: int, k: int, n: int, g, dev):
    """Seeded ELL on the device (``csr_to_ell``'s Python loop is too slow
    for millions of rows): row r keeps ``count[r] ~ U{0..k}`` distinct
    sorted columns, ``cols = -1`` and ``vals = 0`` in the padded slots.
    Columns are ``(base + j * step) % n`` with an odd step and a
    power-of-two n, so the k of a row are distinct.  Returns vals, cols
    (banks, rows, k) and the (rows, k) mask of stored entries."""
    r = banks * rows
    count = torch.randint(0, k + 1, (r, 1), generator=g, device=dev)
    base = torch.randint(0, n, (r, 1), generator=g, device=dev)
    step = torch.randint(0, n // 2, (r, 1), generator=g, device=dev) * 2 + 1
    cols = ((base + step * torch.arange(k, device=dev)) % n).sort(1).values
    keep = torch.arange(k, device=dev) < count
    vals = torch.randn((r, k), generator=g, device=dev)
    vals = torch.where(keep, vals, 0.0)
    cols = torch.where(keep, cols, -1).to(torch.int32)
    return vals.view(banks, rows, k), cols.view(banks, rows, k), keep


def spmv_case(name: str, rows: int, n: int, g, dev, tol=1e-4,
              repeats: int = 1) -> dict:
    """One timed spmv_ell case at (2048, rows, k): the kernel, its plain
    version, and cuSPARSE's CSR product over the same stored entries
    (built outside the timed window).  Bytes: all of cols, the stored
    vals, x, y; operations: 2 per stored entry.  ``read_once``: vals and
    cols each read once by ``torch.sum``, the device time any ELL kernel
    that reads both whole would need."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import spmv as kspmv

    vals, cols, keep = random_ell(BANKS, rows, SPMV_K, n, g, dev)
    x = torch.randn(n, generator=g, device=dev)
    nnz = int(keep.sum())
    crow = torch.zeros(BANKS * rows + 1, dtype=torch.int32, device=dev)
    crow[1:] = keep.sum(1).cumsum(0)
    with warnings.catch_warnings():       # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        csr = torch.sparse_csr_tensor(crow, cols.view(-1, SPMV_K)[keep],
                                      vals.view(-1, SPMV_K)[keep],
                                      size=(BANKS * rows, n))
        csr @ x
    flat = lambda t: t.view(-1, SPMV_K)  # noqa: E731
    return dict(
        name=name, source="src/repro_torch/csrc/spmv.cu",
        replaces="src/repro/kernels/spmv.py:19",
        kernel=lambda: ops.spmv_ell(vals, cols, x),
        plain=lambda: kspmv.plain(flat(vals), flat(cols), x).view(BANKS, rows),
        library=lambda: csr @ x,
        nbytes=cols.nbytes + nnz * 4 + x.nbytes + BANKS * rows * 4,
        nops=2 * nnz, tol=tol, repeats=repeats,
        read_once=lambda: (torch.sum(cols, dtype=torch.int32),
                           torch.sum(vals)))


def kernel_phase(dev) -> list[dict]:
    """Each kernel at the suite's 2,048-bank shapes: the error against its
    plain version on the same inputs, and its times.  reduce_sum, gemv and
    scan_inclusive are also timed at the suite's 1-bank shape, spmv_ell at
    4,096 rows per bank, whose bytes leave the L2."""
    from repro_torch.kernels import gemv as kgemv
    from repro_torch.kernels import histogram as khist
    from repro_torch.kernels import ops
    from repro_torch.kernels import reduce as kred
    from repro_torch.kernels import scan as kscan
    from repro_torch.kernels import spmv as kspmv

    g = torch.Generator(device=dev).manual_seed(0)
    banks, per, nbins, block = BANKS, PER, 256, 4096
    x = torch.randint(0, 99, (banks, per), generator=g, device=dev,
                      dtype=torch.int32)
    xs = torch.randint(0, 9, (banks, per), generator=g, device=dev,
                       dtype=torch.int32)
    px = torch.randint(0, nbins, (banks, per), generator=g, device=dev,
                       dtype=torch.int32)
    a = torch.randn((banks, ROWS, COLS), generator=g, device=dev)
    v = torch.randn(COLS, generator=g, device=dev)
    bank_off = (torch.arange(banks, device=dev, dtype=torch.int32)
                * nbins)[:, None]

    # Float and edge-case checks, not timed.  Float tolerances: the kernel
    # adds in another order than the plain version, and a float32 sum's
    # rounding error scales with the magnitudes added, so sums and prefix
    # sums may differ by 1e-6 (about 16 float32 epsilons) times the sum of
    # |x| over the same prefix; GEMV float32 by the registry's rtol = atol =
    # 1e-4; bfloat16 GEMV, compared in float32, by 2e-2, one output
    # rounding step being 2^-8 of the value.
    xf = torch.randn((banks, per), generator=g, device=dev)
    first = ops.reduce_sum(xf)
    check("reduce_sum f32", first, kred.plain(xf, block),
          1e-6 * xf.abs().sum(-1))
    assert all(torch.equal(ops.reduce_sum(xf), first) for _ in range(2)), (
        "reduce_sum f32 differs between calls")
    print("  check reduce_sum f32 3 calls          bit for bit equal")
    check("scan_inclusive f32", ops.scan_inclusive(xf),
          kscan.plain(xf, block), 1e-6 * xf.abs().cumsum(-1))
    check("scan_exclusive f32", ops.scan_exclusive(xf),
          kscan.plain(xf, block) - xf, 1e-6 * xf.abs().cumsum(-1))
    x1f = torch.randn((1, SCAN_ONE_BANK), generator=g, device=dev)
    check("scan_inclusive f32 1 bank", ops.scan_inclusive(x1f),
          kscan.plain(x1f, block), 1e-6 * x1f.abs().cumsum(-1))
    del x1f
    pw = torch.randint(-8, nbins + 8, (banks, per), generator=g, device=dev,
                       dtype=torch.int32)
    check("histogram clipped", ops.histogram(pw, nbins),
          khist.plain(pw, nbins, block), 0)
    ab, vb = a.to(torch.bfloat16), v.to(torch.bfloat16)
    want = kgemv.plain(ab.reshape(-1, COLS), vb).reshape(banks, ROWS)
    check("gemv bf16", ops.gemv(ab, vb), want, rel(want, 2e-2))
    ragged = x[:7, :1000].contiguous()
    check("reduce_sum ragged", ops.reduce_sum(ragged),
          ragged.sum(-1, dtype=torch.int32), 0)
    check("scan_inclusive ragged", ops.scan_inclusive(ragged),
          ragged.cumsum(-1, dtype=torch.int32), 0)
    wrap = torch.full((1, 4096), 1 << 20, device=dev, dtype=torch.int32)
    check("reduce_sum int32 wrap", ops.reduce_sum(wrap),
          kred.plain(wrap, block), 0)
    # spmv_ell: float32 at rtol = atol = 1e-4 (another order of adds, and
    # the kernel fuses multiply and add); bfloat16 compared in float32 at
    # 2e-2 like GEMV.  The ragged case has rows that are no multiple of the
    # row block, k = 5 (no vector loads), columns at and past n (which read
    # x[n-1]) and inf in padded slots (skipped, so the result is finite).
    sv, sc, _ = random_ell(BANKS, ROWS, SPMV_K, COLS, g, dev)
    sx = torch.randn(COLS, generator=g, device=dev)
    want = kspmv.plain(sv.view(-1, SPMV_K), sc.view(-1, SPMV_K),
                       sx).view(BANKS, ROWS)
    check("spmv_ell f32", ops.spmv_ell(sv, sc, sx), want, rel(want, 1e-4))
    sb = sv.to(torch.bfloat16)
    want = kspmv.plain(sb.view(-1, SPMV_K), sc.view(-1, SPMV_K),
                       sx).view(BANKS, ROWS)
    check("spmv_ell bf16", ops.spmv_ell(sb, sc, sx), want, rel(want, 2e-2))
    rc = torch.randint(-1, COLS + 4, (3, 1000, 5), generator=g, device=dev,
                       dtype=torch.int32)
    rv = torch.randn((3, 1000, 5), generator=g, device=dev)
    rv = torch.where(rc < 0, float("inf"), rv)
    want = kspmv.plain(rv.view(-1, 5), rc.view(-1, 5), sx).view(3, 1000)
    check("spmv_ell ragged, cols>=n, inf pad", ops.spmv_ell(rv, rc, sx),
          want, rel(want, 1e-4))

    cases = [
        dict(name="reduce_sum", source="src/repro_torch/csrc/reduce.cu",
             replaces="src/repro/kernels/reduce.py:20",
             kernel=lambda: ops.reduce_sum(x),
             plain=lambda: kred.plain(x, block),
             library=lambda: torch.sum(x, dim=-1, dtype=torch.int32),
             nbytes=x.nbytes + banks * 4, nops=x.numel(), tol=0,
             repeats=REPEATS),
        dict(name="scan_inclusive", source="src/repro_torch/csrc/scan.cu",
             replaces="src/repro/kernels/scan.py:20",
             kernel=lambda: ops.scan_inclusive(xs),
             plain=lambda: kscan.plain(xs, block),
             library=lambda: torch.cumsum(xs, dim=-1, dtype=torch.int32),
             nbytes=2 * xs.nbytes, nops=xs.numel(), tol=0),
        dict(name="histogram", source="src/repro_torch/csrc/histogram.cu",
             replaces="src/repro/kernels/histogram.py:20",
             kernel=lambda: ops.histogram(px, nbins),
             plain=lambda: khist.plain(px, nbins, block),
             library=lambda: torch.bincount(
                 (px.clamp(0, nbins - 1) + bank_off).view(-1),
                 minlength=banks * nbins),
             nbytes=px.nbytes + banks * nbins * 4, nops=px.numel(), tol=0),
        dict(name="gemv", source="src/repro_torch/csrc/gemv.cu",
             replaces="src/repro/kernels/gemv.py:20",
             kernel=lambda: ops.gemv(a, v),
             plain=lambda: kgemv.plain(a.view(-1, COLS), v).view(banks, ROWS),
             library=lambda: torch.mv(a.view(-1, COLS), v),
             nbytes=a.nbytes + v.nbytes + banks * ROWS * 4,
             nops=2 * a.numel(), tol=1e-4, repeats=REPEATS,
             read_once=lambda: torch.sum(a)),
        spmv_case("spmv_ell", ROWS, COLS, g, dev, repeats=REPEATS),
    ]
    rows = [timed(c) for c in cases]
    # reduce_sum at the suite's 1-bank shape, beside torch.sum
    x1 = torch.randint(0, 99, (1, SCAN_ONE_BANK), generator=g, device=dev,
                       dtype=torch.int32)
    rows[0]["at_1_bank_4194304"] = dict_of(timed(dict(
        cases[0], kernel=lambda: ops.reduce_sum(x1),
        plain=lambda: kred.plain(x1, block),
        library=lambda: torch.sum(x1, dim=-1, dtype=torch.int32),
        nbytes=x1.nbytes + 4, nops=x1.numel())))
    del x1
    # gemv at the suite's 1-bank shape, beside torch.mv
    a1 = torch.randn((1, GEMV_ONE_BANK_ROWS, COLS), generator=g, device=dev)
    gemv = next(r for r in rows if r["name"] == "gemv")
    gemv["at_1_bank_32768_rows"] = dict_of(timed(dict(
        cases[3], kernel=lambda: ops.gemv(a1, v),
        plain=lambda: kgemv.plain(a1.view(-1, COLS), v).view(1, -1),
        library=lambda: torch.mv(a1.view(-1, COLS), v),
        nbytes=a1.nbytes + v.nbytes + GEMV_ONE_BANK_ROWS * 4,
        nops=2 * a1.numel(), read_once=lambda: torch.sum(a1))))
    gemv["at_1_bank_32768_rows"]["note"] = (
        "A's 33.5 MB fit the 50 MB L2, so back-to-back calls may run under "
        "the HBM bound: the share of the bound is not read")
    del a1
    gemv_verdict(gemv)
    # scan_inclusive at the suite's 1-bank shape, and the exclusive scan
    # the suite calls (ops.scan_exclusive) at 2,048 banks; both ride in the
    # scan_inclusive row
    x1 = torch.randint(0, 9, (1, SCAN_ONE_BANK), generator=g, device=dev,
                       dtype=torch.int32)
    scan = next(r for r in rows if r["name"] == "scan_inclusive")
    scan["at_1_bank_4194304"] = dict_of(timed(dict(
        cases[1], kernel=lambda: ops.scan_inclusive(x1),
        plain=lambda: kscan.plain(x1, block),
        library=lambda: torch.cumsum(x1, dim=-1, dtype=torch.int32),
        nbytes=2 * x1.nbytes, nops=x1.numel(), repeats=REPEATS)))
    scan["exclusive_at_2048_banks"] = dict_of(timed(dict(
        cases[1], kernel=lambda: ops.scan_exclusive(xs),
        plain=lambda: kscan.plain(xs, block) - xs,
        library=lambda: torch.cumsum(xs, dim=-1, dtype=torch.int32) - xs)))
    del x1
    # the same kernel at 4,096 rows per bank, past the 50 MB L2; its numbers
    # ride in the spmv_ell row
    large = timed(spmv_case("spmv_ell", SPMV_LARGE_ROWS, COLS, g, dev))
    rows[-1][f"at_{SPMV_LARGE_ROWS}_rows_per_bank"] = dict_of(large)
    rows.append(flash_rows(g, dev))
    rows.append(gmm_rows(g, dev))
    rows.append(ssd_rows(g, dev))
    return rows


def gemv_verdict(row: dict) -> None:
    """Whether gemv loses to torch.mv by more than the two rows' spread
    (max - min over REPEATS measurements), on the device times when at
    least VERDICT_MIN of the repeats of both rows have them, else on the
    event times; kept in the row with the times it used."""
    sp = row["spread"]
    k, lib = (("device_ms", "library_device_ms")
              if min(row["device_ms_n"], row["library_device_ms_n"])
              >= VERDICT_MIN else ("ms", "library_ms"))
    gap = sp[k][1] - sp[lib][1]
    spread = (sp[k][2] - sp[k][0]) + (sp[lib][2] - sp[lib][0])
    row["verdict"] = (
        "slower than torch.mv beyond the spread: first for the next redesign"
        if gap > spread else
        "no slower than torch.mv within spread; left alone (rule 2)")
    row["verdict_on"] = (f"{k} ({row.get(k + '_n', REPEATS)} of {REPEATS} "
                         f"repeats), {lib} ({row.get(lib + '_n', REPEATS)} of "
                         f"{REPEATS})")
    print(f"  gemv vs torch.mv ({row['verdict_on']}): median gap {gap:.4f} "
          f"ms, spread {spread:.4f} ms: {row['verdict']}")


def dict_of(row: dict) -> dict:
    """A row's numbers, to ride in another row of the same kernel."""
    return {k: row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "library_device_ms", "device_ms_n",
                                "library_device_ms_n", "read_once_device_ms",
                                "cuda_launches_per_call", "spread")
            if k in row}


def live_pairs(S: int, T: int, window) -> int:
    """(q, k) pairs a causal mask leaves live: query i at i + (T - S) sees
    keys in (qpos - window, qpos] within [0, T)."""
    qpos = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(T - 1, qpos)
    lo = np.maximum(0, qpos - window + 1) if window is not None else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_case(name: str, B, H, KVH, S, T, D, window, g, dev) -> dict:
    """One timed flash_attention case in bfloat16, causal: the kernel, its
    plain version, and ``scaled_dot_product_attention`` (``is_causal`` at
    S = T, an explicit boolean mask for the window).  Operations: 4 D per
    live (q, k) pair and head; bytes: q, k, v and o once.  Tolerance
    4e-3 * (1 + |o|): the kernel rounds P once to bfloat16 before the P V
    product (in float32's 24 bits, as three bfloat16 terms, on the tiles
    that cross the diagonal, the window edge or T, which hold every key of
    the rows that see few keys), and both round a float32 output to
    bfloat16, so an output may land one bfloat16 step (2^-8 |o|) away, and
    no further."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops

    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((B, H, S, D), (B, KVH, T, D), (B, KVH, T, D)))
    if window is None:
        lib = functools.partial(F.scaled_dot_product_attention, q, k, v,
                                is_causal=True, enable_gqa=True)
    else:
        qpos = torch.arange(S, device=dev)[:, None] + (T - S)
        kpos = torch.arange(T, device=dev)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        lib = functools.partial(F.scaled_dot_product_attention, q, k, v,
                                attn_mask=mask, enable_gqa=True)
    return dict(
        name=name, source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:27",
        kernel=lambda: ops.attention(q, k, v, causal=True, window=window),
        plain=lambda: kfa.plain(q, k, v, causal=True, window=window),
        library=lib, nbytes=2 * q.nbytes + k.nbytes + v.nbytes,
        nops=4 * B * H * D * live_pairs(S, T, window),
        ops_per_s=BF16_TC_OPS_PER_S, tol=4e-3)


def flash_rows(g, dev) -> dict:
    """flash_attention: small correctness cases (not timed), at the
    reference's kernel-test tolerances (rtol = atol = 2e-3 float32, 2e-2
    bfloat16), then the TinyLlama prefill shape, the H2O-Danube3 shape,
    and the prefill shapes of DeepSeek-MoE (16 heads of 128), the Jamba
    cut (64 query / 8 key-value heads of 128), Llama 3.2 Vision (32 /
    8 of 128), one rank of StableLM 2 12B over 4 model ranks (8 / 2
    of 160, the ``launch_bf16<192, 64>`` instantiation) and one rank of
    musicgen-medium over 16 (the 2 heads of 64 its columns touch), timed,
    at 4e-3 (``flash_case``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.models import attention

    for label, (B, H, KVH, S, T, D, causal, window, dtype) in {
            "f32 GQA causal": (2, 8, 2, 300, 300, 64, True, None,
                               torch.float32),
            "S != T, not causal": (1, 4, 4, 96, 160, 64, False, None,
                                   torch.bfloat16),
            "causal S > T": (1, 4, 2, 200, 72, 64, True, None, torch.float32),
            "window 16": (1, 4, 2, 500, 500, 128, True, 16, torch.bfloat16),
            "MQA": (1, 8, 1, 256, 256, 120, True, None, torch.bfloat16),
            "head dim 160": (1, 3, 3, 200, 200, 160, True, None,
                             torch.float32)}.items():
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((B, H, S, D), (B, KVH, T, D), (B, KVH, T, D)))
        got = ops.attention(q, k, v, causal=causal, window=window)
        want = kfa.plain(q, k, v, causal=causal, window=window)
        check(f"flash_attention {label}", got, want,
              rel(want, 2e-3 if dtype == torch.float32 else 2e-2))
        if causal and S > T:
            assert bool((got[:, :, :S - T] == 0).all()), "masked rows not 0"

    cfg = get_config(LM_ARCH)
    row = timed(dict(flash_case("flash_attention", 1, cfg.n_heads,
                                cfg.n_kv_heads, PREFILL, PREFILL, cfg.hd,
                                cfg.window, g, dev), repeats=REPEATS))
    d = DANUBE
    large = timed(flash_case("flash_attention", 1, d["H"], d["KVH"], d["S"],
                             d["S"], d["D"], d["window"], g, dev))
    row["at_h2o_danube3_8192_window_4096"] = dict_of(large)
    ds = get_config(MOE_ARCH)
    moe = timed(flash_case("flash_attention", 1, ds.n_heads, ds.n_kv_heads,
                           PREFILL, PREFILL, ds.hd, ds.window, g, dev))
    row["at_deepseek_moe_16b_prefill"] = dict_of(moe)
    jb = get_config(HYBRID_ARCH)
    hybrid = timed(flash_case("flash_attention", 1, jb.n_heads, jb.n_kv_heads,
                              PREFILL, PREFILL, jb.hd, jb.window, g, dev))
    row["at_jamba_cut_prefill"] = dict_of(hybrid)
    vl = get_config(VLM_ARCH)
    vision = timed(flash_case("flash_attention", 1, vl.n_heads, vl.n_kv_heads,
                              PREFILL, PREFILL, vl.hd, vl.window, g, dev))
    row["at_llama_3_2_vision_prefill"] = dict_of(vision)
    sl, m = get_config(TP_ARCH), DIST_WORLD
    tp = timed(flash_case("flash_attention", 1, sl.n_heads // m,
                          sl.n_kv_heads // m, PREFILL, PREFILL, sl.hd,
                          sl.window, g, dev))
    row["at_stablelm_12b_tp4_rank"] = dict_of(tp)
    # one rank of musicgen-medium over 16 model ranks (leg K): the 2 heads
    # that its 96 columns touch
    mg = get_config(SPLIT_ARCH)
    n = attention.head_split(mg.n_heads, mg.hd, SPLIT_WORLD, 0).n
    split = timed(flash_case("flash_attention", 1, n, n, PREFILL, PREFILL,
                             mg.hd, mg.window, g, dev))
    row["at_musicgen_medium_tp16_rank"] = dict_of(split)
    torch.cuda.empty_cache()
    return row


def gmm_case(E: int, C: int, d: int, f: int, g, dev,
             iters: int = TIMED_ITERS) -> dict:
    """One timed moe_gmm case in bfloat16: x (E, C, d) unit normals, w
    (E, d, f) scaled by d^-0.5 as the model's init scales it, counts
    seeded in [ceil(0.8 C), C] with expert 0 at 0.  Bytes: the weights of
    the experts with a live row, the live rows of x, all of y (dead rows
    are written as zeros) and the counts; operations: 2 d f per live row,
    at the bfloat16 tensor-core rate.  Tolerance 8e-3 * (1 + |y|): both
    round float32 sums that differ in their last bits to bfloat16, one
    step being at most 2^-7 of the value.  The library call is
    ``torch.bmm`` of the same operands: the whole product, without the
    row mask."""
    from repro_torch.kernels import moe_gmm as kgmm
    from repro_torch.kernels import ops

    x = torch.randn((E, C, d), generator=g, device=dev, dtype=torch.bfloat16)
    w = torch.randn((E, d, f), generator=g, device=dev,
                    dtype=torch.bfloat16).mul_(d ** -0.5)
    cnt = torch.randint(-(-4 * C // 5), C + 1, (E,), generator=g, device=dev,
                        dtype=torch.int32)
    cnt[0] = 0
    live = int(cnt.clamp(0, C).sum())
    experts = int((cnt > 0).sum())
    return dict(
        name="moe_gmm", source="src/repro_torch/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm.py:21",
        kernel=lambda: ops.moe_gmm(x, w, cnt),
        plain=lambda: kgmm.plain(x, w, cnt),
        library=lambda: torch.bmm(x, w),
        nbytes=2 * (experts * d * f + live * d + E * C * f) + 4 * E,
        nops=2 * live * d * f, ops_per_s=BF16_TC_OPS_PER_S, tol=8e-3,
        iters=iters)


def gmm_rows(g, dev) -> dict:
    """moe_gmm at DeepSeek-MoE's prefill shapes (64 experts, capacity 240
    at 2,048 tokens: up (64, 240, 2048) x (64, 2048, 2816), down (64, 240,
    1408) x (64, 1408, 2048)), at one rank's 16 of them on a (1, 4) mesh
    (``at_deepseek_tp4_rank``, the up and its ``down``) and the Jamba
    cut's up and down projections
    (16 experts, capacity 320: (16, 320, 8192) x (16, 8192, 49152), 12.9 GB
    of bfloat16 weights, whose plain version makes a 25.8 GB float32 copy,
    and (16, 320, 24576) x (16, 24576, 8192); each built alone and
    freed).  Small cases first, at the reference's
    kernel-test tolerances: float32 at 1e-3, a C that is no multiple of
    the row tile, odd d and f (no 16-byte loads), counts 0 and C."""
    from repro_torch.kernels import moe_gmm as kgmm
    from repro_torch.kernels import ops

    for label, (E, C, d, f, dtype) in {
            "f32 ragged counts": (4, 100, 200, 300, torch.float32),
            "bf16 odd d, f": (3, 37, 13, 9, torch.bfloat16),
            "bf16 C not a tile": (8, 240, 512, 320, torch.bfloat16)}.items():
        x = torch.randn((E, C, d), generator=g, device=dev).to(dtype)
        w = torch.randn((E, d, f), generator=g, device=dev).to(dtype)
        cnt = torch.randint(0, C + 1, (E,), generator=g, device=dev,
                            dtype=torch.int32)
        cnt[0], cnt[1] = 0, C
        want = kgmm.plain(x, w, cnt)
        check(f"moe_gmm {label}", ops.moe_gmm(x, w, cnt), want,
              rel(want, 1e-3 if dtype == torch.float32 else 5e-2))
    row = timed(gmm_case(64, 240, 2048, 2816, g, dev))
    row["at_deepseek_down"] = dict_of(timed(gmm_case(64, 240, 1408, 2048,
                                                     g, dev)))
    # one rank's experts of DeepSeek on a (1, 4) mesh without moe_ep (leg
    # G): 16 of the 64, the same capacity
    row["at_deepseek_tp4_rank"] = dict_of(timed(gmm_case(16, 240, 2048, 2816,
                                                         g, dev)))
    row["at_deepseek_tp4_rank"]["down"] = dict_of(timed(gmm_case(
        16, 240, 1408, 2048, g, dev)))
    torch.cuda.empty_cache()
    row["at_jamba_up"] = dict_of(timed(gmm_case(16, 320, 8192, 49152, g, dev,
                                                iters=BIG_ITERS)))
    torch.cuda.empty_cache()
    row["at_jamba_down"] = dict_of(timed(gmm_case(16, 320, 24576, 8192, g,
                                                  dev, iters=BIG_ITERS)))
    torch.cuda.empty_cache()
    return row


def ssd_counts(x, a, b, c, L: int) -> tuple[int, int]:
    """(bytes, operations) of one ssd_scan call: x, a, b, c read once, y
    and the float32 h written once; per (b, h, chunk) the L (L + 1) / 2
    pairs t >= s of C B^T (2 N each) and of the masked product with X (2
    P each), C h0 and the state update (2 L N P each)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    n = -(-S // L)
    return (2 * x.nbytes + a.nbytes + b.nbytes + c.nbytes + B * H * N * P * 4,
            B * H * n * (L * (L + 1) * (N + P) + 4 * L * N * P))


def ssd_case(dtype, g, dev, B=1, S=PREFILL, H=256, P=64, N=16,
             L=128) -> dict:
    """One timed ssd_scan case at the Jamba cut's shape (d 8192, expand 2,
    head dim 64: H 256; state 16; chunk 128): x, b, c in ``dtype``, a
    float32 in [0.3, 1).  The kernel against the sequential plain version
    on y and the final h (5e-3, the reference's chunked-vs-sequential
    tolerance; y at 2e-2 in bfloat16, both rounding to bfloat16), after a
    check against the chunked form in plain PyTorch.  Its bytes and
    operations (``ssd_counts``) at the tensor-core rate for bfloat16
    inputs and the float32 rate otherwise.  No one PyTorch call computes
    the scan."""
    from repro_torch.kernels import mamba_scan as kmamba
    from repro_torch.kernels import ops

    x = torch.randn((B, S, H, P), generator=g, device=dev).to(dtype)
    a = torch.rand((B, S, H), generator=g, device=dev) * 0.7 + 0.3
    b = torch.randn((B, S, N), generator=g, device=dev).to(dtype)
    c = torch.randn((B, S, N), generator=g, device=dev).to(dtype)
    y, h = ops.ssd_scan(x, a, b, c, chunk=L)
    cy, ch = kmamba.chunked(x, a, b, c, L)
    bf16 = dtype == torch.bfloat16
    check(f"ssd_scan {str(dtype)[6:]} vs chunked y", y, cy,
          rel(cy, 2e-2 if bf16 else 1e-3))
    check(f"ssd_scan {str(dtype)[6:]} vs chunked h", h, ch, rel(ch, 1e-3))
    del y, h, cy, ch

    def final_h(got, want):
        """Check the final states; the row's error is y's."""
        check(f"ssd_scan {str(dtype)[6:]} final h", got[1], want[1],
              rel(want[1], 5e-3))
        return got[0], want[0]

    nbytes, nops = ssd_counts(x, a, b, c, L)
    return dict(
        name="ssd_scan", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/mamba_scan.py:26",
        kernel=lambda: ops.ssd_scan(x, a, b, c, chunk=L),
        plain=lambda: kmamba.plain(x, a, b, c), library=None, check=final_h,
        nbytes=nbytes, nops=nops,
        ops_per_s=BF16_TC_OPS_PER_S if bf16 else F32_OPS_PER_S,
        tol=2e-2 if bf16 else 5e-3, iters=BIG_ITERS)


def ssd_rows(g, dev) -> dict:
    row = timed(ssd_case(torch.bfloat16, g, dev))
    row["at_float32"] = dict_of(timed(ssd_case(torch.float32, g, dev)))
    torch.cuda.empty_cache()
    return row


def fmt(t) -> str:
    return "-" if t is None else f"{t:.4f}"


def timed(c: dict) -> dict:
    """Check one case against its plain version, then time kernel, plain
    version and library call (``library`` None: no one PyTorch call
    computes the function); one row of the kernels line.  ``ms`` is
    ``cuda_ms``, ``device_ms`` the device operations of the same calls
    under the profiler (``device_ms()``), for the kernel's wrapper and the
    library call.  A case with ``repeats`` measures kernel and library that
    many times and keeps the medians, with min / median / max under
    ``spread``; a repeat whose profile gave no device time is left out of
    that time's median and spread, and ``<time>_n`` counts the repeats
    each time has.  A case's ``check`` (optional) compares further
    outputs, e.g. a second result; its ``read_once`` (optional) reads the
    operands once, a plain read whose device time (``read_once_device_ms``)
    is a yardstick beside the kernel's."""
    want = c["plain"]()
    got = c["kernel"]()
    if "check" in c:
        got, want = c["check"](got, want)
    err = check(c["name"], got, want, rel(want, c["tol"]) if c["tol"] else 0)
    del got, want
    iters = c.get("iters", TIMED_ITERS)
    lib = c["library"]
    runs = {"ms": [], "device_ms": [], "library_ms": [],
            "library_device_ms": []}
    seen: list = []
    for _ in range(c.get("repeats", 1)):
        runs["ms"].append(cuda_ms(c["kernel"], iters))
        runs["device_ms"].append(device_ms(c["kernel"], iters, seen))
        runs["library_ms"].append(cuda_ms(lib, iters) if lib else None)
        runs["library_device_ms"].append(device_ms(lib, iters) if lib
                                         else None)
    plain_ms = cuda_ms(c["plain"], iters)
    bound_ms, bound_by = bound(c["nbytes"], c["nops"],
                               c.get("ops_per_s", F32_OPS_PER_S))
    got = {k: [t for t in v if t is not None] for k, v in runs.items()}
    times = {k: float(np.median(v)) if v else None for k, v in got.items()}
    launches = own_launches(seen, iters)
    print(f"  {c['name']:15s} kernel {fmt(times['ms'])} ms (device "
          f"{fmt(times['device_ms'])})  plain {plain_ms:.4f} ms  library "
          f"{fmt(times['library_ms'])} ms (device "
          f"{fmt(times['library_device_ms'])})  bound {bound_ms:.4f} ms "
          f"({bound_by}, {c['nbytes'] / 1e6:.1f} MB)")
    print("    device operations of the kernel's calls: " + "; ".join(
        f"{name[:60]} x{n} {t:.4f} ms" for t, n, name in sorted(seen,
                                                                reverse=True)))
    print(f"    CUDA launches of the port's kernels per wrapper call: "
          f"{fmt(launches)}")
    row = {"name": c["name"], "route": "cuda", "source": c["source"],
           "replaces": c["replaces"], "max_abs_err": err, "ms": times["ms"],
           "device_ms": times["device_ms"], "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": times["library_ms"],
           "library_device_ms": times["library_device_ms"],
           "device_ms_n": len(got["device_ms"]),
           "library_device_ms_n": len(got["library_device_ms"]),
           "cuda_launches_per_call": launches}
    if "read_once" in c:
        row["read_once_device_ms"] = device_ms(c["read_once"], iters)
        print(f"    read the operands once (torch.sum): device "
              f"{fmt(row['read_once_device_ms'])} ms")
    if c.get("repeats", 1) > 1:
        row["spread"] = {k: [min(v), float(np.median(v)), max(v)]
                         for k, v in got.items() if v}
        print(f"    {len(runs['ms'])} repeats, min / median / max: "
              + "; ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v)
                          + f" (n {len(got[k])})"
                          for k, v in row["spread"].items()))
    return row


def phase_row(label: str, t) -> str:
    return (f"{label:14s} {t.cpu_dpu * 1e3:9.3f}m {t.dpu * 1e3:9.3f}m "
            f"{t.inter_dpu * 1e3:9.3f}m {t.dpu_cpu * 1e3:9.3f}m "
            f"{t.total * 1e3:9.3f}m")


PHASE_HEAD = (f"{'bench':14s} {'cpu_dpu':>10s} {'dpu':>10s} {'inter':>10s} "
              f"{'dpu_cpu':>10s} {'total':>10s}")


def suite_plan(banks: int, scale: int, names) -> dict[str, tuple[int, int]]:
    """Each workload's (banks, make_args scale) in the leg of ``banks`` at
    ``scale``: the leg's own, but for NW (NW_SCALE) and TRNS (at most
    TRNS_BANKS banks)."""
    plan = {name: (banks, scale) for name in names}
    plan["NW"] = (banks, NW_SCALE)
    plan["TRNS"] = (min(banks, TRNS_BANKS), scale)
    return plan


def suite_phase(args_2048: dict) -> tuple[dict[str, int], dict]:
    """The PrIM suite's banked path through the registry, as
    examples/prim_suite.py drives the reference, at each leg of SUITE.
    Returns the kernels' launch counts from this run alone and the
    2,048-bank rows' phase times; fills ``args_2048`` with the 2,048-bank
    leg's (arguments, ref() output) of every workload."""
    from repro_torch import make_bank_grid
    from repro_torch.kernels import ops
    from repro_torch.prim.registry import REGISTRY

    serialized = {}
    ops.reset_launch_counts()
    for banks, scale in SUITE:
        plan = suite_plan(banks, scale, REGISTRY)
        grids = {}
        rng = np.random.default_rng(0)
        print(f"{PHASE_HEAD}   ({banks} banks, scale {scale})")
        for entry in REGISTRY.values():
            b, sc = plan[entry.name]
            grid = grids.setdefault(b, make_bank_grid(b))
            args = entry.make_args(rng, scale=sc)
            t0 = time.perf_counter()
            gold = entry.ref(*args)
            t_ref = time.perf_counter() - t0
            if banks == BANKS:
                args_2048[entry.name] = (args, gold)
            variants = dict(entry.run_variants())
            if entry.name in ("GEMV", "SpMV"):
                variants[f"{entry.name}-kernel"] = functools.partial(
                    entry.pim, use_kernel=True)
            where = "" if (b, sc) == (banks, scale) else (
                f" ({b} banks, scale {sc})")
            for label, fn in variants.items():
                # the first call pays one-off costs (cuBLAS handles, the
                # lazy loading of each new device kernel): the row is the
                # second call's, the first's total printed beside it
                cold = fn(grid, *args)[1].total
                out, t = fn(grid, *args)
                entry.compare(out, gold)
                print(phase_row(label, t) + f"   ok  cold {cold * 1e3:.3f}m"
                      f"  ref {t_ref:.2f}s{where}")
                if banks == BANKS:
                    serialized.setdefault(entry.name, (label, t))
        del grids
    return ops.launch_counts(), serialized


def served(rec) -> str:
    """A session request's wall time: its phase buckets are host time
    summed over the rank threads that served it, as in the reference."""
    return (f"   wall {rec.service_s * 1e3:9.3f}m  ({rec.n_ranks} ranks x "
            f"{rec.n_chunks} chunks{', hit' if rec.cache_hit else ''})")


def refuses_trns(s, args) -> None:
    """TRNS on more banks than its N' rows: the reference's assertion,
    raised through the session's future.  Any other outcome fails."""
    req = s.submit("TRNS", *args)
    try:
        req.result(timeout=300)
    except AssertionError as e:
        assert "N' must divide across banks" in str(e), e
        print(f"TRNS on {s.n_banks} banks: AssertionError({e}) as the "
              f"reference's (N' = {TRNS_NP})")
        return
    raise AssertionError(f"TRNS ran on {s.n_banks} banks with N' = {TRNS_NP}")


def flat_session_phase(args_2048: dict) -> None:
    """The same workloads through a flat 2,048-bank session (one rank, one
    stream set): cold, then warm where the operand is resident.  TRNS's
    N' = 64 does not divide across 2,048 banks: it must raise the
    reference's assertion."""
    from repro_torch import pim

    print(f"flat session: {BANKS} banks, 1 rank")
    print(PHASE_HEAD)
    with pim.session(banks=BANKS) as s:
        for name, entry in pim.registry().items():
            args, gold = args_2048[name]
            if name == "TRNS":
                refuses_trns(s, args)
                continue
            for leg in ("cold", "warm") if entry.resident else ("cold",):
                entry.compare(s.submit(name, *args).result(timeout=300), gold)
                rec = s.telemetry.records[-1]
                assert rec.cache_hit == (leg == "warm"), (name, leg)
                print(phase_row(f"{name} {leg}", rec.phases) + served(rec))


def warm_runs(s, entry, args, gold) -> None:
    """``pin``, then two warm ``run``s of a resident workload.  A
    chunk-resident operand (GEMV, SpMV, MLP) scatters nothing; BS's sorted
    array lives in the resident meta: its queries still scatter, and each
    warm request emits one ``scatter:cached`` span for the broadcast it
    skips."""
    name, spans = entry.name, s.tracer.spans
    s.pin(name, *args)
    pushed = sum(sp.name == "scatter" for sp in spans)
    cached = sum(sp.name == "scatter:cached" for sp in spans)
    chunks = 0
    for _ in range(2):
        entry.compare(s.run(name, *args), gold)
        rec = s.telemetry.records[-1]
        assert rec.cache_hit, (name, "warm run missed the cache")
        chunks += rec.n_ranks * rec.n_chunks
        print(phase_row(f"{name} warm", rec.phases) + served(rec))
    pushed = sum(sp.name == "scatter" for sp in spans) - pushed
    cached = sum(sp.name == "scatter:cached" for sp in spans) - cached
    if entry.chunked.meta_resident:
        assert pushed == chunks, (name, "query chunks", pushed, chunks)
        assert cached == 2, (name, "a warm request broadcast again", cached)
    else:
        assert pushed == 0, f"a warm {name} request scattered a chunk"
        assert cached == chunks, (name, cached, chunks)
    print(f"{name} warm: {pushed} chunk scatters, {cached} cached spans")


def session_phase(args_2048: dict, serialized: dict) -> dict[str, int]:
    """The session façade over 32 ranks of 64 banks: ``run`` of each
    workload against its registry comparator (NW and BFS fall back to
    their serialized ``pim()``; TRNS runs on the 64-bank rank views),
    ``map``, ``pin`` with warm hits, a two-tenant serving block, and a
    trace export.  Returns the kernels' launch counts from this phase (the
    chunked phases use the plain oracles, as the reference's do)."""
    from repro_torch import pim
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    print(f"session: {RANKS} ranks x {BANKS_PER_RANK} banks; pipelined "
          f"(session.run) beside serialized (suite pim, first variant)")
    print(PHASE_HEAD)
    s = pim.session(ranks=RANKS, banks_per_rank=BANKS_PER_RANK, trace=True)
    reg = pim.registry()
    try:
        for name, entry in reg.items():
            args, gold = args_2048[name]
            out = s.run(name, *args)
            entry.compare(out, gold)
            rec = s.telemetry.records[-1]
            label, ser = serialized[name]
            kind = "pipelined" if entry.pipelineable else "fallback"
            print(phase_row(f"{name} {kind}", rec.phases) + served(rec))
            print(phase_row(f"{label} serial", ser))
        rng = np.random.default_rng(1)
        reds = [reg["RED"].make_args(rng, scale=256) for _ in range(4)]
        for out, args in zip(s.map("RED", reds), reds):
            reg["RED"].compare(out, reg["RED"].ref(*args))
        print("map: 4 RED requests ok")
        for name in ("GEMV", "SpMV", "MLP", "BS"):
            warm_runs(s, reg[name], *args_2048[name])
        cache = s.stats()["cache"]
        print(f"cache: {cache}")
        assert cache["hits"] >= 8, cache
        path = s.trace_export(TRACE)
    finally:
        s.close()
    with open(path) as f:
        names = {ev["name"] for ev in json.load(f)["traceEvents"]}
    missing = {"scatter", "compute", "retrieve", "merge", "serialized"} - names
    assert not missing, f"trace lacks {missing}"
    print(f"trace: {len(names)} span names, {os.path.getsize(path)} bytes")

    hst = [reg["HST"].make_args(rng, scale=64) for _ in range(4)]
    red = [reg["RED"].make_args(rng, scale=64) for _ in range(4)]
    with pim.session(ranks=RANKS, banks_per_rank=BANKS_PER_RANK,
                     tenants={"gold": 2.0, "free": 1.0}) as srv:
        reqs = []
        for h, r in zip(hst, red):
            reqs.append(("HST", h, srv.submit(
                "HST", *h, options=pim.RequestOptions(tenant="gold"))))
            reqs.append(("RED", r, srv.submit(
                "RED", *r, options=pim.RequestOptions(tenant="free"))))
        for name, args, req in reqs:
            reg[name].compare(req.result(timeout=60), reg[name].ref(*args))
        tenants = srv.stats()["tenants"]
    done = {t: tenants[t]["completed"] for t in ("gold", "free")}
    assert done == {"gold": 4, "free": 4}, tenants
    print(f"serving: 8 submits over tenants gold:free = 2:1 ok {done}")
    return ops.launch_counts()


def tune_args(args_2048: dict) -> dict:
    """The suite's 2,048-bank (arguments, ref() output) of the pipelineable
    workloads: those the suite phase filled in ``args_2048``, or made the
    same way (one seeded generator over the registry in its order, at
    each workload's scale in ``suite_plan``)."""
    from repro_torch.prim.registry import REGISTRY

    if not args_2048:
        rng = np.random.default_rng(0)
        for name, (_, sc) in suite_plan(*SUITE[0], REGISTRY).items():
            entry = REGISTRY[name]
            args = entry.make_args(rng, scale=sc)
            if entry.pipelineable:
                args_2048[name] = (args, entry.ref(*args))
    return {n: v for n, v in args_2048.items()
            if REGISTRY[n].pipelineable}


def characterize_phase():
    """The paper's §3 characterization on the flat 2,048 banks of the card,
    one line a sweep; returns the flat grid and the fitted CostModel."""
    from repro_torch import make_bank_grid, make_rank_grid
    from repro_torch.core import characterize as ch
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.perfmodel import GpuModel
    from repro_torch.runtime.autotune import calibrate

    grid = make_bank_grid(BANKS)

    def show(label, rows, keys):
        rows = rows if isinstance(rows, list) else [rows]
        print(f"  {label}: " + "; ".join(
            " ".join(f"{k}={r[k]:.6g}" if isinstance(r[k], float)
                     else f"{k}={r[k]}" for k in keys) for r in rows))

    show("push_pull_sweep", ch.push_pull_sweep(grid),
         ("nbytes", "push_s", "pull_s"))
    show("bank_compute_sweep", ch.bank_compute_sweep(grid),
         ("nbytes", "compute_s"))
    show("op_throughput_sweep", ch.op_throughput_sweep(grid),
         ("op", "dtype", "elements", "seconds", "mops"))
    stream = [ch.stream_wram(w, n=STREAM_N, device=grid.device)
              for w in ("copy", "add", "scale", "triad")]
    show(f"stream_wram (n = {STREAM_N})", stream, ("stream", "mbps",
                                                   "seconds"))
    show(f"transfer_sweep ({TRANSFER_MB_PER_BANK} MB a bank)",
         ch.transfer_sweep(grid, mb_per_bank=TRANSFER_MB_PER_BANK),
         ("kind", "nbytes", "gbps"))
    show(f"rank_parallel_sweep ({RANKS} x {BANKS_PER_RANK}, "
         f"{RANK_SWEEP_BYTES} bytes)",
         ch.rank_parallel_sweep(make_rank_grid(RANKS, BANKS_PER_RANK),
                                nbytes=RANK_SWEEP_BYTES),
         ("ranks", "push_gbps", "pull_gbps"))
    stages = calibrate(grid)
    print("  StageFits: " + "; ".join(
        f"{k} alpha {v.alpha_s * 1e6:.3f} us, {v.bytes_per_s / 1e9:.3f} GB/s"
        for k, v in stages.items()))
    cm = CostModel.calibrate(grid)
    print(f"  CostModel: push {cm.push.bytes_per_s / 1e9:.3f} GB/s + "
          f"{cm.push.setup_s * 1e6:.3f} us, pull "
          f"{cm.pull.bytes_per_s / 1e9:.3f} GB/s + "
          f"{cm.pull.setup_s * 1e6:.3f} us, dispatch "
          f"{cm.dispatch_s * 1e6:.3f} us; per op (ps): " + ", ".join(
              f"{op}:{dt} {c.per_op_s * 1e12:.4f}"
              for (op, dt), c in sorted(cm.ops.items())))
    measured = GpuModel.from_stream_rows(stream)
    print(f"  GpuModel: HBM {measured.hbm_bw / 1e12:.4f} TB/s measured "
          f"(stream_wram) against the data sheet's "
          f"{GpuModel().hbm_bw / 1e12:.2f} TB/s")
    return grid, cm


def plan_line(name: str, plan, prof) -> str:
    """A tuned plan: its adopted counts, the probed times, the model's
    predictions, and the stage fits of its workload profile."""
    m = " ".join(f"{c}:{t * 1e3:.3f}" for c, t in sorted(plan.measured_s.items()))
    r = " ".join(f"{c}:{t * 1e3:.3f}"
                 for c, t in sorted(plan.rank_measured_s.items()))
    fits = " ".join(f"{k} {f.alpha_s * 1e6:.1f} us + {f.bytes_per_s / 1e9:.4g}"
                    f" GB/s" for k, f in (("push", prof.push),
                                          ("compute", prof.compute),
                                          ("pull", prof.pull)))
    return (f"  {name:7s} n_chunks {plan.n_chunks} (warm "
            f"{plan.warm_n_chunks}) batch {plan.max_batch_requests} "
            f"ranks {plan.n_ranks}; measured ms {{{m}}}"
            + (f" ranks ms {{{r}}}" if r else "")
            + f"; predicted serialized {plan.predicted_serialized_s * 1e3:.3f}"
            f" pipelined {plan.predicted_pipelined_s * 1e3:.3f} warm "
            f"{plan.warm_predicted_pipelined_s * 1e3:.3f} ms; fits {fits}")


def check_tuned(s, result, args: dict) -> list[float]:
    """Print each tuned plan, hold it to the tuned >= default invariant
    (a probed plan's time at its adopted chunk count is no more than at
    DEFAULT_N_CHUNKS, which is always probed), then serve each workload
    once on ``s`` and hold the result to ``ref()`` with the registry's
    comparator, printing the plan's predicted overlap beside the achieved
    one (the measured serialized baseline over the request's wall time).
    Returns the cost model's accuracy ratios (predicted over measured
    stage seconds, or the inverse, whichever is >= 1) of the plans that
    carry its stage predictions."""
    from repro_torch import pim
    from repro_torch.runtime.autotune import DEFAULT_N_CHUNKS

    ratios = []
    for name, plan in result.plans.items():
        print(plan_line(name, plan, result.profiles[name]))
        m = plan.measured_s
        if m:
            assert DEFAULT_N_CHUNKS in m, (name, "default not probed", m)
            assert m[plan.n_chunks] <= m[DEFAULT_N_CHUNKS], (
                f"{name}: adopted {plan.n_chunks} chunks measured "
                f"{m[plan.n_chunks]} s, over the default's "
                f"{m[DEFAULT_N_CHUNKS]} s")
    for name, plan in result.plans.items():
        entry = pim.registry()[name]
        a, gold = args[name]
        entry.compare(s.run(name, *a), gold)
        rec = s.telemetry.records[-1]
        assert rec.tuned, name
        rec.serialized_s = plan.predicted_serialized_s
        line = (f"  {name:7s} served ok: predicted overlap "
                f"{plan.predicted_overlap:.3f}, achieved "
                f"{rec.overlap_speedup:.3f} (wall "
                f"{rec.service_s * 1e3:.3f} ms, {rec.n_ranks} ranks x "
                f"{rec.n_chunks} chunks)")
        if plan.predicted_stage_s:
            meas = rec.phases.cpu_dpu + rec.phases.dpu + rec.phases.dpu_cpu
            pred = sum(plan.predicted_stage_s.values())
            ratios.append(max(pred / max(meas, 1e-9), meas / max(pred, 1e-9)))
            line += (f"; stages predicted {pred * 1e3:.3f} ms, measured "
                     f"{meas * 1e3:.3f} ms")
        print(line)
    return ratios


def tune_phase(args_2048: dict) -> dict[str, int]:
    """Characterization, then ``pim.session(...).autotune`` on the card:
    the 13 pipelineable workloads on a flat 2,048-bank session and TRNS
    on 64 banks at scale 1024, probed; the constructor's ``autotune=`` on
    64 banks; GEMV / RED / SpMV with the calibrated CostModel (a session
    without the resident cache, so the cold path the model prices runs);
    and GEMV / RED / SpMV over 32 ranks of 64 banks, the rank count probed
    over the 6 divisors of 32.  Every tuned plan is held to tuned >=
    default and every served result to ``ref()``.  Returns the kernels'
    launch counts from this phase."""
    from repro_torch import pim
    from repro_torch.core.costmodel import geomean_ratio
    from repro_torch.kernels import ops
    from repro_torch.runtime.autotune import rank_candidates

    args = tune_args(args_2048)
    pipe = list(args)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    print(f"characterization: {BANKS} banks")
    _, cm = characterize_phase()
    print(f"characterization: {time.perf_counter() - t0:.2f} s")
    flat = [n for n in pipe if n != "TRNS"]
    for banks, names in ((BANKS, flat), (TRNS_BANKS, ["TRNS"])):
        with pim.session(banks=banks) as s:
            t0 = time.perf_counter()
            result = s.autotune(names, scale=TUNE_SCALE, reps=TUNE_REPS,
                                probe=True)
            print(f"tuned {len(names)} on {banks} banks at scale "
                  f"{TUNE_SCALE}: {time.perf_counter() - t0:.2f} s")
            check_tuned(s, result, args)
    with pim.session(banks=TRNS_BANKS, autotune={"scale": 64, "reps": 1,
                                                 "probe": False}) as s:
        assert set(s.plans) == set(pipe), sorted(s.plans)
        print(f"session(banks={TRNS_BANKS}, autotune=...): plans for "
              f"{len(s.plans)} workloads")
    with pim.session(banks=BANKS, resident=False) as s:
        result = s.autotune(COST_TUNE, scale=TUNE_SCALE, reps=TUNE_REPS,
                            probe=True, cost_model=cm)
        for name, plan in result.plans.items():
            model = " ".join(f"{c}:{t * 1e3:.3f}" for c, t
                             in sorted(plan.model_candidate_s.items()))
            print(f"  {name:7s} model_candidate_s ms {{{model}}}; probed "
                  f"{sorted(plan.measured_s)}")
        ratios = check_tuned(s, result, args)
        print(f"cost model: geomean of predicted over measured stage "
              f"seconds {geomean_ratio(ratios):.3f} over {len(ratios)}")
    with pim.session(ranks=RANKS, banks_per_rank=BANKS_PER_RANK) as s:
        t0 = time.perf_counter()
        result = s.autotune(RANK_TUNE, scale=TUNE_SCALE, reps=TUNE_REPS,
                            probe=True)
        print(f"tuned {len(RANK_TUNE)} on {RANKS} x {BANKS_PER_RANK}: "
              f"{time.perf_counter() - t0:.2f} s")
        for name, plan in result.plans.items():
            assert sorted(plan.rank_measured_s) == rank_candidates(RANKS), (
                name, plan.rank_measured_s)
        check_tuned(s, result, args)
    return ops.launch_counts()


def host_ms(fn, iters: int = 3) -> float:
    """Mean host-clock time of ``fn`` (work that ends in a synchronize),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def device_breakdown(fn, ms: float, top: int = 8,
                     what: str = "forward") -> None:
    """One call of ``fn`` (a forward, or ``what``) under
    ``torch.profiler``: the device operations (kernels, copies, memsets)
    with the most device time, and the device's busy share, their sum over
    ``ms`` (the same call's unprofiled host-clock time).  Says so when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "clears events at the end of each cycle"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = device_ops(prof)
    if not rows:
        print("  profiler: no device time recorded")
        return
    busy = sum(r[0] for r in rows)
    print(f"  profiler: device busy {busy:.3f} ms of a {ms:.2f} ms {what} "
          f"({busy / ms:.1%}) in {sum(r[1] for r in rows)} device operations;"
          f" top {top} by device time:")
    for t, n, name in sorted(rows, reverse=True)[:top]:
        print(f"    {t:9.3f} ms {t / busy:6.1%} x{n:<5d} {name[:100]}")
    for kernel, mark in SHARES.items():
        own = [(t, n) for t, n, name in rows if mark in name]
        if own:
            t = sum(r[0] for r in own)
            print(f"    {kernel}: {t:.3f} ms ({t / busy:.1%} of the device "
                  f"time) in {sum(r[1] for r in own)} launches")


def prefill_phase(model, dev) -> int:
    """TinyLlama FULL, seeded weights, one prefill of PREFILL tokens:
    ``forward(use_kernel=True)`` of the float32 ``model`` against
    ``use_kernel=False``
    (rtol = atol = 1e-3: attention's float32 sums in another order, through
    22 layers), then at the config's own bfloat16, timed beside the plain
    forward, with its error and the share of positions whose argmax
    agrees.  Returns flash_attention's launches in one forward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    full = get_config(LM_ARCH)
    toks = torch.randint(0, full.vocab, (1, PREFILL), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    cfg = dataclasses.replace(full, dtype=torch.float32)
    print(f"prefill: {full.name} ({full.total_params() / 1e9:.3f} B params,"
          f" {full.n_layers} layers, d_model {full.d_model}, heads "
          f"{full.n_heads} / {full.n_kv_heads}, head dim {full.hd}), "
          f"tokens (1, {PREFILL})")
    with torch.no_grad():
        ops.reset_launch_counts()
        got, _ = transformer.forward(model, cfg, toks, use_kernel=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        launches = counts["flash_attention"]
        assert launches == full.n_layers, (
            f"{launches} flash_attention launches in one forward, "
            f"want {full.n_layers}")
        assert sum(counts.values()) == launches, counts
        want, _ = transformer.forward(model, cfg, toks, use_kernel=False)
        check("forward f32 kernel vs plain", got, want, rel(want, 1e-3))
        del got, want
        torch.cuda.empty_cache()

        bf16 = transformer.init(full, seed=0, device=dev)
        got, _ = transformer.forward(bf16, full, toks, use_kernel=True)
        want, _ = transformer.forward(bf16, full, toks, use_kernel=False)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        err = float((got.float() - want.float()).abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        ms = host_ms(lambda: transformer.forward(bf16, full, toks,
                                                 use_kernel=True))
        plain_ms = host_ms(lambda: transformer.forward(bf16, full, toks,
                                                       use_kernel=False))
    print(f"  forward bf16: kernel {ms:.2f} ms ({PREFILL / ms * 1e3:.0f} "
          f"tokens/s), plain {plain_ms:.2f} ms; max |kernel - plain| "
          f"{err:.3e}, argmax agrees at {agree:.4f} of positions; "
          f"{launches} flash launches per forward")
    del bf16, got, want
    torch.cuda.empty_cache()
    return launches


def consistency_phase(model, dev) -> None:
    """The reference's prefill / decode check (tests/test_models.py) at
    full width on the float32 ``model``: teacher-forced ``decode_step`` over CONSIST
    tokens reproduces ``forward(use_kernel=True)``'s logits at the
    reference's rtol = atol = 2e-2."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab, (1, CONSIST), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    with torch.no_grad():
        decode_vs_prefill(model, cfg, toks,
                          f"decode vs prefill ({CONSIST} tok)")


def decode_phase(model, dev) -> None:
    """Greedy decode of the float32 TinyLlama FULL ``model``, DECODE_STREAMS
    streams:
    ``greedy_generate`` on the card and ``DecodeEngine`` on a flat session
    of DECODE_BANKS banks (its host half on the CPU) must give the same
    tokens.  Prints the smallest top-1 / top-2 logit gap at the generated
    positions, so that a mismatch can be told from a near tie (a mismatch
    fails either way), both token rates, the engine's pin time, and the
    weight bytes its warm steps scattered (0)."""
    from repro_torch import pim
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype=torch.float32)
    prompt = torch.randint(0, cfg.vocab, (DECODE_STREAMS, DECODE_PROMPT),
                           device=dev, dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(5))
    steps = DECODE_PROMPT + DECODE_NEW - 1
    t0 = time.perf_counter()
    want = serve.greedy_generate(model, cfg, prompt, DECODE_NEW)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    with torch.no_grad():           # the logit gaps along greedy's tokens
        cache = transformer.init_cache(model, cfg, DECODE_STREAMS, steps + 1)
        gap = float("inf")
        for i in range(steps):
            logits, cache = transformer.decode_step(model, cfg,
                                                    want[:, i:i + 1], cache)
            if i + 1 >= DECODE_PROMPT:
                top = logits[:, -1].topk(2, dim=-1).values
                gap = min(gap, float((top[:, 0] - top[:, 1]).min()))
    print(f"decode: greedy_generate {DECODE_STREAMS} x ({DECODE_PROMPT} + "
          f"{DECODE_NEW}) tokens in {greedy_s:.2f} s "
          f"({DECODE_STREAMS * DECODE_NEW / greedy_s:.1f} new tokens/s incl. "
          f"prefill steps); smallest top-1 / top-2 logit gap {gap:.4e}")
    with pim.session(banks=DECODE_BANKS, trace=True) as s:
        eng = pim.DecodeEngine(model, cfg, session=s)
        pushed = sum(sp.name == "scatter" for sp in s.tracer.spans)
        got = eng.generate(want[:, :DECODE_PROMPT].cpu().numpy(), DECODE_NEW)
        warm_scatter = sum(sp.args["bytes"] for sp in s.tracer.spans
                           if sp.name == "scatter")
        cached = sum(sp.args["bytes"] for sp in s.tracer.spans
                     if sp.name == "scatter:cached")
        rep = eng.report()
    assert (got == want.cpu().numpy()).all(), (
        f"DecodeEngine tokens {got.tolist()} != greedy_generate "
        f"{want.cpu().tolist()} (smallest logit gap {gap:.4e})")
    assert pushed == 0 and warm_scatter == 0 and cached > 0, (
        pushed, warm_scatter, cached)
    print(f"  DecodeEngine ({DECODE_BANKS} banks, 1 rank): tokens identical "
          f"to greedy_generate; pin {rep['setup_s']:.2f} s; prefill "
          f"{rep['prefill_s']:.2f} s; {rep['tokens_per_s']:.2f} tokens/s over"
          f" {rep['new_tokens']} new tokens; warm steps scattered "
          f"{warm_scatter} weight bytes ({cached / 1e9:.2f} GB served from "
          f"the banks); host {rep['host_s']:.2f} s, pim "
          + ", ".join(f"{k} {v:.2f} s" for k, v in rep["pim_s"].items()))


@contextlib.contextmanager
def routing_log():
    """Record, for every ``moe.apply`` call, each token's top-k experts
    (sorted) and the pairs past the expert capacity
    (``moe.apply.routing``)."""
    from repro_torch.models import moe

    moe.apply.routing = []
    try:
        yield moe.apply.routing
    finally:
        moe.apply.routing = None


def routed_apart(a: list, b: list) -> int:
    """(token, layer) pairs whose top-k sets differ between two logs."""
    return sum(int((ta != tb).any(-1).sum()) for (ta, _), (tb, _) in zip(a, b))


@contextlib.contextmanager
def routing_tape(tape: list | None = None):
    """Record (``tape`` None) or replay every ``moe`` routing's top-k
    experts, call by call.  Recording yields the list of each call's (T, K)
    top-k, in ``topk``'s order.  Replaying routes the i-th call's tokens to
    ``tape[i]``, with gates from this run's own probabilities renormalised
    over those K, and yields, per call, (the tokens whose own top-k set
    differs, the largest margin that flipped one: its own k-th probability
    less the replayed set's smallest); every entry of the tape must be
    used."""
    from repro_torch.models import moe

    own = moe._top_k
    calls = iter(tape or ())
    log: list = []

    def top_k(probs, cfg, dtype):
        gate, topk = own(probs, cfg, dtype)
        if tape is None:
            log.append(topk.cpu())
            return gate, topk
        want = next(calls).to(probs.device)
        apart = (topk.sort(-1).values != want.sort(-1).values).any(-1)
        g = probs.gather(-1, want)
        margin = probs.gather(-1, topk)[:, -1] - g.min(-1).values
        log.append((int(apart.sum()),
                    float(margin[apart].max()) if apart.any() else 0.0))
        return (g / g.sum(-1, keepdim=True).clamp_min(1e-9)).to(dtype), want

    moe._top_k = top_k
    try:
        yield log
    finally:
        moe._top_k = own
    assert tape is None or (len(log) == len(tape)
                            and next(calls, None) is None), (len(log),
                                                             len(tape))


def expected_launches(model) -> dict[str, int]:
    """Kernel launches of one forward(use_kernel=True): flash_attention per
    self-attention layer (a cross layer runs the plain attention, as the
    reference's does), moe_gmm twice per MoE layer, ssd_scan per Mamba
    layer; none for the xLSTM mixers."""
    descs = [blk.desc for blk in model.layers]
    return {"flash_attention": sum(d["mixer"] == "attn" for d in descs),
            "moe_gmm": 2 * sum(d["ffn"] == "moe" for d in descs),
            "ssd_scan": sum(d["mixer"] == "mamba" for d in descs)}


def counted_forward(model, cfg, toks, **kw) -> dict[str, int]:
    """One ``forward(use_kernel=True, **kw)`` with every count set to 0
    just before it: the launches of the path, checked against the layer
    plan."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    want = expected_launches(model)
    ops.reset_launch_counts()
    transformer.forward(model, cfg, toks, use_kernel=True, **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert {k: counts[k] for k in want} == want, (counts, want)
    assert sum(counts.values()) == sum(want.values()), counts
    return want


def family_phase(arch: str, f32_layers: int, bf16_layers: int, tol: float,
                 dev) -> dict[str, int]:
    """One model family at its published width, seeded weights, prefill of
    PREFILL tokens:

    - float32 at ``f32_layers``: ``forward(use_kernel=True)`` against the
      plain forward within ``tol`` (rtol = atol), with the (token, layer)
      top-k sets the two route differently; teacher-forced ``decode_step``
      over CONSIST tokens against the kernel prefill at the reference's
      rtol = atol = 2e-2, at capacity factor E / K, where no pair drops
      (decode routes B tokens at a time, capacity 8, and never drops);
    - bfloat16 at ``bf16_layers``: the prefill's launches from one
      counted forward (returned), its time with the kernels and plain
      (mean of 3 after a warm-up), the device operations of one forward
      with the kernels under ``torch.profiler`` and the device's busy
      share of it, the max logit difference and argmax
      agreement of the two, the pairs past capacity and the top-k sets
      routed differently; then ``greedy_generate``, DECODE_STREAMS x
      (DECODE_PROMPT + DECODE_NEW) tokens.
    """
    from repro_torch.configs import get_config
    from repro_torch.models import moe, transformer

    full = get_config(arch)
    gen = torch.Generator(device=dev)
    toks = torch.randint(0, full.vocab, (1, PREFILL), device=dev,
                         generator=gen.manual_seed(1))
    cfg = dataclasses.replace(full, n_layers=f32_layers, dtype=torch.float32)
    print(f"{arch}: {full.total_params() / 1e9:.2f} B params at {full.n_layers}"
          f" layers; d_model {full.d_model}, heads {full.n_heads} / "
          f"{full.n_kv_heads}, {full.moe_experts} experts top-"
          f"{full.moe_top_k}, d_ff {full.d_ff}; float32 at {f32_layers} "
          f"layers ({cfg.total_params() / 1e9:.2f} B), bfloat16 at "
          f"{bf16_layers} ({dataclasses.replace(full, n_layers=bf16_layers).total_params() / 1e9:.2f} B)")
    with torch.no_grad():
        model = transformer.init(cfg, seed=0, device=dev)
        print(f"  float32 plan: {[tuple(b.desc.values())[:2] for b in model.layers]}")
        print(f"  float32 launches per forward: {counted_forward(model, cfg, toks)}")
        with routing_log() as klog:
            got, aux = transformer.forward(model, cfg, toks, use_kernel=True)
        with routing_log() as plog:
            want, paux = transformer.forward(model, cfg, toks)
        print(f"  float32 top-k sets routed apart: {routed_apart(klog, plog)} "
              f"of {sum(len(t) for t, _ in klog)} (token, layer); pairs past "
              f"capacity {sum(d for _, d in klog)}; aux {float(aux):.6f} / "
              f"{float(paux):.6f}")
        check(f"{arch} f32 kernel vs plain", got, want, rel(want, tol))
        del got, want
        free = dataclasses.replace(cfg, moe_capacity_factor=cfg.moe_experts
                                   / cfg.moe_top_k)
        assert moe._capacity(free, CONSIST) >= CONSIST
        decode_vs_prefill(model, free, toks[:, :CONSIST],
                          f"{arch} decode vs prefill")
        del model
        torch.cuda.empty_cache()

        cfg = dataclasses.replace(full, n_layers=bf16_layers)
        model = transformer.init(cfg, seed=0, device=dev)
        counts = counted_forward(model, cfg, toks)
        with routing_log() as klog:
            got, _ = transformer.forward(model, cfg, toks, use_kernel=True)
        with routing_log() as plog:
            want, _ = transformer.forward(model, cfg, toks)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        err = float((got.float() - want.float()).abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        apart = routed_apart(klog, plog)
        dropped = [d for _, d in klog]
        del got, want
        ms = host_ms(lambda: transformer.forward(model, cfg, toks,
                                                 use_kernel=True))
        plain_ms = host_ms(lambda: transformer.forward(model, cfg, toks))
        device_breakdown(lambda: transformer.forward(model, cfg, toks,
                                                     use_kernel=True), ms)
        print(f"  forward bf16, {bf16_layers} layers: kernel {ms:.2f} ms "
              f"({PREFILL / ms * 1e3:.0f} tokens/s), plain {plain_ms:.2f} ms;"
              f" max |kernel - plain| {err:.3e}, argmax agrees at "
              f"{agree:.4f} of positions; top-k sets routed apart {apart} of"
              f" {sum(len(t) for t, _ in klog)} (token, layer); pairs past "
              f"capacity {sum(dropped)} of {PREFILL * cfg.moe_top_k * len(dropped)}"
              f" (per MoE layer {dropped}); launches per forward {counts}")
        greedy_leg(model, cfg, gen, dev)
    del model
    torch.cuda.empty_cache()
    return counts


def seeded_frontend(cfg, batch: int, gen, dev) -> torch.Tensor:
    """The VLM stub's frontend: (batch, n_frontend_tokens, d_model) unit
    normals in the model's dtype, as the reference's tests make them."""
    return torch.randn((batch, cfg.n_frontend_tokens, cfg.d_model),
                       generator=gen, device=dev).to(cfg.dtype)


def decode_vs_prefill(model, cfg, toks, label: str, **kw) -> None:
    """The reference's prefill / decode check (tests/test_models.py):
    teacher-forced ``decode_step`` over the tokens of ``toks`` against
    ``forward(use_kernel=True)``'s logits at rtol = atol = 2e-2, checked
    as ``label``; ``frontend=`` goes to both."""
    from repro_torch.models import transformer

    prefill, _ = transformer.forward(model, cfg, toks, use_kernel=True, **kw)
    B, S = toks.shape
    cache = transformer.init_cache(model, cfg, B, S, **kw)
    outs = []
    for i in range(S):
        lt, cache = transformer.decode_step(model, cfg, toks[:, i:i + 1],
                                            cache, **kw)
        outs.append(lt)
    check(label, torch.cat(outs, 1), prefill, rel(prefill, 2e-2))


def bf16_prefill(model, cfg, toks, **kw) -> dict[str, int]:
    """The bfloat16 prefill of ``toks``: its launches from one counted
    forward (returned), the max logit difference and argmax agreement of
    the forward with the kernels and the plain one, both timed (mean of 3
    after a warm-up), and the device operations of one forward with the
    kernels under ``torch.profiler`` with the device's busy share."""
    from repro_torch.models import transformer

    counts = counted_forward(model, cfg, toks, **kw)
    got, _ = transformer.forward(model, cfg, toks, use_kernel=True, **kw)
    want, _ = transformer.forward(model, cfg, toks, **kw)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    err = float((got.float() - want.float()).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    del got, want
    ms = host_ms(lambda: transformer.forward(model, cfg, toks,
                                             use_kernel=True, **kw))
    plain_ms = host_ms(lambda: transformer.forward(model, cfg, toks, **kw))
    device_breakdown(lambda: transformer.forward(model, cfg, toks,
                                                 use_kernel=True, **kw), ms)
    print(f"  forward bf16, {cfg.n_layers} layers: kernel {ms:.2f} ms "
          f"({toks.shape[1] / ms * 1e3:.0f} tokens/s), plain {plain_ms:.2f} "
          f"ms; max |kernel - plain| {err:.3e}, argmax agrees at "
          f"{agree:.4f} of positions; launches per forward {counts}")
    return counts


def greedy_leg(model, cfg, gen, dev, frontend=None) -> None:
    """``greedy_generate``, DECODE_STREAMS x (DECODE_PROMPT + DECODE_NEW)
    tokens, timed; ``frontend`` (DECODE_STREAMS, T, d) for the VLM
    family."""
    from repro_torch.launch import serve

    prompt = torch.randint(0, cfg.vocab, (DECODE_STREAMS, DECODE_PROMPT),
                           device=dev, dtype=torch.int32,
                           generator=gen.manual_seed(5))
    t0 = time.perf_counter()
    tokens = serve.greedy_generate(model, cfg, prompt, DECODE_NEW,
                                   frontend=frontend)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    assert tokens.shape == (DECODE_STREAMS, DECODE_PROMPT + DECODE_NEW)
    print(f"  greedy_generate bf16 {DECODE_STREAMS} x ({DECODE_PROMPT} + "
          f"{DECODE_NEW}) tokens in {greedy_s:.2f} s: {tokens.tolist()}")


def vlm_phase(dev) -> dict[str, int]:
    """Llama 3.2 Vision 11B at its published width, seeded weights and
    seeded frontend tokens, prefill of PREFILL tokens:

    - float32 at VLM_F32_LAYERS (4 self-attention layers and the cross
      layer): ``forward(use_kernel=True, frontend=)`` against the plain
      forward at 1e-3 (rtol = atol, as TinyLlama's), teacher-forced decode
      over CONSIST tokens against the prefill at 2e-2, the cross layer
      reading its cached frontend keys and values;
    - bfloat16 at all 40 layers: ``bf16_prefill`` (32 flash_attention
      launches a forward, returned), then ``greedy_generate(frontend=)``.
    """
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    full = get_config(VLM_ARCH)
    gen = torch.Generator(device=dev)
    toks = torch.randint(0, full.vocab, (1, PREFILL), device=dev,
                         generator=gen.manual_seed(1))
    cfg = dataclasses.replace(full, n_layers=VLM_F32_LAYERS,
                              dtype=torch.float32)
    print(f"{VLM_ARCH}: {full.total_params() / 1e9:.2f} B params at "
          f"{full.n_layers} layers; d_model {full.d_model}, heads "
          f"{full.n_heads} / {full.n_kv_heads}, a cross layer every "
          f"{full.cross_attn_every} over {full.n_frontend_tokens} frontend "
          f"tokens; float32 at {VLM_F32_LAYERS} layers "
          f"({cfg.total_params() / 1e9:.2f} B), bfloat16 at {full.n_layers}")
    with torch.no_grad():
        model = transformer.init(cfg, seed=0, device=dev)
        fr = seeded_frontend(cfg, 1, gen.manual_seed(2), dev)
        print(f"  float32 plan: {[b.desc['mixer'] for b in model.layers]}; "
              f"launches per forward: "
              f"{counted_forward(model, cfg, toks, frontend=fr)}")
        got, _ = transformer.forward(model, cfg, toks, frontend=fr,
                                     use_kernel=True)
        want, _ = transformer.forward(model, cfg, toks, frontend=fr)
        check(f"{VLM_ARCH} f32 kernel vs plain", got, want, rel(want, 1e-3))
        del got, want
        decode_vs_prefill(model, cfg, toks[:, :CONSIST],
                          f"{VLM_ARCH} decode vs prefill", frontend=fr)
        del model, fr
        torch.cuda.empty_cache()

        model = transformer.init(full, seed=0, device=dev)
        counts = bf16_prefill(model, full, toks, frontend=seeded_frontend(
            full, 1, gen.manual_seed(2), dev))
        greedy_leg(model, full, gen, dev, frontend=seeded_frontend(
            full, DECODE_STREAMS, gen.manual_seed(6), dev))
    del model
    torch.cuda.empty_cache()
    return counts


def mlstm_layer_gaps(model, cfg, toks) -> list[float]:
    """Each mLSTM layer's parallel form against its chunked form
    (MLSTM_CHUNK) on the same input, the parallel forward's hidden state
    before it, held at MLSTM_TOL (rtol = atol); the max gap of each."""
    from repro_torch.models import transformer, xlstm
    from repro_torch.models.layers import rms_norm

    x, gaps = model.embed[toks], []
    for blk in model.layers:
        h = rms_norm(x, blk.norm1)
        mo = transformer._mix(blk, cfg, h, None, False)
        if blk.desc["mixer"] == "mlstm":
            ch = xlstm.apply_mlstm_chunked(blk.mixer, cfg, h,
                                           chunk=MLSTM_CHUNK)
            err = (ch - mo).abs()
            assert bool((err <= rel(mo, MLSTM_TOL)).all()), (
                f"mLSTM layer {len(gaps)}: chunked vs parallel "
                f"{float(err.max())}")
            gaps.append(float(err.max()))
        x = x + mo
    return gaps


def xlstm_phase(dev) -> dict[str, int]:
    """xlstm-125m at its published width and depth, seeded weights,
    prefill of PREFILL tokens (no kernel runs: the reference runs none
    here either):

    - float32: each mLSTM layer's parallel form against the chunked one
      (``mlstm_layer_gaps``), the stack's logits of the two printed;
      teacher-forced decode over CONSIST tokens against the prefill at
      2e-2;
    - bfloat16: the prefill timed (mean of 3) with its device operations
      and busy share, then ``greedy_generate``.
    """
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    full = get_config(XLSTM_ARCH)
    gen = torch.Generator(device=dev)
    toks = torch.randint(0, full.vocab, (1, PREFILL), device=dev,
                         generator=gen.manual_seed(1))
    cfg = dataclasses.replace(full, dtype=torch.float32)
    print(f"{XLSTM_ARCH}: {full.n_layers} layers "
          f"{[d['mixer'] for d in transformer.layer_plan(full)[1]]} x "
          f"{transformer.layer_plan(full)[2]}; d_model {full.d_model}, "
          f"{full.n_heads} heads; float32 and bfloat16 at all layers")
    with torch.no_grad():
        model = transformer.init(cfg, seed=0, device=dev)
        counts = counted_forward(model, cfg, toks)
        gaps = mlstm_layer_gaps(model, cfg, toks)
        par, _ = transformer.forward(model, cfg, toks)
        chunked, _ = transformer.forward(
            model, dataclasses.replace(cfg, mlstm_chunk=MLSTM_CHUNK), toks)
        assert torch.isfinite(par).all() and torch.isfinite(chunked).all()
        stack = float(((par - chunked).abs() / (1 + chunked.abs())).max())
        print(f"  float32 mLSTM parallel vs chunked ({MLSTM_CHUNK}) per "
              f"layer, max |gap| (held at {MLSTM_TOL:.1e} rtol = atol): "
              + ", ".join(f"{g:.3e}" for g in gaps)
              + f"; the stack's logits {stack:.3e} (relative)")
        del par, chunked
        decode_vs_prefill(model, cfg, toks[:, :CONSIST],
                          f"{XLSTM_ARCH} decode vs prefill")
        del model
        torch.cuda.empty_cache()

        model = transformer.init(full, seed=0, device=dev)
        got, _ = transformer.forward(model, full, toks)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        del got
        ms = host_ms(lambda: transformer.forward(model, full, toks))
        device_breakdown(lambda: transformer.forward(model, full, toks), ms)
        print(f"  forward bf16, {full.n_layers} layers: {ms:.2f} ms "
              f"({PREFILL / ms * 1e3:.0f} tokens/s)")
        greedy_leg(model, full, gen, dev)
    del model
    torch.cuda.empty_cache()
    return counts


def train_phase(dev, card: str) -> dict[str, int]:
    """The training path on TinyLlama 1.1B FULL (seeded weights, bfloat16,
    remat): TRAIN_STEPS steps of ``launch.train.make_train_step`` at
    TRAIN_BATCH x TRAIN_SEQ (loss, gradient norm, learning rate, host ms,
    tokens/s each; the peak memory; one more step under the profiler;
    every count 0 just before the steps and still 0 after: no kernel lies
    on the gradient path), the loss falling by TRAIN_MARGIN; the eval
    loss through ``flash_attention`` (``train_eval_leg``); MICRO_STEPS
    steps at 2 microbatches; the float32 step against the CPU
    (``train_f32_leg``); the bit-exact restart (``restart_leg``).  Each
    timing and memory line ends with ``card`` (its name and power limit);
    memory is counted from what earlier phases still hold.  Returns the
    eval leg's kernel launches."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    full = get_config(LM_ARCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"train: {full.name} ({full.total_params() / 1e9:.3f} B params, "
          f"{full.n_layers} layers, {full.dtype}, remat {full.remat} "
          f"({full.remat_policy})), batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{TRAIN_STEPS} steps, AdamW lr {TRAIN_LR} warmup 2")
    dc = DataConfig(seed=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    batch = lambda i: train.to_device(make_batch(full, dc, i), full, dev)  # noqa: E731
    held = torch.cuda.memory_allocated(dev)
    gb = lambda: (torch.cuda.max_memory_allocated(dev) - held) / 1e9  # noqa: E731
    print(f"  {held / 1e9:.2f} GB held by earlier phases, counted out below")
    torch.cuda.reset_peak_memory_stats(dev)
    model, opt = train.init_state(0, full, dev)
    print(f"  params + optimizer state: "
          f"{(torch.cuda.memory_allocated(dev) - held) / 1e9:.2f} GB")
    ocfg = optim.AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                             total_steps=TRAIN_STEPS)
    step = train.make_train_step(full, ocfg)

    def timed_steps(step, first: int, n: int, label: str):
        """Steps ``first`` .. ``first + n - 1`` -> (losses, last ms)."""
        nonlocal model, opt
        losses = []
        for i in range(first, first + n):
            b = batch(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, opt, m = step(model, opt, b)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            losses.append(float(m["loss"]))
            print(f"  {label} {i}: loss {losses[-1]:.4f} grad_norm "
                  f"{float(m['grad_norm']):.4f} lr {float(m['lr']):.3e} "
                  f"{ms:.1f} ms ({tokens / ms * 1e3:.0f} tokens/s) on {card}")
        return losses, ms

    ops.reset_launch_counts()
    losses, ms = timed_steps(step, 0, TRAIN_STEPS, "step")
    counts = ops.launch_counts()
    assert not any(counts.values()), counts
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    print(f"  peak memory {gb():.2f} GB on {card}; launches of the steps "
          f"{counts}; loss mean of the first 3 {first:.4f}, of the last 3 "
          f"{last:.4f}")
    assert np.isfinite(losses).all(), losses
    assert last < first - TRAIN_MARGIN, (losses, TRAIN_MARGIN)
    b = batch(TRAIN_STEPS)      # one more step, profiled
    device_breakdown(lambda: step(model, opt, b), ms,
                     what=f"train step on {card}")

    eval_counts = train_eval_leg(model, full, batch(0))

    torch.cuda.reset_peak_memory_stats(dev)
    micro = train.make_train_step(full, ocfg, microbatches=2)
    losses, _ = timed_steps(micro, TRAIN_STEPS + 1, MICRO_STEPS,
                            "2 microbatches, step")
    assert np.isfinite(losses).all(), losses
    print(f"  peak memory at 2 microbatches {gb():.2f} GB on {card}")
    del model, opt
    torch.cuda.empty_cache()

    train_f32_leg(dev)
    restart_leg()
    return eval_counts


def train_eval_leg(model, cfg, batch) -> dict[str, int]:
    """Under ``torch.no_grad()``, ``loss_fn(use_kernel=True)`` of the
    trained bfloat16 model (one launch of ``flash_attention`` a layer,
    counted from 0) against the plain loss at rtol = atol = EVAL_TOL;
    with grad on, the kernel's wrapper refuses the call
    (``cuda_lib.require_cuda``: the kernel has no backward)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    with torch.no_grad():
        ops.reset_launch_counts()
        kernel, _ = transformer.loss_fn(model, cfg, batch, use_kernel=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        plain, _ = transformer.loss_fn(model, cfg, batch)
    assert counts["flash_attention"] == cfg.n_layers, counts
    assert sum(counts.values()) == cfg.n_layers, counts
    err = abs(float(kernel) - float(plain))
    assert err <= EVAL_TOL * (1 + abs(float(plain))), (kernel, plain)
    print(f"  eval loss bf16: flash_attention {float(kernel):.6f}, plain "
          f"{float(plain):.6f}, |diff| {err:.3e}; launches {counts}")
    try:
        transformer.loss_fn(model, cfg, batch, use_kernel=True)
    except RuntimeError as e:
        assert "no backward" in str(e), e
        print(f"  loss_fn(use_kernel=True) under grad refused: {e}")
    else:
        raise AssertionError("loss_fn(use_kernel=True) under grad ran")
    return counts


def train_f32_leg(dev) -> None:
    """TinyLlama's width at F32_LAYERS layers in float32, batch 1 x
    F32_SEQ, the same weights on the card and on the CPU (the port's plain
    path on both): the loss at 1e-4 and each gradient leaf at GRAD_TOL of
    its largest |g|; ``optim.apply`` on the CPU's gradients on both at
    rtol = atol = 1e-6; ``loss_fn(loss_chunks=LOSS_CHUNKS)`` against the
    whole logits at rtol = atol = 1e-5."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch import train
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=F32_LAYERS,
                              dtype=torch.float32)
    host = make_batch(cfg, DataConfig(seed=0, batch=1, seq=F32_SEQ), 0)
    cpu = torch.device("cpu")
    gpu_model, gpu_opt = train.init_state(0, cfg, dev)
    cpu_model = transformer.Transformer(cfg, device=cpu)
    cpu_model.load_state_dict({k: v.to(cpu) for k, v in
                               gpu_model.state_dict().items()})
    cpu_model.requires_grad_(True)
    out = {}
    for where, model in ((dev, gpu_model), (cpu, cpu_model)):
        loss, _ = transformer.loss_fn(model, cfg,
                                      train.to_device(host, cfg, where))
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        out[where.type] = (float(loss.detach()), dict(zip(named, grads)))
    (gl, gg), (cl, cg) = out[dev.type], out["cpu"]
    gaps = {k: float((gg[k].cpu() - cg[k]).abs().max() / cg[k].abs().max())
            for k in cg}
    worst = max(gaps, key=gaps.get)
    print(f"  f32, {F32_LAYERS} layers, 1 x {F32_SEQ}: loss card {gl:.6f}, "
          f"cpu {cl:.6f}, |diff| {abs(gl - cl):.3e}; gradients: worst leaf "
          f"{worst} at {gaps[worst]:.3e} of its largest |g|")
    assert abs(gl - cl) <= 1e-4, (gl, cl)
    assert gaps[worst] <= GRAD_TOL, (worst, gaps[worst])

    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    cpu_opt = optim.init(dict(cpu_model.named_parameters()))
    optim.apply(ocfg, {k: g.to(dev) for k, g in cg.items()}, gpu_opt,
                dict(gpu_model.named_parameters()))
    optim.apply(ocfg, cg, cpu_opt, dict(cpu_model.named_parameters()))
    err = 0.0
    for part in ("master", "mu", "nu"):
        for k, want in cpu_opt[part].items():
            got = gpu_opt[part][k].cpu()
            assert torch.allclose(got, want, rtol=1e-6, atol=1e-6), (part, k)
            err = max(err, float((got - want).abs().max()))
    print(f"  apply on identical gradients, card vs cpu: max |diff| of "
          f"master, mu, nu {err:.3e}")
    with torch.no_grad():
        b = train.to_device(host, cfg, dev)
        whole, _ = transformer.loss_fn(gpu_model, cfg, b)
        chunked, _ = transformer.loss_fn(gpu_model, cfg, b,
                                         loss_chunks=LOSS_CHUNKS)
    err = abs(float(chunked) - float(whole))
    assert err <= 1e-5 * (1 + abs(float(whole))), (chunked, whole)
    print(f"  loss_chunks={LOSS_CHUNKS} vs whole logits: {float(chunked):.6f}"
          f" / {float(whole):.6f}, |diff| {err:.3e}")
    del gpu_model, gpu_opt
    torch.cuda.empty_cache()


def restart_leg() -> None:
    """``restart_run`` in a child process started with
    CUBLAS_WORKSPACE_CONFIG=:4096:8 and deterministic algorithms; its
    non-zero exit fails the phase."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--restart-child"], env=env, capture_output=True,
                           text=True, timeout=600)
    print(child.stdout, end="")
    assert child.returncode == 0, (f"restart child exited "
                                   f"{child.returncode}:\n{child.stderr}")


def restart_run(dev) -> None:
    """TinyLlama's width at 1 layer, float32, batch 1 x RESTART_SEQ:
    ``fit`` for RESTART_STEPS steps uninterrupted; then ``fit`` for half
    of them with an async ``Checkpointer`` (a checkpoint at the half) and
    a fresh ``fit`` that resumes to RESTART_STEPS; every parameter and
    the optimizer state ``torch.equal``."""
    import tempfile

    from repro_torch import optim
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, Loader
    from repro_torch.launch import train

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=1,
                              dtype=torch.float32)
    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=RESTART_STEPS)
    half, logs = RESTART_STEPS // 2, []

    def fit(steps, ck=None, every=0):
        return train.fit(cfg, steps=steps, data_loader=Loader(
            cfg, DataConfig(seed=0, batch=1, seq=RESTART_SEQ)), ocfg=ocfg,
            checkpointer=ck, checkpoint_every=every, log_every=1,
            log=logs.append, device=dev)

    t0 = time.perf_counter()
    full, full_opt, hist = fit(RESTART_STEPS)
    scratch = os.path.join(ROOT, "build", "repro_torch")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        ck = Checkpointer(d, keep=2, async_mode=True)
        fit(half, ck, half)
        assert ck.latest_step() == half, ck.all_steps()
        res, res_opt, res_hist = fit(RESTART_STEPS, Checkpointer(d, keep=2))
    assert f"[train] resumed from step {half}" in logs, logs
    assert res_hist == hist[half:], (res_hist, hist)
    for (k, a), (_, b) in zip(full.named_parameters(), res.named_parameters()):
        assert torch.equal(a, b), k
    for part in ("master", "mu", "nu"):
        for k, a in full_opt[part].items():
            assert torch.equal(a, res_opt[part][k]), (part, k)
    assert torch.equal(full_opt["step"], res_opt["step"])
    print(f"  restart: {RESTART_STEPS} steps against {half} + a checkpoint + "
          f"{RESTART_STEPS - half} resumed, 1 layer f32, 1 x {RESTART_SEQ}, "
          f"deterministic {torch.are_deterministic_algorithms_enabled()}: "
          f"losses {[round(x, 4) for x in hist]}, every parameter and the "
          f"optimizer state equal ({time.perf_counter() - t0:.2f} s)")


# ---------------------------------------------------------------------------
# dist phase: expert and data parallelism over torch.distributed
# ---------------------------------------------------------------------------

def dist_configs() -> dict:
    """The dist phase's models and sizes (one picklable dict: the ranks
    take everything from it): DeepSeek-MoE 16B FULL with ``moe_ep`` in
    float32 at MOE_F32_LAYERS and bfloat16 at all 28 (leg A, and leg B in
    float32); TinyLlama 1.1B FULL cut to DIST_TRAIN_LAYERS, float32 and
    bfloat16 (leg C); DeepSeek FULL cut to layer 0 and one MoE layer at
    capacity factor 8.0 with ``moe_ep`` (leg C's expert-parallel steps);
    StableLM 2 12B FULL in float32 at TP_F32_LAYERS and bfloat16 at all 40
    (leg D); the Jamba cut with ``moe_ep`` in float32 (leg E); DeepSeek
    FULL as published, ``moe_ep`` off, the same two ways (leg G) and with
    ``fsdp=True`` (leg H, bfloat16 at FSDP_BF16_LAYERS), the Jamba cut as
    published (``fsdp=True``) in bfloat16 (leg H), TinyLlama's float32 cut
    with ``fsdp=True`` (leg I), H2O-Danube3 4B FULL cut to SEQ_F32_LAYERS
    in float32 and to SEQ_BF16_LAYERS in bfloat16 with leg J's cache
    sizes; leg L's SMOKE configs (CUT_CASES) at a prefill of PREFILL."""
    from repro_torch.configs import get_config

    published = get_config(MOE_ARCH)
    moe = dataclasses.replace(published, moe_ep=True)
    lm = dataclasses.replace(get_config(LM_ARCH), n_layers=DIST_TRAIN_LAYERS)
    tp = get_config(TP_ARCH)
    return {"tp_f32": dataclasses.replace(tp, n_layers=TP_F32_LAYERS,
                                          dtype=torch.float32),
            "tp_bf16": tp,
            "hy_f32": dataclasses.replace(get_config(HYBRID_ARCH),
                                          n_layers=HYBRID_LAYERS,
                                          dtype=torch.float32, moe_ep=True),
            "tp_seq": TP_F32_SEQ,
            "moe_f32": dataclasses.replace(moe, n_layers=MOE_F32_LAYERS,
                                           dtype=torch.float32),
            "moe_bf16": moe,
            "lm_f32": dataclasses.replace(lm, dtype=torch.float32),
            "lm_bf16": lm,
            "ep_train": dataclasses.replace(moe, n_layers=2,
                                            moe_capacity_factor=8.0),
            "g_f32": dataclasses.replace(published, n_layers=MOE_F32_LAYERS,
                                         dtype=torch.float32),
            "g_bf16": published,
            "h_f32": dataclasses.replace(published, n_layers=MOE_F32_LAYERS,
                                         dtype=torch.float32, fsdp=True),
            "h_bf16": dataclasses.replace(published, fsdp=True,
                                          n_layers=FSDP_BF16_LAYERS),
            "h_jamba": dataclasses.replace(get_config(HYBRID_ARCH),
                                           n_layers=HYBRID_LAYERS),
            "i_lm": dataclasses.replace(lm, dtype=torch.float32, fsdp=True),
            "j_f32": dataclasses.replace(get_config(SEQ_ARCH),
                                         n_layers=SEQ_F32_LAYERS,
                                         dtype=torch.float32),
            "j_bf16": dataclasses.replace(get_config(SEQ_ARCH),
                                          n_layers=SEQ_BF16_LAYERS),
            "l_cases": {k: dataclasses.replace(get_config(arch, smoke=True),
                                               **fields)
                        for k, (arch, fields) in CUT_CASES.items()},
            "l_seq": PREFILL, "l_new": CUT_NEW,
            "j_max_len": SEQ_MAX_LEN, "j_start": SEQ_START, "j_new": SEQ_NEW,
            "j_slab": SEQ_SLAB, "j_prefill": SEQ_PREFILL,
            "fsdp_seq": DIST_FSDP_SEQ,
            "prefill": PREFILL, "prompt": DIST_PROMPT, "new": DIST_NEW,
            "f32_seq": DIST_F32_SEQ, "seq": TRAIN_SEQ, "steps": DIST_STEPS,
            "ep_seq": DIST_EP_SEQ, "world": DIST_WORLD}


def dist_tokens(c: dict, vocab: int):
    """Leg A's prefill tokens (1, prefill) and leg B's prompt (2, prompt),
    the same in the parent and in every rank."""
    rng = np.random.default_rng(11)
    return (torch.from_numpy(rng.integers(0, vocab, (1, c["prefill"]))
                             .astype(np.int32)),
            torch.from_numpy(rng.integers(0, vocab, (2, c["prompt"]))
                             .astype(np.int32)))


def fsdp_tokens(c: dict, vocab: int):
    """Leg H's float32 prefill tokens (2, fsdp_seq), also the Jamba cut's,
    and its bfloat16 prefill (2, prefill), the same in the parent and in
    every rank (each data rank takes its row)."""
    rng = np.random.default_rng(13)
    return tuple(torch.from_numpy(rng.integers(0, vocab, shape)
                                  .astype(np.int32))
                 for shape in ((2, c["fsdp_seq"]), (2, c["prefill"])))


def tp_tokens(c: dict, vocab: int):
    """Legs D and E's float32 prefill tokens (1, tp_seq), leg D's bfloat16
    prefill (1, prefill) and its prompt (2, prompt), the same in the parent
    and in every rank."""
    rng = np.random.default_rng(12)
    return tuple(torch.from_numpy(rng.integers(0, vocab, shape)
                                  .astype(np.int32))
                 for shape in ((1, c["tp_seq"]), (1, c["prefill"]),
                               (2, c["prompt"])))


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def reference_bytes(cfg, dims: dict, tp1: bool = False) -> int:
    """The bytes of parameters that the reference's specs
    (``transformer.param_specs``; with ``tp1``, as its dry-run's ``tp1``
    rewrites them: no "model" entry) put on one device of a mesh of
    ``dims`` ({axis: size}): each leaf's bytes over the sizes of the axes
    its spec names, "model" (the experts' too, with or without ``moe_ep``)
    and "data" (``fsdp``) alike (``NamedSharding``'s shard of dimensions
    that divide, which tests/test_torch_tp.py holds the port's layout
    to)."""
    from repro_torch.core.sharding import axis_size
    from repro_torch.models import transformer

    whole = transformer.Transformer(dataclasses.replace(cfg, moe_ep=False),
                                    device="meta")
    specs = transformer.param_specs(cfg, tp1)
    total = 0
    for name, p in whole.named_parameters():
        names = [a for e in specs[name] if e is not None
                 for a in ((e,) if isinstance(e, str) else e) if a in dims]
        total += p.numel() * p.element_size() // axis_size(dims, names)
    return total


def reference_cache_bytes(cfg, batch: int, max_len: int, dims: dict) -> int:
    """The bytes of self-attention keys and values that the reference's
    cache specs (``launch.serve.cache_specs`` of the whole cache's shapes,
    the reference's pure function) put on one device of a mesh of ``dims``
    ({axis: size}) for a decode cache of ``batch`` x ``max_len``."""
    return reference_cache_parts(cfg, batch, max_len, dims)["kv"]


def reference_cache_parts(cfg, batch: int, max_len: int, dims: dict) -> dict:
    """``reference_cache_bytes`` of the self-attention layers' "k" and "v"
    ("kv") and of the mLSTM layers' "C", "n" and "m", each apart."""
    from repro_torch.core.sharding import axis_size
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    whole = transformer.init_cache(transformer.Transformer(cfg,
                                                           device="meta"),
                                   cfg, batch, max_len)
    specs = serve.cache_specs(whole, dims)
    total = dict.fromkeys(("kv", "C", "n", "m"), 0)
    for lc, sp in zip(whole["layers"], specs["layers"]):
        kinds = ({"k": "kv", "v": "kv"} if "k" in lc else
                 {"C": "C", "n": "n", "m": "m"} if "C" in lc else {})
        for k, kind in kinds.items():
            names = [a for e in sp[k] if e is not None
                     for a in ((e,) if isinstance(e, str) else e)]
            total[kind] += (lc[k].numel() * lc[k].element_size()
                            // axis_size(dims, names))
    return total


def cache_parts(cache: dict) -> dict:
    """A decode cache's bytes of "k" and "v" ("kv") and of the mLSTM
    layers' "C", "n" and "m", each apart (``reference_cache_parts``'
    kinds)."""
    total = dict.fromkeys(("kv", "C", "n", "m"), 0)
    for lc in cache["layers"]:
        kinds = ({"k": "kv", "v": "kv"} if "k" in lc else
                 {"C": "C", "n": "n", "m": "m"} if "C" in lc else {})
        for k, kind in kinds.items():
            total[kind] += lc[k].numel() * lc[k].element_size()
    return total


def dist_batch(cfg, batch: int, seq: int, step: int) -> dict:
    from repro_torch.data import DataConfig, make_batch
    return make_batch(cfg, DataConfig(seed=0, batch=batch, seq=seq), step)


def dist_ocfg(steps: int, lr: float):
    from repro_torch import optim
    return optim.AdamWConfig(lr=lr, warmup_steps=1, total_steps=steps)


def dist_reference(c: dict, dev, d: str) -> dict:
    """The one-process port on the same seeded weights and inputs as the
    ranks (leg A's logits and leg C's float32 gradients go to files in
    ``d``; every model is freed before the ranks start)."""
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer

    ref = {}
    with torch.no_grad():
        cfg = dataclasses.replace(c["moe_f32"], moe_ep=False)
        toks, prompt = dist_tokens(c, cfg.vocab)
        model = transformer.init(cfg, seed=0, device=dev)
        with routing_tape() as tape:
            logits, _ = transformer.forward(model, cfg, toks,
                                            use_kernel=True)
        torch.save(logits.cpu(), os.path.join(d, "a_f32.pt"))
        torch.save(tape, os.path.join(d, "a_f32_routing.pt"))
        del logits
        ref["tokens"] = serve.greedy_generate(model, cfg, prompt,
                                              c["new"]).cpu()
        # leg H's float32 reference: the same model on 2 x fsdp_seq
        with routing_tape() as tape:
            logits, _ = transformer.forward(
                model, cfg, fsdp_tokens(c, cfg.vocab)[0], use_kernel=True)
        torch.save(logits.cpu(), os.path.join(d, "h_f32.pt"))
        torch.save(tape, os.path.join(d, "h_f32_routing.pt"))
        del logits, model
        cfg = dataclasses.replace(c["moe_bf16"], moe_ep=False)
        model = transformer.init(cfg, seed=0, device=dev)
        logits, _ = transformer.forward(model, cfg, toks, use_kernel=True)
        torch.save(logits.cpu(), os.path.join(d, "a_bf16.pt"))
        del logits
        if dev.type == "cuda":
            ref["prefill_ms"] = host_ms(lambda: transformer.forward(
                model, cfg, toks, use_kernel=True))
        del model
        empty_cache(dev)

        # legs D and E
        cfg = c["tp_f32"]
        short, long, prompt = tp_tokens(c, cfg.vocab)
        model = transformer.init(cfg, seed=0, device=dev)
        logits, _ = transformer.forward(model, cfg, short, use_kernel=True)
        torch.save(logits.cpu(), os.path.join(d, "d_f32.pt"))
        del logits
        ref["tp_tokens"] = serve.greedy_generate(model, cfg, prompt,
                                                 c["new"]).cpu()
        del model
        empty_cache(dev)
        cfg = c["tp_bf16"]
        model = transformer.init(cfg, seed=0, device=dev)
        ref["tp_param_gb"] = param_bytes(model) / 1e9
        logits, _ = transformer.forward(model, cfg, long, use_kernel=True)
        torch.save(logits.cpu(), os.path.join(d, "d_bf16.pt"))
        del logits
        if dev.type == "cuda":
            ref["tp_prefill_ms"] = host_ms(lambda: transformer.forward(
                model, cfg, long, use_kernel=True))
        del model
        empty_cache(dev)
        cfg = dataclasses.replace(c["hy_f32"], moe_ep=False)
        model = transformer.init(cfg, seed=0, device=dev)
        with routing_tape() as tape:
            logits, _ = transformer.forward(model, cfg,
                                            tp_tokens(c, cfg.vocab)[0],
                                            use_kernel=True)
        torch.save(logits.cpu(), os.path.join(d, "e_f32.pt"))
        torch.save(tape, os.path.join(d, "e_f32_routing.pt"))
        del logits, model
        empty_cache(dev)
        # leg H's Jamba cut in bfloat16
        cfg = c["h_jamba"]
        model = transformer.init(cfg, seed=0, device=dev)
        logits, _ = transformer.forward(model, cfg,
                                        fsdp_tokens(c, cfg.vocab)[0],
                                        use_kernel=True)
        torch.save(logits.cpu(), os.path.join(d, "h_jamba.pt"))
        del logits, model
        empty_cache(dev)

    lm = c["lm_f32"]
    model, _ = train.init_state(0, lm, dev)
    b = train.to_device(dist_batch(lm, 4, c["f32_seq"], 0), lm, dev)
    loss, g = train.make_grads(lm)(model, b)
    ref["f32_loss"] = float(loss)
    torch.save({k: v.cpu() for k, v in g.items()}, os.path.join(d, "c_grads.pt"))
    del g
    model.requires_grad_(False)
    ref["i_tokens"] = serve.greedy_generate(
        model, lm, dist_tokens(c, lm.vocab)[1], c["new"]).cpu()
    del model
    ref["f32_fit"] = dist_fit(lm, dev, None, c, c["steps"])
    for key, cfg, batch, seq in (("bf16", c["lm_bf16"], 4, c["seq"]),
                                 ("ep", dataclasses.replace(
                                     c["ep_train"], moe_ep=False), 2,
                                  c["ep_seq"])):
        ref[key] = dist_steps(cfg, dev, None, batch, seq,
                              c["steps"] if key == "bf16" else 2)[0]
    empty_cache(dev)
    ref.update(seq_reference(c, dev, d))
    ref.update(cut_reference(c, dev, d))
    return ref


def seq_slab_seed(layer: int, slab: int) -> int:
    return int(np.random.SeedSequence([SEQ_SEED, layer, slab])
               .generate_state(1)[0])


def seq_fill(model, cfg, cache: dict, c: dict, seq) -> None:
    """Leg J's seeded cache: each self-attention layer's keys and values
    at the slabs of ``j_slab`` positions that hold positions below
    ``j_start``, each slab drawn whole (every kv head, float32) from a
    generator of its own seeded by (layer, slab), of which this cache
    keeps its block of positions (``seq``) and its kv heads: one process
    and every rank hold the same values at the same positions.  ``len``
    is set to ``j_start`` (the reference has no prefill into a cache, and
    nothing fills 524,288 positions a token at a time)."""
    slab = c["j_slab"]
    filled = -(-c["j_start"] // slab)
    for li, (blk, lc) in enumerate(zip(model.layers, cache["layers"])):
        if "k" not in lc:
            continue
        T = lc["k"].shape[2]
        start = seq.index * T
        assert T % slab == 0, (T, slab)
        for s in range(start // slab, min(filled, (start + T) // slab)):
            g = torch.Generator(device=lc["k"].device).manual_seed(
                seq_slab_seed(li, s))
            kv = torch.randn((2, cfg.n_kv_heads, slab, cfg.hd), generator=g,
                             device=lc["k"].device)[:, blk.mixer.kv]
            at = s * slab - start
            lc["k"][0, :, at:at + slab] = kv[0]
            lc["v"][0, :, at:at + slab] = kv[1]
        lc["len"].fill_(c["j_start"])


def seq_tokens(c: dict, vocab: int):
    """Leg J's prefill tokens (1, j_prefill) and the decode's first token
    (1, 1), the same in the parent and in every rank."""
    rng = np.random.default_rng(14)
    return tuple(torch.from_numpy(rng.integers(0, vocab, shape)
                                  .astype(np.int32))
                 for shape in ((1, c["j_prefill"]), (1, 1)))


def seq_decode(model, cfg, c: dict, dev, forced=None):
    """Leg J's decode on the model's mesh: ``serve.make_cache`` of 1 x
    ``j_max_len`` (on a mesh whose data axes the batch does not divide,
    the rank's block of positions, ``serve.seq_shard``), ``seq_fill``,
    then ``j_new`` steps of ``serve.make_serve_step`` from the seeded
    first token, each feeding its argmax (greedy) or, with ``forced`` (1,
    j_new + 1), the next of those tokens -> (the first token and each
    step's argmax (1, j_new + 1), each step's logits (j_new, V) float32
    on the CPU, each step's host ms, the cache's bytes of keys and
    values)."""
    from repro_torch.launch import serve

    L = c["j_max_len"]
    cache = serve.make_cache(model, cfg, 1, L)
    seq_fill(model, cfg, cache, c, serve.seq_shard(model.mesh, cfg, 1, L))
    kv = sum(lc[k].numel() * lc[k].element_size() for lc in cache["layers"]
             for k in ("k", "v") if k in lc)
    step = serve.make_serve_step(cfg, batch=1, max_len=L)
    tok = seq_tokens(c, cfg.vocab)[1].to(dev)
    toks, logits, ms = [tok], [], []
    for i in range(c["j_new"]):
        sync(dev)
        t0 = time.perf_counter()
        lg, cache = step(model, cache, tok)
        pick = lg[:, -1:].argmax(-1).to(torch.int32)
        tok = pick if forced is None else forced[:, i + 1:i + 2].to(dev)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg[0, -1].float().cpu())
        toks.append(pick)
    del cache
    return torch.cat(toks, 1).cpu(), torch.stack(logits), ms, kv


def seq_reference(c: dict, dev, d: str) -> dict:
    """Leg J in one process on the whole cache: the float32 cut's prefill
    of 1 x j_prefill through ``flash_attention`` against the plain
    forward at 1e-3, its decode (logits to ``d``); the bfloat16 cut's
    prefill counted and timed, its decode timed (logits to ``d``) with
    the peak memory above what was held before it."""
    from repro_torch.models import transformer

    ref = {}
    with torch.no_grad():
        cfg = c["j_f32"]
        toks = seq_tokens(c, cfg.vocab)[0].to(dev)
        model = transformer.init(cfg, seed=0, device=dev)
        want, _ = transformer.forward(model, cfg, toks)
        got, ref["j_f32_prefill_launches"] = counted(
            lambda: transformer.forward(model, cfg, toks,
                                        use_kernel=True)[0], dev)
        ref["j_f32_prefill_err"] = check(
            "leg J f32 prefill, kernel vs plain", got, want, rel(want, 1e-3))
        del got, want
        empty_cache(dev)
        ref["j_tokens"], logits, ref["j_f32_ms"], ref["j_f32_kv"] = \
            seq_decode(model, cfg, c, dev)
        torch.save(logits, os.path.join(d, "j_f32.pt"))
        del model
        empty_cache(dev)

        cfg = c["j_bf16"]
        model = transformer.init(cfg, seed=0, device=dev)
        fwd = lambda: transformer.forward(model, cfg, toks,  # noqa: E731
                                          use_kernel=True)[0]
        got, ref["j_prefill_launches"] = counted(fwd, dev)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        del got
        if dev.type == "cuda":
            ref["j_prefill_ms"] = host_ms(fwd)
            empty_cache(dev)
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        ref["j_bf16_tokens"], logits, ref["j_ms"], ref["j_bf16_kv"] = \
            seq_decode(model, cfg, c, dev)
        if dev.type == "cuda":
            ref["j_peak_gb"] = (torch.cuda.max_memory_allocated(dev)
                                - held) / 1e9
        torch.save((ref["j_bf16_tokens"], logits),
                   os.path.join(d, "j_bf16.pt"))
        del model
        empty_cache(dev)
    return ref


def empty_cache(dev) -> None:
    """Free what the caching allocator holds and nothing references (a
    cycle's tensors included: four ranks share the card)."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def dist_fit(cfg, dev, mesh, c: dict, steps: int, ck=None,
             every: int = 0) -> list:
    """``fit`` for ``steps`` of ``c``'s steps at 4 x its float32 sequence,
    on ``mesh`` -> the losses."""
    from repro_torch.data import DataConfig, Loader
    from repro_torch.launch import train

    return train.fit(cfg, steps=steps, data_loader=Loader(
        cfg, DataConfig(seed=0, batch=4, seq=c["f32_seq"])),
        ocfg=dist_ocfg(c["steps"], 1e-3), checkpointer=ck,
        checkpoint_every=every, log_every=0, device=dev, mesh=mesh)[2]


def dist_steps(cfg, dev, mesh, batch: int, seq: int, steps: int):
    """``steps`` train steps on ``make_batch`` batches of batch x seq (the
    rank's rows on ``mesh``) -> (losses, host ms of each step)."""
    from repro_torch.launch import train

    model, opt = train.init_state(0, cfg, dev, mesh)
    step = train.make_train_step(cfg, dist_ocfg(steps, TRAIN_LR), mesh)
    losses, ms = [], []
    for i in range(steps):
        b = train.shard_batch(dist_batch(cfg, batch, seq, i), cfg, mesh, dev)
        sync(dev)
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, b)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    del model, opt
    empty_cache(dev)
    return losses, ms


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def flipped(flips: list) -> tuple[int, float]:
    """``routing_tape``'s replay log -> (the (token, layer) pairs whose own
    top-k set differed from the replayed one, the largest margin)."""
    return (sum(n for n, _ in flips), max((m for _, m in flips), default=0.0))


def counted(fn, dev):
    """``fn()`` with every launch count set to 0 just before it -> (its
    result, the launches)."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = fn()
    sync(dev)
    return out, ops.launch_counts()


def moe_leg(rank: int, f32, bf16, c: dict, d: str, dev, mesh) -> dict:
    """DeepSeek-MoE 16B FULL on ``mesh`` (the (1, 4) one): legs A and B
    with ``moe_ep``, leg G as published.  The float32 model at
    MOE_F32_LAYERS (its prefill with one process's top-k sets replayed,
    against one process's logits on rank 0; its greedy tokens), then the
    bfloat16 one at every layer (its parameter bytes, a counted prefill,
    the error and argmax agreement against one process's on rank 0, one
    timed prefill after it with the collectives' counts, the peak)."""
    from repro_torch.core import sharding
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    out: dict = {}
    toks, prompt = (t.to(dev) for t in dist_tokens(c, f32.vocab))
    with torch.no_grad():
        model = transformer.init(f32, seed=0, device=dev, mesh=mesh)
        out["experts"] = (model.layers[1].ffn.experts.start,
                          model.layers[1].ffn.experts.stop)
        fwd = lambda: transformer.forward(model, f32, toks,  # noqa: E731
                                          use_kernel=True)[0]
        with routing_tape(torch.load(os.path.join(
                d, "a_f32_routing.pt"))) as flips:
            got, out["f32_launches"] = counted(fwd, dev)
        out["f32_flips"] = flipped(flips)
        if rank == 0:
            want = torch.load(os.path.join(d, "a_f32.pt")).to(dev)
            out["f32_err"] = check(
                f"dist {'TP + EP' if f32.moe_ep else 'TP, experts on model'}"
                f" f32 vs one process, its top-k sets", got, want,
                rel(want, 1e-3))
            del want
        del got
        out["tokens"] = serve.greedy_generate(model, f32, prompt,
                                              c["new"]).cpu()
        del model
        empty_cache(dev)

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        model = transformer.init(bf16, seed=0, device=dev, mesh=mesh)
        out["param_bytes"] = param_bytes(model)
        fwd = lambda: transformer.forward(model, bf16, toks,  # noqa: E731
                                          use_kernel=True)[0]
        got, out["bf16_launches"] = counted(fwd, dev)
        if rank == 0:
            want = torch.load(os.path.join(d, "a_bf16.pt")).to(dev)
            assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
            out["bf16_err"] = float((got.float() - want.float()).abs().max())
            out["bf16_agree"] = float((got.argmax(-1) == want.argmax(-1))
                                      .float().mean())
            del want
        del got
        sync(dev)
        sharding.reset_stats()
        t0 = time.perf_counter()
        fwd()
        sync(dev)
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["allreduce"] = dict(sharding.STATS)
        if dev.type == "cuda":
            out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        del model
        empty_cache(dev)
    return out


def dist_rank(rank: int, c: dict, d: str, device_type: str) -> dict:
    """One rank of the dist phase, on ``device_type`` device 0 (every rank
    on the one card): legs A, B and C, then D to F (``tp_legs``), G to I
    (``fsdp_legs``), J (``seq_legs``) and L (``cut_legs``); asserts fail
    the rank and the phase.  Returns what the parent prints."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import sharding
    from repro_torch.launch import train
    from repro_torch.runtime import elastic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device_type, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out: dict = {"rank": rank, "t0": time.time()}
    mesh = elastic.carve_mesh(model_parallel=c["world"], device_type=dev.type)
    out["mesh_a"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    marks = out["marks"] = [("mesh", time.time())]

    out.update(moe_leg(rank, c["moe_f32"], c["moe_bf16"], c, d, dev, mesh))
    marks.append(("A-B", time.time()))

    # leg C: data parallelism on (4, 1)
    m41 = elastic.carve_mesh(model_parallel=1, device_type=dev.type)
    lm = c["lm_f32"]
    model, opt = train.init_state(0, lm, dev, m41)
    host = dist_batch(lm, 4, c["f32_seq"], 0)
    b = train.shard_batch(host, lm, m41, dev)
    loss, g = train.make_grads(lm, m41)(model, b)
    out["f32_loss"] = float(loss)
    if rank == 0:
        want = torch.load(os.path.join(d, "c_grads.pt"))
        gaps = {k: float((g[k].cpu() - w).abs().max() / w.abs().max())
                for k, w in want.items()}
        worst = max(gaps, key=gaps.get)
        out["grad_worst"] = (worst, gaps[worst])
        assert gaps[worst] <= GRAD_TOL, (worst, gaps[worst])
        del want
    gnorm = float(torch.sqrt(sum((v.float() ** 2).sum() for v in g.values())))
    del g
    step = train.make_train_step(lm, dist_ocfg(c["steps"], 1e-3), m41,
                                 compress_grads=True)
    model, opt, m = step(model, opt, b)
    out["compressed"] = (float(m["loss"]), float(m["grad_norm"]), gnorm)
    del model, opt, step
    empty_cache(dev)
    out["fit"] = dist_fit(lm, dev, m41, c, c["steps"])
    ck = Checkpointer(os.path.join(d, "ck"), keep=2)
    out["fit_first"] = dist_fit(lm, dev, m41, c, c["steps"] // 2, ck,
                                c["steps"] // 2)
    m21 = elastic.simulate_failure(m41, n_lost=2, model_parallel=1)
    out["mesh_restart"] = dict(zip(m21.mesh_dim_names, m21.shape))
    if sharding.member(m21):
        out["fit_resumed"] = dist_fit(lm, dev, m21, c, c["steps"],
                                      Checkpointer(os.path.join(d, "ck")))
    empty_cache(dev)
    marks.append(("C f32 and fit", time.time()))
    out["bf16"], out["bf16_ms"] = dist_steps(c["lm_bf16"], dev, m41, 4,
                                             c["seq"], c["steps"])
    marks.append(("C bf16", time.time()))

    # leg C: expert parallelism on (2, 2)
    m22 = elastic.carve_mesh(model_parallel=2, device_type=dev.type)
    out["mesh_ep"] = dict(zip(m22.mesh_dim_names, m22.shape))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out["ep"], out["ep_ms"] = dist_steps(c["ep_train"], dev, m22, 2,
                                         c["ep_seq"], 2)
    if dev.type == "cuda":
        out["ep_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    empty_cache(dev)
    marks.append(("C EP", time.time()))
    tp_legs(rank, c, d, dev, mesh, m22, out)
    marks.append(("F", time.time()))
    fsdp_legs(rank, c, d, dev, mesh, m22, out)
    marks.append(("I", time.time()))
    seq_legs(rank, c, d, dev, m41, m22, out)
    marks.append(("J", time.time()))
    cut_legs(rank, c, d, dev, mesh, out)
    marks.append(("L", time.time()))
    return out


def seq_legs(rank: int, c: dict, d: str, dev, m41, m22, out: dict) -> None:
    """Leg J of one rank, into ``out``: H2O-Danube3's float32 cut on (4,
    1) and (2, 2), each step's logits against one process's at 1e-3 (on
    every rank: the batch is replicated), greedy tokens and the cache's
    bytes of keys and values; the bfloat16 cut on (2, 2), each step's
    host ms, the merges' collectives, the peak memory, and the argmax
    agreement with one process and the largest |diff| of the logits, fed
    the one process's greedy tokens (teacher-forced: every step compared
    on the same inputs)."""
    from repro_torch.core import sharding
    from repro_torch.models import transformer

    with torch.no_grad():
        cfg = c["j_f32"]
        want = torch.load(os.path.join(d, "j_f32.pt"))
        for name, mesh in (("m41", m41), ("m22", m22)):
            model = transformer.init(cfg, seed=0, device=dev, mesh=mesh)
            tokens, logits, _, out[f"j_{name}_kv"] = seq_decode(model, cfg,
                                                                c, dev)
            out[f"j_{name}_err"] = check(
                f"leg J f32 on {name} vs one process (rank {rank})", logits,
                want, rel(want, 1e-3))
            out[f"j_{name}_tokens"] = tokens
            del model, logits
            empty_cache(dev)

        cfg = c["j_bf16"]
        model = transformer.init(cfg, seed=0, device=dev, mesh=m22)
        empty_cache(dev)
        if dev.type == "cuda":
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        forced, want = torch.load(os.path.join(d, "j_bf16.pt"))
        sharding.reset_stats()
        out["j_tokens"], logits, out["j_ms"], out["j_kv"] = seq_decode(
            model, cfg, c, dev, forced)
        out["j_stats"] = dict(sharding.STATS)
        if dev.type == "cuda":
            out["j_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            out["j_held_gb"] = held / 1e9
        assert torch.isfinite(logits).all()
        out["j_agree"] = float((logits.argmax(-1) == want.argmax(-1))
                               .float().mean())
        out["j_err"] = float((logits - want).abs().max())
        del model
        empty_cache(dev)


def tp_legs(rank: int, c: dict, d: str, dev, mesh, m22, out: dict) -> None:
    """Legs D, E and F of one rank (``dist_rank``'s meshes: ``mesh`` the
    (1, 4) one, ``m22`` the (2, 2) one), into ``out``."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import sharding
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer
    from repro_torch.runtime import elastic

    # leg D: StableLM 2 12B, float32 at 4 layers, then bfloat16 at 40
    cfg = c["tp_f32"]
    short, long, prompt = (t.to(dev) for t in tp_tokens(c, cfg.vocab))
    with torch.no_grad():
        model = transformer.init(cfg, seed=0, device=dev, mesh=mesh)
        blk = model.layers[0].mixer
        out["d_heads"] = blk.heads
        got, out["d_f32_launches"] = counted(
            lambda: transformer.forward(model, cfg, short,
                                        use_kernel=True)[0], dev)
        if rank == 0:
            want = torch.load(os.path.join(d, "d_f32.pt")).to(dev)
            out["d_f32_err"] = check("dist TP f32 vs one process", got, want,
                                     rel(want, 1e-3))
            del want
        del got
        out["d_tokens"] = serve.greedy_generate(model, cfg, prompt,
                                                c["new"]).cpu()
        del model
        empty_cache(dev)

        cfg = c["tp_bf16"]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        model = transformer.init(cfg, seed=0, device=dev, mesh=mesh)
        out["d_param_bytes"] = param_bytes(model)
        fwd = lambda: transformer.forward(model, cfg, long,  # noqa: E731
                                          use_kernel=True)[0]
        got, out["d_bf16_launches"] = counted(fwd, dev)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        if rank == 0:
            want = torch.load(os.path.join(d, "d_bf16.pt")).to(dev)
            out["d_bf16_err"] = float((got.float() - want.float()).abs().max())
            out["d_bf16_agree"] = float((got.argmax(-1) == want.argmax(-1))
                                        .float().mean())
            del want
        del got
        sync(dev)
        sharding.reset_stats()
        t0 = time.perf_counter()
        fwd()
        sync(dev)
        out["d_ms"] = (time.perf_counter() - t0) * 1e3
        out["d_allreduce"] = dict(sharding.STATS)
        if dev.type == "cuda":
            out["d_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        del model
        empty_cache(dev)

        # leg E: the Jamba cut with moe_ep, float32
        cfg = c["hy_f32"]
        model = transformer.init(cfg, seed=0, device=dev, mesh=mesh)
        mixers = {b.desc["mixer"]: b.mixer for b in model.layers}
        mamba, attn = mixers["mamba"], mixers["attn"]
        out["e_heads"] = {"attention": attn.heads,
                          "mamba": mamba.conv.shape[1] // cfg.ssm_head_dim}
        with routing_tape(torch.load(os.path.join(
                d, "e_f32_routing.pt"))) as flips:
            got, out["e_launches"] = counted(
                lambda: transformer.forward(
                    model, cfg, tp_tokens(c, cfg.vocab)[0].to(dev),
                    use_kernel=True)[0], dev)
        out["e_flips"] = flipped(flips)
        if rank == 0:
            want = torch.load(os.path.join(d, "e_f32.pt")).to(dev)
            out["e_err"] = check(
                "dist TP + EP Jamba cut f32 vs one process, its top-k sets",
                got, want, rel(want, 5e-3))
            del want
        del got, model
        empty_cache(dev)

    out["marks"].append(("D-E", time.time()))
    # leg F: TinyLlama on (2, 2), float32
    lm = c["lm_f32"]
    model, _ = train.init_state(0, lm, dev, m22)
    b = train.shard_batch(dist_batch(lm, 4, c["f32_seq"], 0), lm, m22, dev)
    loss, g = train.make_grads(lm, m22)(model, b)
    out["f_loss"] = float(loss)
    want = torch.load(os.path.join(d, "c_grads.pt"))
    parts = transformer.leaf_parts(model)
    gaps = {}
    for k, w in want.items():
        part = w if k not in parts else parts[k][0].take(w, parts[k][1])
        gaps[k] = float((g[k].cpu() - part).abs().max() / w.abs().max())
    worst = max(gaps, key=gaps.get)
    out["f_grad_worst"] = (worst, gaps[worst])
    assert gaps[worst] <= GRAD_TOL, (rank, worst, gaps[worst])
    del model, g, want
    empty_cache(dev)
    out["f_fit"] = dist_fit(lm, dev, m22, c, c["steps"])
    ck = os.path.join(d, "ck_tp")
    out["f_first"] = dist_fit(lm, dev, m22, c, c["steps"] // 2,
                              Checkpointer(ck, keep=2), c["steps"] // 2)
    m12 = elastic.simulate_failure(m22, n_lost=2, model_parallel=2)
    out["f_mesh_restart"] = dict(zip(m12.mesh_dim_names, m12.shape))
    if sharding.member(m12):
        out["f_resumed"] = dist_fit(lm, dev, m12, c, c["steps"],
                                    Checkpointer(ck))
    empty_cache(dev)


def layer_memory(dev):
    """Record, on a CUDA device, the bytes allocated after each block of a
    forward (``transformer._block_apply``): the gate that nothing a layer
    gathered over "data" outlives it.  Yields the list."""
    from repro_torch.models import transformer

    own = transformer._block_apply
    seen: list = []

    def block(*args, **kw):
        y = own(*args, **kw)
        if dev.type == "cuda":
            seen.append(torch.cuda.memory_allocated(dev))
        return y

    @contextlib.contextmanager
    def patched():
        transformer._block_apply = block
        try:
            yield seen
        finally:
            transformer._block_apply = own
    return patched()


def layer_gathered(model) -> list[int]:
    """The bytes each layer of ``model`` gathers over "data": its FSDP
    leaves whole over "data" (the rank's block over "model"), the
    embedding and the head last, as a layer each."""
    def whole(mods) -> int:
        return sum(getattr(m, k).numel() * getattr(m, k).element_size()
                   * m.fs.size for m in mods
                   for k in getattr(m, "fsdp_dims", {}))
    return [whole(blk.modules()) for blk in model.layers] + [
        getattr(model, k).numel() * getattr(model, k).element_size()
        * model.fs.size for k in ("embed", "lm_head")]


def fsdp_legs(rank: int, c: dict, d: str, dev, mesh, m22, out: dict) -> None:
    """Legs G, H and I of one rank (``dist_rank``'s meshes), into
    ``out``: G, DeepSeek-MoE 16B FULL as published (``moe_ep`` off: the
    experts split over "model" and multiplied through ``moe_gmm``) on (1,
    4), through ``moe_leg``; H, FSDP on (2, 2): DeepSeek with ``fsdp`` in
    float32 at MOE_F32_LAYERS (each rank's row of 2 x fsdp_seq, one
    process's top-k sets replayed) and in bfloat16 at every layer (one
    prefill of 2 x prefill counted, timed, with the FSDP gathers' counts,
    the bytes held between layers and the peak), then the Jamba cut at its
    published placement in bfloat16 (2 x fsdp_seq); I, TinyLlama at
    DIST_TRAIN_LAYERS with ``fsdp`` on (2, 2): gradient parts, optimizer
    state bytes, greedy tokens, ``fit`` restored onto (2, 1)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import sharding
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer
    from repro_torch.runtime import elastic

    out["g"] = moe_leg(rank, c["g_f32"], c["g_bf16"], c, d, dev, mesh)
    out["marks"].append(("G", time.time()))

    # leg H: FSDP on (2, 2), DeepSeek in float32, then bfloat16
    cfg = c["h_f32"]
    short, long = (t.to(dev) for t in fsdp_tokens(c, cfg.vocab))
    r = train.rows(2, m22)
    S = short.shape[1]
    with torch.no_grad():
        model = transformer.init(cfg, seed=0, device=dev, mesh=m22)
        tape = [t[r.start * S:r.stop * S] for t in torch.load(
            os.path.join(d, "h_f32_routing.pt"))]
        with routing_tape(tape) as flips:
            got, out["h_f32_launches"] = counted(
                lambda: transformer.forward(model, cfg, short[r],
                                            use_kernel=True)[0], dev)
        out["h_f32_flips"] = flipped(flips)
        want = torch.load(os.path.join(d, "h_f32.pt"))[r].to(dev)
        out["h_f32_err"] = check(
            f"dist FSDP f32 vs one process, its top-k sets (rank {rank})",
            got, want, rel(want, 1e-3))
        del got, want, model
        empty_cache(dev)

        cfg = c["h_bf16"]
        model = transformer.init(cfg, seed=0, device=dev, mesh=m22)
        out["h_param_bytes"] = param_bytes(model)
        out["h_gathered"] = layer_gathered(model)
        empty_cache(dev)
        held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        sharding.reset_stats()
        sync(dev)
        t0 = time.perf_counter()
        with layer_memory(dev) as between:
            got, out["h_bf16_launches"] = counted(
                lambda: transformer.forward(model, cfg, long[r],
                                            use_kernel=True)[0], dev)
        out["h_ms"] = (time.perf_counter() - t0) * 1e3
        out["h_stats"] = dict(sharding.STATS)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        out["h_between"] = max(between, default=held) - held
        out["h_held"] = held
        out["h_out_bytes"] = got.numel() * got.element_size()
        if dev.type == "cuda":
            out["h_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        del got, model
        empty_cache(dev)

        # the Jamba cut at its published placement (fsdp=True, moe_ep off)
        cfg = c["h_jamba"]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        model = transformer.init(cfg, seed=0, device=dev, mesh=m22)
        out["hj_param_bytes"] = param_bytes(model)
        toks = fsdp_tokens(c, cfg.vocab)[0].to(dev)[r]
        got, out["hj_launches"] = counted(
            lambda: transformer.forward(model, cfg, toks,
                                        use_kernel=True)[0], dev)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        want = torch.load(os.path.join(d, "h_jamba.pt"))[r].to(dev)
        out["hj_agree"] = float((got.argmax(-1) == want.argmax(-1))
                                .float().mean())
        if dev.type == "cuda":
            out["hj_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        del got, want, model
        empty_cache(dev)

    out["marks"].append(("H", time.time()))
    # leg I: TinyLlama with FSDP on (2, 2), float32
    lm = c["i_lm"]
    model, opt = train.init_state(0, lm, dev, m22)
    out["i_opt_bytes"] = sum(t.numel() * t.element_size()
                             for k in ("master", "mu", "nu")
                             for t in opt[k].values())
    out["i_axes"] = sorted({a for lay in transformer.sharded_leaves(
        model).values() for a in lay.axes})
    b = train.shard_batch(dist_batch(lm, 4, c["f32_seq"], 0), lm, m22, dev)
    loss, g = train.make_grads(lm, m22)(model, b)
    out["i_loss"] = float(loss)
    want = torch.load(os.path.join(d, "c_grads.pt"))
    parts = transformer.leaf_parts(model)
    gaps = {}
    for k, w in want.items():
        part = w if k not in parts else parts[k][0].take(w, parts[k][1])
        gaps[k] = float((g[k].cpu() - part).abs().max() / w.abs().max())
    worst = max(gaps, key=gaps.get)
    out["i_grad_worst"] = (worst, gaps[worst])
    assert gaps[worst] <= GRAD_TOL, (rank, worst, gaps[worst])
    del g, want, opt
    model.requires_grad_(False)
    prompt = dist_tokens(c, lm.vocab)[1].to(dev)
    out["i_tokens"] = serve.greedy_generate(model, lm, prompt,
                                            c["new"]).cpu()
    out["i_token_rows"] = train.rows(2, m22)
    del model
    empty_cache(dev)
    out["i_fit"] = dist_fit(lm, dev, m22, c, c["steps"])
    ck = os.path.join(d, "ck_fsdp")
    out["i_first"] = dist_fit(lm, dev, m22, c, c["steps"] // 2,
                              Checkpointer(ck, keep=2), c["steps"] // 2)
    m21 = elastic.simulate_failure(m22, n_lost=2, model_parallel=1)
    out["i_mesh_restart"] = dict(zip(m21.mesh_dim_names, m21.shape))
    if sharding.member(m21):
        out["i_resumed"] = dist_fit(lm, dev, m21, c, c["steps"],
                                    Checkpointer(ck))
    empty_cache(dev)


def dist_phase(dev, card: str) -> dict[str, int]:
    """Expert and data parallelism over ``torch.distributed``: DIST_WORLD
    ranks, processes from ``launch.mesh.spawn``, every one on the one
    card over DIST_BACKEND with CUDA tensors (NCCL refuses two ranks a
    device).  Leg A: DeepSeek-MoE 16B FULL with ``moe_ep`` on a (1, 4)
    mesh, prefill of PREFILL tokens through ``flash_attention``: float32
    at MOE_F32_LAYERS against the one-process port at 1e-3, bfloat16 at
    all 28 layers timed once, its all-reduces' host time, each
    rank's peak memory, the largest |diff| and the argmax agreement
    against the one-process port printed; launches counted per rank
    (``flash_attention`` one a layer, ``moe_gmm`` none: the reference's
    ``apply_ep`` runs einsums, ``moe.py:175-179``).  Leg B: float32
    ``greedy_generate`` on the same mesh, tokens equal to the one-process
    ones.  Leg C: TinyLlama 1.1B FULL cut to DIST_TRAIN_LAYERS on (4, 1):
    float32 loss at 1e-4 and every gradient leaf at GRAD_TOL of its
    largest |g| against one process; one ``compress_grads`` step; ``fit``
    with a checkpoint and ``simulate_failure(n_lost=2)``, the (2, 1) mesh
    resuming to the uninterrupted losses at 1e-5; bfloat16 steps at
    4 x TRAIN_SEQ printed beside one process's; DeepSeek cut to 2 layers
    with ``moe_ep`` on (2, 2) at capacity factor 8.0, 2 steps, the loss
    against one process at DIST_EP_TOL (1 + |loss|).  Legs D, E and F:
    tensor parallelism (``tp_legs``, ``tp_report``).  Legs G, H and I:
    the experts on "model" without ``moe_ep`` and FSDP's "data" entries
    (``fsdp_legs``, ``fsdp_report``).  Leg J: the sequence-sharded decode
    cache (``seq_legs``, ``seq_report``).  Leg L: Mamba heads cut over
    "model" and parallel_block layers with other mixers (``cut_legs``,
    ``cut_report``).  Returns the launches per rank of leg A's bfloat16
    prefill ("ep"), of legs D, E and G ("tp"), of the one process's leg J
    prefill ("seq") and of leg L's prefills ("cut")."""
    import tempfile

    from repro_torch.launch import mesh as lmesh

    c = dist_configs()
    work = os.path.join(ROOT, "build", "repro_torch")
    os.makedirs(work, exist_ok=True)
    print(f"dist: {DIST_WORLD} ranks on {card} over {DIST_BACKEND} with "
          f"{dev.type} tensors")
    empty_cache(dev)
    if dev.type == "cuda":
        print(f"  {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB held by "
              f"earlier phases")
    with tempfile.TemporaryDirectory(dir=work) as d:
        t0 = time.perf_counter()
        ref = dist_reference(c, dev, d)
        held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        print(f"  one process: {time.perf_counter() - t0:.2f} s; "
              f"{held / 1e9:.2f} GB still held by this process")
        t0, wall = time.perf_counter(), time.time()
        # the ranks share the card: expandable segments keep each rank's
        # cache from holding memory in blocks it no longer fits
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            ranks = lmesh.spawn(dist_rank, c["world"], c, d, dev.type,
                                backend=DIST_BACKEND, timeout=900, workdir=d)
        finally:
            if alloc is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        start = [r["t0"] - wall for r in ranks]
        print(f"  {DIST_WORLD} ranks: {time.perf_counter() - t0:.2f} s: "
              f"started {min(start):.2f}–{max(start):.2f} s after the "
              f"launch, then {leg_seconds(ranks)}")
    r0 = ranks[0]
    moe, n_attn = c["moe_bf16"], c["moe_f32"].n_layers
    want_launches = lambda n: ({"flash_attention": n, "moe_gmm": 0}  # noqa: E731
                               if dev.type == "cuda"
                               else {"flash_attention": 0, "moe_gmm": 0})
    for r in ranks:
        assert r["mesh_a"] == {"data": 1, "model": c["world"]}, r["mesh_a"]
        for key, n in (("f32_launches", n_attn),
                       ("bf16_launches", moe.n_layers)):
            got = {k: r[key][k] for k in ("flash_attention", "moe_gmm")}
            assert got == want_launches(n), (r["rank"], key, r[key])
            assert sum(r[key].values()) == n * (dev.type == "cuda"), r[key]
        assert torch.equal(r["tokens"], ref["tokens"]), (r["tokens"],
                                                         ref["tokens"])
    E = moe.moe_experts
    print(f"  leg A: DeepSeek-MoE 16B, moe_ep on (data 1, model "
          f"{DIST_WORLD}), experts {[r['experts'] for r in ranks]} of {E}; "
          f"launches per rank f32 {want_launches(n_attn)}, bf16 "
          f"{want_launches(moe.n_layers)} (every rank)")
    print(f"  leg A f32, {n_attn} layers: TP + EP vs one process max |diff| "
          f"{r0['f32_err']:.3e} (1e-3 relative) over all {c['prefill']} "
          f"positions, routed to one process's top-k sets; the ranks' own "
          f"sets differ at {r0['f32_flips'][0]} (token, layer) pairs, by a "
          f"probability margin of at most {r0['f32_flips'][1]:.3e}")
    ar = r0["allreduce"]
    print(f"  leg A bf16, {moe.n_layers} layers, prefill 1 x {c['prefill']}:"
          f" {[round(r['prefill_ms'], 2) for r in ranks]} ms per rank "
          f"(one timed; one process {ref.get('prefill_ms', float('nan')):.2f}"
          f" ms); all-reduces per prefill on rank 0: {ar['calls']:.0f} calls,"
          f" {ar['bytes'] / 1e6:.1f} MB, {ar['seconds'] * 1e3:.2f} ms of host"
          f" time; peak memory per rank "
          f"{[round(r.get('peak_gb', 0.0), 2) for r in ranks]} GB; vs one "
          f"process max |diff| {r0['bf16_err']:.3e}, argmax agrees at "
          f"{r0['bf16_agree']:.4f}; on {card}")
    print(f"  leg B: greedy_generate f32 on the mesh, 2 x ({c['prompt']} + "
          f"{c['new']}) tokens, equal to one process's on every rank: "
          f"{ref['tokens'].tolist()}")
    assert abs(r0["f32_loss"] - ref["f32_loss"]) <= 1e-4, (r0["f32_loss"],
                                                            ref["f32_loss"])
    loss_c, norm_c, norm = r0["compressed"]
    assert np.isfinite(loss_c) and abs(norm_c - norm) <= 1e-2 * norm, (
        norm_c, norm)
    print(f"  leg C f32, TinyLlama {c['lm_f32'].n_layers} layers, 4 x "
          f"{c['f32_seq']} on (4, 1): loss {r0['f32_loss']:.6f} vs one process "
          f"{ref['f32_loss']:.6f}; worst gradient leaf {r0['grad_worst'][0]} "
          f"at {r0['grad_worst'][1]:.3e} of its largest |g|; compress_grads "
          f"step grad_norm {norm_c:.6f} vs {norm:.6f} uncompressed")
    whole = r0["fit"]
    np.testing.assert_allclose(whole, ref["f32_fit"], rtol=1e-4, atol=1e-4)
    for r in ranks:
        assert r["fit"] == whole and r["fit_first"] == whole[:len(
            r["fit_first"])]
        assert r["mesh_restart"] == {"data": 2, "model": 1}
    half = len(r0["fit_first"])
    for r in ranks[:2]:
        np.testing.assert_allclose(r["fit_resumed"], whole[half:],
                                   rtol=1e-5, atol=1e-5)
    assert all("fit_resumed" not in r for r in ranks[2:])
    print(f"  leg C restart: {len(whole)} steps on (4, 1) {whole}; "
          f"{half} + a checkpoint, 2 ranks lost, (2, 1) resumed "
          f"{ranks[0]['fit_resumed']} (1e-5); one process {ref['f32_fit']}")
    print(f"  leg C bf16, 4 x {c['seq']} on (4, 1): losses {r0['bf16']} "
          f"({[round(x, 1) for x in r0['bf16_ms']]} ms a step), one "
          f"process {ref['bf16']}; on {card}")
    for got, want in zip(r0["ep"], ref["ep"]):
        assert abs(got - want) <= DIST_EP_TOL * (1 + abs(want)), (
            r0["ep"], ref["ep"])
    print(f"  leg C EP: DeepSeek 2 layers, moe_ep on {r0['mesh_ep']}, 2 x "
          f"{c['ep_seq']}, capacity 8.0: losses {r0['ep']} "
          f"({[round(x, 1) for x in r0['ep_ms']]} ms a step), one process "
          f"{ref['ep']}; peak memory per rank "
          f"{[round(r.get('ep_peak_gb', 0.0), 2) for r in ranks]} GB")
    tp = tp_report(c, ranks, ref, dev, card)
    tp["moe_gmm"] = fsdp_report(c, ranks, ref, dev, card)["moe_gmm"]
    return {"ep": want_launches(moe.n_layers), "tp": tp,
            "seq": seq_report(c, ranks, ref, dev, card),
            "cut": cut_report(c, ranks, ref, dev, card)}


def seq_report(c: dict, ranks: list, ref: dict, dev, card: str) -> dict:
    """Leg J's gates and lines (``seq_reference``, ``seq_legs``) -> the
    launches of the one process's bfloat16 prefill."""
    cuda = int(dev.type == "cuda")
    f32, bf16, L = c["j_f32"], c["j_bf16"], c["j_max_len"]
    for key, cfg in (("j_f32_prefill_launches", f32),
                     ("j_prefill_launches", bf16)):
        want = {"flash_attention": cuda * cfg.n_layers}
        assert {k: ref[key][k] for k in want} == want, (key, ref[key])
        assert sum(ref[key].values()) == sum(want.values()), ref[key]
    # each rank's keys and values: the reference's specs' shard of the
    # whole cache, to the byte (on (4, 1) its block of L / 4 positions)
    one = reference_cache_bytes(f32, 1, L, {"data": 1, "model": 1})
    assert ref["j_f32_kv"] == one, (ref["j_f32_kv"], one)
    meshes = {"m41": {"data": 4, "model": 1}, "m22": {"data": 2, "model": 2}}
    want_kv = {m: reference_cache_bytes(f32, 1, L, dims)
               for m, dims in meshes.items()}
    assert want_kv["m41"] == (f32.n_layers * 2 * f32.n_kv_heads * (L // 4)
                              * f32.hd * 4), want_kv
    bf16_kv = reference_cache_bytes(bf16, 1, L, meshes["m22"])
    for r in ranks:
        for m in meshes:
            assert r[f"j_{m}_kv"] == want_kv[m], (r["rank"], m,
                                                  r[f"j_{m}_kv"], want_kv[m])
            assert torch.equal(r[f"j_{m}_tokens"], ref["j_tokens"]), (
                r["rank"], m, r[f"j_{m}_tokens"], ref["j_tokens"])
        assert r["j_kv"] == bf16_kv, (r["rank"], r["j_kv"], bf16_kv)
    r0 = ranks[0]
    print(f"  leg J: H2O-Danube3 4B (d {f32.d_model}, {f32.n_heads} heads, "
          f"{f32.n_kv_heads} kv heads of {f32.hd}, window {f32.window}), "
          f"batch 1, a cache of {L} positions, {c['j_new']} greedy tokens "
          f"from position {c['j_start']}; one process prefill 1 x "
          f"{c['j_prefill']} f32 {f32.n_layers} layers kernel vs plain max "
          f"|diff| {ref['j_f32_prefill_err']:.3e} (1e-3 relative), bf16 "
          f"{bf16.n_layers} layers {ref.get('j_prefill_ms', float('nan')):.2f}"
          f" ms, {ref['j_prefill_launches']['flash_attention']} flash_attention "
          f"launches")
    print(f"  leg J f32, {f32.n_layers} layers: keys and values a rank "
          f"{want_kv['m41']} B on (4, 1) and {want_kv['m22']} B on (2, 2), "
          f"equal to the byte to the reference's cache specs (one process "
          f"{one} B); every step's logits vs one process max |diff| "
          f"{max(r['j_m41_err'] for r in ranks):.3e} on (4, 1), "
          f"{max(r['j_m22_err'] for r in ranks):.3e} on (2, 2) (1e-3 "
          f"relative), on every rank; greedy tokens equal to one process's: "
          f"{ref['j_tokens'].tolist()}")
    st = r0["j_stats"]
    n = c["j_new"]
    print(f"  leg J bf16, {bf16.n_layers} layers on (data 2, model 2): "
          f"{bf16_kv / 1e9:.3f} GB of keys and values a rank (the specs'; "
          f"one process {ref['j_bf16_kv'] / 1e9:.3f} GB); ms a decode step "
          f"(median of {n}) "
          f"{[round(float(np.median(r['j_ms'])), 2) for r in ranks]} a rank,"
          f" one process {float(np.median(ref['j_ms'])):.2f}; the merges on "
          f"rank 0: {st['merge_calls'] / n:.0f} all-reduces, "
          f"{st['merge_bytes'] / n / 1e6:.4f} MB, "
          f"{st['merge_seconds'] / n * 1e3:.2f} ms of host time a step (all "
          f"collectives {st['calls'] / n:.0f}, {st['bytes'] / n / 1e6:.4f} "
          f"MB, {st['seconds'] / n * 1e3:.2f} ms); peak "
          f"{[round(r.get('j_peak_gb', 0.0), 2) for r in ranks]} GB a rank "
          f"(held before the decode "
          f"{[round(r.get('j_held_gb', 0.0), 2) for r in ranks]}; one "
          f"process {ref.get('j_peak_gb', 0.0):.2f} GB above what it held); "
          f"fed one process's greedy tokens, the argmax agrees with its at "
          f"{[round(r['j_agree'], 4) for r in ranks]} of the steps, logits "
          f"max |diff| {max(r['j_err'] for r in ranks):.3e}; on {card}")
    return {"flash_attention": ref["j_prefill_launches"]["flash_attention"]}


def cut_inputs(c: dict, cfg):
    """Leg L's prefill tokens (1, l_seq), greedy prompt (2, prompt) and,
    for a config with cross layers, float32 frontend tokens (2,
    n_frontend_tokens, d) (the prefill takes the first row), the same in
    the parent and in every rank."""
    rng = np.random.default_rng(CUT_SEED)
    toks = rng.integers(0, cfg.vocab, (1, c["l_seq"])).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab, (2, c["prompt"])).astype(np.int32)
    fr = (rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model))
          .astype(np.float32) if cfg.cross_attn_every else None)
    return tuple(None if t is None else torch.from_numpy(t)
                 for t in (toks, prompt, fr))


def cut_prefill(model, cfg, toks, fr):
    """Leg L's prefill: ``forward(use_kernel=True)``'s logits, the first
    row of the frontend ``fr`` for the cross layers."""
    from repro_torch.models import transformer
    return transformer.forward(model, cfg, toks, use_kernel=True,
                               frontend=None if fr is None else fr[:1])[0]


def cut_reference(c: dict, dev, d: str) -> dict:
    """Leg L's one process: each case's float32 prefill logits and MoE
    top-k sets (to a file in ``d``), its launches and its greedy tokens;
    then the ssd_scan kernel at every rank's cut shape
    (``cut_kernel_rows``)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    out: dict = {"l_tokens": {}, "l_launches": {}}
    t0 = time.perf_counter()
    with torch.no_grad():
        for key, cfg in c["l_cases"].items():
            toks, prompt, fr = (None if t is None else t.to(dev)
                                for t in cut_inputs(c, cfg))
            model = transformer.init(cfg, seed=0, device=dev)
            with routing_tape() as tape:
                logits, out["l_launches"][key] = counted(
                    lambda: cut_prefill(model, cfg, toks, fr), dev)
            torch.save((logits.cpu(), tape), os.path.join(d, f"l_{key}.pt"))
            out["l_tokens"][key] = serve.greedy_generate(
                model, cfg, prompt, c["l_new"], frontend=fr).cpu()
            del model, logits
    out["l_kernel"] = cut_kernel_rows(c, dev)
    out["l_seconds"] = time.perf_counter() - t0
    return out


def mamba_layers(cfg) -> int:
    """The number of Mamba layers in ``cfg``'s layer plan."""
    from repro_torch.models import transformer
    return sum(transformer._desc(cfg, li)["mixer"] == "mamba"
               for li in range(cfg.n_layers))


def cut_shapes(c: dict) -> dict:
    """Leg L's distinct cut shapes of the scan: (heads, w, N, mask) -> the
    (case, rank) pairs that run it; ``mask`` the rank's zero columns
    (heads, w) as a tuple of tuples (``layers.padded_layout``)."""
    from repro_torch.models import layers, mamba

    shapes: dict = {}
    for key, cfg in c["l_cases"].items():
        if not mamba_layers(cfg):
            continue
        _, H, P, N = mamba._dims(cfg)
        for r in range(c["world"]):
            sp = layers.head_split(H, P, c["world"], r)
            lay = layers.padded_layout(sp)
            pad = layers.pad_heads(torch.ones(sp.cols.stop - sp.cols.start),
                                   lay) == 0
            mask = tuple(map(tuple, pad.tolist()))
            shapes.setdefault((sp.n, lay[0], N, mask), []).append((key, r))
    return shapes


def cut_kernel_rows(c: dict, dev) -> list[dict]:
    """The ssd_scan kernel at each of leg L's cut shapes (``cut_shapes``):
    seeded inputs (B 1, S l_seq, the rank's heads and w, N of the config;
    x, b, c in float32 and in bfloat16, the zero columns zero; a float32
    in [0.3, 1)) against ``mamba_scan.plain`` at the kernel phase's
    tolerances (y 5e-3, 2e-2 in bfloat16; h 5e-3); on the card the
    kernel's ms (CUDA events, BIG_ITERS calls) beside its bound
    (``ssd_counts``) and the plain version's (the host's clock
    around the one call the check makes)."""
    from repro_torch.kernels import mamba_scan as kmamba
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(CUT_SEED)
    B, S, L = 1, c["l_seq"], 128
    rows = []
    for (H, P, N, mask), who in cut_shapes(c).items():
        pad = torch.tensor(mask, device=dev)
        row = {"shape": (B, S, H, P), "ranks": who,
               "zero_columns": int(pad.sum())}
        for dtype in (torch.float32, torch.bfloat16):
            name = f"leg L ssd_scan {str(dtype)[6:]} {(B, S, H, P)}"
            x = torch.randn((B, S, H, P), generator=g, device=dev)
            x = x.masked_fill(pad, 0.0).to(dtype)
            a = torch.rand((B, S, H), generator=g, device=dev) * 0.7 + 0.3
            b = torch.randn((B, S, N), generator=g, device=dev).to(dtype)
            cc = torch.randn((B, S, N), generator=g, device=dev).to(dtype)
            y, h = ops.ssd_scan(x, a, b, cc, chunk=L)
            sync(dev)
            t0 = time.perf_counter()
            wy, wh = kmamba.plain(x, a, b, cc)
            sync(dev)
            plain_ms = (time.perf_counter() - t0) * 1e3
            bf16 = dtype == torch.bfloat16
            err = check(f"{name} y", y, wy, rel(wy, 2e-2 if bf16 else 5e-3))
            check(f"{name} h", h, wh, rel(wh, 5e-3))
            assert not y[..., pad].any() and not h.transpose(1, 2)[
                ..., pad].any(), name
            ms, why = bound(*ssd_counts(x, a, b, cc, L),
                            BF16_TC_OPS_PER_S if bf16 else F32_OPS_PER_S)
            key = "bf16" if bf16 else "f32"
            row[key] = {"max_abs_err": err, "bound_ms": ms, "bound_by": why,
                        "plain_ms": plain_ms,
                        "ms": (cuda_ms(lambda: ops.ssd_scan(
                            x, a, b, cc, chunk=L), BIG_ITERS)
                               if dev.type == "cuda" else None)}
        rows.append(row)
    return rows


def cut_legs(rank: int, c: dict, d: str, dev, mesh, out: dict) -> None:
    """Leg L of one rank on ``mesh`` (the (1, 4) one), into ``out``: for
    each case its parameter bytes, the columns of each Mamba layer's
    heads it scans, a counted float32 prefill (routed to one process's
    top-k sets) against one process's logits at every position, and
    greedy tokens."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    t0 = time.time()
    with torch.no_grad():
        for key, cfg in c["l_cases"].items():
            toks, prompt, fr = (None if t is None else t.to(dev)
                                for t in cut_inputs(c, cfg))
            model = transformer.init(cfg, seed=0, device=dev, mesh=mesh)
            out[f"l_{key}_bytes"] = param_bytes(model)
            out[f"l_{key}_widths"] = [b.mixer.split.widths()
                                      for b in model.layers
                                      if b.desc["mixer"] == "mamba"]
            want, tape = torch.load(os.path.join(d, f"l_{key}.pt"))
            with routing_tape(tape) as flips:
                got, out[f"l_{key}_launches"] = counted(
                    lambda: cut_prefill(model, cfg, toks, fr), dev)
            out[f"l_{key}_flips"] = flipped(flips)
            want = want.to(dev)
            tol = 5e-3 if cfg.family == "hybrid" else 1e-3
            out[f"l_{key}_err"] = check(
                f"leg L ({key}) f32 vs one process (rank {rank})", got, want,
                rel(want, tol))
            out[f"l_{key}_tokens"] = serve.greedy_generate(
                model, cfg, prompt, c["l_new"], frontend=fr).cpu()
            del model, got, want
            empty_cache(dev)
    out["l_seconds"] = time.time() - t0


def cut_report(c: dict, ranks: list, ref: dict, dev, card: str) -> dict:
    """Leg L's gates and lines (``cut_reference``, ``cut_legs``) -> the
    ssd_scan launches a rank of its prefills."""
    from repro_torch.models import layers, mamba

    cuda, m = int(dev.type == "cuda"), c["world"]
    for key, cfg in c["l_cases"].items():
        fields = CUT_CASES[key][1]
        n_mamba = mamba_layers(cfg)
        want_bytes = reference_bytes(cfg, {"data": 1, "model": m})
        one = ref["l_launches"][key]
        assert one["ssd_scan"] == cuda * n_mamba, (key, one)
        _, H, P, _ = mamba._dims(cfg)
        for r in ranks:
            i = r["rank"]
            assert r[f"l_{key}_launches"] == one, (key, i,
                                                   r[f"l_{key}_launches"])
            assert r[f"l_{key}_bytes"] == want_bytes, (
                key, i, r[f"l_{key}_bytes"], want_bytes)
            assert r[f"l_{key}_widths"] == [layers.head_split(
                H, P, m, i).widths()] * n_mamba, (key, i)
            assert torch.equal(r[f"l_{key}_tokens"], ref["l_tokens"][key]), (
                key, i, r[f"l_{key}_tokens"], ref["l_tokens"][key])
        flips = max((r[f"l_{key}_flips"] for r in ranks), key=lambda t: t[0])
        mixers = (f"{n_mamba} Mamba layers of {H} heads of {P}, columns a "
                  f"rank {[r[f'l_{key}_widths'][:1] for r in ranks]}"
                  if n_mamba else "no Mamba layer")
        print(f"  leg L ({key}) {cfg.name} {fields}, float32 on (1, {m}): "
              f"{mixers}; prefill 1 x "
              f"{c['l_seq']} vs one process max |diff| "
              f"{max(r[f'l_{key}_err'] for r in ranks):.3e} "
              f"({'5e-3' if cfg.family == 'hybrid' else '1e-3'} relative) "
              f"at every position of every rank (the ranks' own top-k sets "
              f"differ at {flips[0]} (token, layer) pairs, margin at most "
              f"{flips[1]:.3e}); launches a rank "
              f"{ {k: v for k, v in one.items() if v} }, the one process's; "
              f"{want_bytes} B of parameters a rank, the reference's specs'; "
              f"greedy 2 x ({c['prompt']} + {c['l_new']}) tokens equal to one "
              f"process's on every rank")
    for row in ref["l_kernel"]:
        f32, bf16 = row["f32"], row["bf16"]
        print(f"  leg L ssd_scan at {row['shape']} (ranks {row['ranks']}, "
              f"{row['zero_columns']} zero columns): float32 "
              f"max |diff| {f32['max_abs_err']:.3e} (5e-3), {fmt(f32['ms'])} "
              f"ms, bound {f32['bound_ms']:.3e} ms ({f32['bound_by']}), plain "
              f"{f32['plain_ms']:.2f} ms; bfloat16 {bf16['max_abs_err']:.3e} "
              f"(2e-2), {fmt(bf16['ms'])} ms, bound {bf16['bound_ms']:.3e} ms "
              f"({bf16['bound_by']}), plain {bf16['plain_ms']:.2f} ms; on "
              f"{card}")
    print(f"  leg L: {ref['l_seconds']:.2f} s in the one process, "
          f"{max(r['l_seconds'] for r in ranks):.2f} s in the ranks")
    return {"ssd_scan": sum(ranks[0][f"l_{k}_launches"]["ssd_scan"]
                            for k in c["l_cases"])}


def tp_report(c: dict, ranks: list, ref: dict, dev, card: str) -> dict:
    """Legs D, E and F's gates and lines (``tp_legs``) -> the launches a
    rank of leg D's bfloat16 prefill and of leg E's forward."""
    r0, cuda = ranks[0], int(dev.type == "cuda")
    tp, hy, m = c["tp_bf16"], c["hy_f32"], c["world"]
    from repro_torch.models import attention

    want = reference_bytes(tp, {"data": 1, "model": m})
    kv = attention.kv_heads(tp, m, 0)
    for r in ranks:
        assert r["d_heads"] == (tp.n_heads // m, kv.stop - kv.start), r
        for key, n in (("d_f32_launches", c["tp_f32"].n_layers),
                       ("d_bf16_launches", tp.n_layers)):
            assert r[key]["flash_attention"] == n * cuda, (key, r[key])
            assert sum(r[key].values()) == n * cuda, (key, r[key])
        assert torch.equal(r["d_tokens"], ref["tp_tokens"]), (
            r["d_tokens"], ref["tp_tokens"])
        assert r["d_param_bytes"] == want, (r["rank"], r["d_param_bytes"],
                                            want)
        kv = attention.kv_heads(hy, m, 0)
        assert r["e_heads"] == {"attention": (hy.n_heads // m,
                                              kv.stop - kv.start),
                                "mamba": 2 * hy.d_model // hy.ssm_head_dim
                                // m}, r["e_heads"]
        e = {k: r["e_launches"][k] for k in ("flash_attention", "moe_gmm",
                                             "ssd_scan")}
        assert e == {"flash_attention": cuda, "moe_gmm": 0,
                     "ssd_scan": cuda}, r["e_launches"]
    ar = r0["d_allreduce"]
    print(f"  leg D: StableLM 2 12B on (data 1, model {m}): "
          f"{r0['d_param_bytes'] / 1e9:.3f} GB of bfloat16 parameters a "
          f"rank, equal to the byte to the reference's specs on one device "
          f"of (1, {m}) ({want} B; one process holds "
          f"{ref['tp_param_gb']:.3f} GB); heads a rank {r0['d_heads']}")
    print(f"  leg D f32, {c['tp_f32'].n_layers} layers, prefill 1 x "
          f"{c['tp_seq']}: TP vs one process max |diff| {r0['d_f32_err']:.3e}"
          f" (1e-3 relative); greedy 2 x ({c['prompt']} + {c['new']}) "
          f"tokens equal to one process's on every rank")
    print(f"  leg D bf16, {tp.n_layers} layers, prefill 1 x {c['prefill']}: "
          f"{[round(r['d_ms'], 2) for r in ranks]} ms per rank (one timed; "
          f"one process {ref.get('tp_prefill_ms', float('nan')):.2f} ms); "
          f"all-reduces and gathers per prefill on rank 0: "
          f"{ar['calls']:.0f} calls, {ar['bytes'] / 1e6:.1f} MB, "
          f"{ar['seconds'] * 1e3:.2f} ms of host time; flash_attention "
          f"{r0['d_bf16_launches']['flash_attention']} launches a rank; peak "
          f"memory per rank {[round(r.get('d_peak_gb', 0.0), 2) for r in ranks]}"
          f" GB; vs one process max |diff| {r0['d_bf16_err']:.3e}, argmax "
          f"agrees at {r0['d_bf16_agree']:.4f}; on {card} (4 ranks on one "
          f"card: the all-reduces go through the host, not a 4-card mesh's "
          f"times)")
    print(f"  leg E: the Jamba cut, {hy.n_layers} layers, moe_ep on (1, {m}),"
          f" float32, prefill 1 x {c['tp_seq']}: vs one process max |diff| "
          f"{r0['e_err']:.3e} (5e-3 relative) over all positions, routed to "
          f"one process's top-k sets (the ranks' own differ at "
          f"{r0['e_flips'][0]} (token, layer) pairs, margin at most "
          f"{r0['e_flips'][1]:.3e}); a rank's heads {r0['e_heads']}, launches "
          f"{ {k: v for k, v in r0['e_launches'].items() if v} }")
    whole = r0["f_fit"]
    np.testing.assert_allclose(whole, ref["f32_fit"], rtol=1e-4, atol=1e-4)
    assert abs(r0["f_loss"] - ref["f32_loss"]) <= 1e-4, (r0["f_loss"],
                                                          ref["f32_loss"])
    for r in ranks:
        assert r["f_fit"] == whole and r["f_first"] == whole[:len(
            r["f_first"])]
        assert r["f_mesh_restart"] == {"data": 1, "model": 2}
    half = len(r0["f_first"])
    for r in ranks[:2]:
        np.testing.assert_allclose(r["f_resumed"], whole[half:],
                                   rtol=1e-5, atol=1e-5)
    assert all("f_resumed" not in r for r in ranks[2:])
    worst = max((r["f_grad_worst"] for r in ranks), key=lambda t: t[1])
    print(f"  leg F f32, TinyLlama {c['lm_f32'].n_layers} layers, 4 x "
          f"{c['f32_seq']} on (2, 2): loss {r0['f_loss']:.6f} vs one process "
          f"{ref['f32_loss']:.6f}; worst gradient part {worst[0]} at "
          f"{worst[1]:.3e} of its largest |g|; {len(whole)} steps {whole}; "
          f"{half} + a checkpoint, 2 ranks lost, (1, 2) resumed "
          f"{r0['f_resumed']} (1e-5)")
    return {"flash_attention": tp.n_layers * cuda, "ssd_scan": cuda}


def fsdp_report(c: dict, ranks: list, ref: dict, dev, card: str) -> dict:
    """Legs G, H and I's gates and lines (``fsdp_legs``) -> the launches a
    rank of leg G's bfloat16 prefill."""
    from repro_torch.models import transformer

    r0, cuda = ranks[0], int(dev.type == "cuda")
    m = c["world"]
    g32, g16, h16, hj = c["g_f32"], c["g_bf16"], c["h_bf16"], c["h_jamba"]

    def launches(cfg) -> dict:
        descs = [transformer._desc(cfg, li) for li in range(cfg.n_layers)]
        return {"flash_attention": cuda * sum(
                    x["mixer"] == "attn" for x in descs),
                "moe_gmm": 2 * cuda * sum(x["ffn"] == "moe" for x in descs)}
    g_bytes = reference_bytes(g16, {"data": 1, "model": m})
    for r in ranks:
        g = r["g"]
        assert g["param_bytes"] == g_bytes, (r["rank"], g["param_bytes"],
                                             g_bytes)
        for key, cfg in (("f32_launches", g32), ("bf16_launches", g16)):
            want = launches(cfg)
            assert {k: g[key][k] for k in want} == want, (key, g[key])
            assert sum(g[key].values()) == sum(want.values()), g[key]
        assert torch.equal(g["tokens"], ref["tokens"]), (g["tokens"],
                                                         ref["tokens"])
    g = r0["g"]
    ar = g["allreduce"]
    print(f"  leg G: DeepSeek-MoE 16B as published (moe_ep off) on (data 1, "
          f"model {m}): {g['param_bytes'] / 1e9:.3f} GB of bfloat16 "
          f"parameters a rank, equal to the byte to the reference's specs "
          f"on one device of (1, {m}) ({g_bytes} B; one process "
          f"{reference_bytes(g16, {}) / 1e9:.3f} GB); experts "
          f"{[r['g']['experts'] for r in ranks]}; launches a rank f32 "
          f"{launches(g32)}, bf16 {launches(g16)}")
    print(f"  leg G f32, {g32.n_layers} layers: vs one process max |diff| "
          f"{g['f32_err']:.3e} (1e-3 relative) over all {c['prefill']} "
          f"positions, routed to one process's top-k sets; the ranks' own "
          f"sets differ at {g['f32_flips'][0]} (token, layer) pairs, by a "
          f"probability margin of at most {g['f32_flips'][1]:.3e}; greedy "
          f"2 x ({c['prompt']} + {c['new']}) tokens equal to one process's "
          f"on every rank")
    print(f"  leg G bf16, {g16.n_layers} layers, prefill 1 x {c['prefill']}:"
          f" {[round(r['g']['prefill_ms'], 2) for r in ranks]} ms per rank "
          f"(one timed; one process {ref.get('prefill_ms', float('nan')):.2f}"
          f" ms); collectives per prefill on rank 0: {ar['calls']:.0f} "
          f"calls, {ar['bytes'] / 1e6:.1f} MB, {ar['seconds'] * 1e3:.2f} ms "
          f"of host time; peak memory per rank "
          f"{[round(r['g'].get('peak_gb', 0.0), 2) for r in ranks]} GB; vs "
          f"one process max |diff| {g['bf16_err']:.3e}, argmax agrees at "
          f"{g['bf16_agree']:.4f}; on {card}")

    dims = {"data": 2, "model": 2}
    h_bytes = reference_bytes(h16, dims)
    hj_bytes = reference_bytes(hj, dims)
    h32 = c["h_f32"]
    for r in ranks:
        assert r["h_param_bytes"] == h_bytes, (r["rank"], r["h_param_bytes"],
                                               h_bytes)
        assert r["hj_param_bytes"] == hj_bytes, (r["rank"],
                                                 r["hj_param_bytes"], hj_bytes)
        for key, cfg in (("h_f32_launches", h32), ("h_bf16_launches", h16)):
            want = launches(cfg)
            assert {k: r[key][k] for k in want} == want, (key, r[key])
            assert sum(r[key].values()) == sum(want.values()), r[key]
        assert {k: r["hj_launches"][k] for k in ("flash_attention",
                                                  "ssd_scan")} == {
            "flash_attention": cuda, "ssd_scan": cuda}, r["hj_launches"]
        # nothing gathered outlives its layer: at no layer boundary does
        # a rank hold, beyond what it held before the prefill, as much as
        # the least any layer gathers
        assert r["h_between"] < min(r["h_gathered"]), (
            r["rank"], r["h_between"], min(r["h_gathered"]))
    st = r0["h_stats"]
    flips = sum(r["h_f32_flips"][0] for r in ranks)
    margin = max(r["h_f32_flips"][1] for r in ranks)
    print(f"  leg H: DeepSeek-MoE 16B with fsdp on (data 2, model 2): "
          f"{r0['h_param_bytes'] / 1e9:.3f} GB of bfloat16 parameters a rank,"
          f" equal to the byte to the reference's specs ({h_bytes} B); f32, "
          f"{h32.n_layers} layers, 2 x {c['fsdp_seq']} (a row a data rank): "
          f"vs one process max |diff| "
          f"{max(r['h_f32_err'] for r in ranks):.3e} (1e-3 relative) at "
          f"every position of every rank, routed to one process's top-k "
          f"sets (the ranks' own differ at {flips} (token, layer) pairs, "
          f"margin at most {margin:.3e})")
    print(f"  leg H bf16, {h16.n_layers} layers, prefill 2 x {c['prefill']} "
          f"(one timed): {[round(r['h_ms'], 2) for r in ranks]} ms per rank;"
          f" FSDP gathers on rank 0: {st['fsdp_calls']} calls, "
          f"{st['fsdp_bytes'] / 1e6:.1f} MB, {st['fsdp_seconds'] * 1e3:.2f} "
          f"ms of host time (all collectives {st['calls']} calls, "
          f"{st['bytes'] / 1e6:.1f} MB, {st['seconds'] * 1e3:.2f} ms); "
          f"launches a rank {launches(h16)}; memory a rank: held "
          f"{r0['h_held'] / 1e9:.3f} GB before the prefill, at most "
          f"{max(r['h_between'] for r in ranks) / 1e6:.1f} MB more between "
          f"layers (gate: below the least a layer gathers, "
          f"{min(r0['h_gathered']) / 1e6:.1f} MB: no gathered leaf "
          f"outlives its layer); a layer gathers at most "
          f"{max(r0['h_gathered']) / 1e9:.3f} GB; logits "
          f"{r0['h_out_bytes'] / 1e6:.1f} MB; peak "
          f"{[round(r.get('h_peak_gb', 0.0), 2) for r in ranks]} GB; on "
          f"{card}")
    print(f"  leg H Jamba cut ({hj.n_layers} layers at full width, fsdp, "
          f"moe_ep off) bf16, 2 x {c['fsdp_seq']}: "
          f"{r0['hj_param_bytes'] / 1e9:.3f} GB of parameters a rank, equal "
          f"to the byte to the reference's specs ({hj_bytes} B; one process "
          f"{reference_bytes(hj, {}) / 1e9:.3f} GB); launches a rank "
          f"{ {k: v for k, v in r0['hj_launches'].items() if v} }; peak "
          f"{[round(r.get('hj_peak_gb', 0.0), 2) for r in ranks]} GB; argmax "
          f"agrees with one process at "
          f"{[round(r['hj_agree'], 4) for r in ranks]}")

    lm = c["i_lm"]
    opt_bytes = 3 * reference_bytes(lm, dims)
    one = 3 * reference_bytes(lm, {})
    assert abs(r0["i_loss"] - ref["f32_loss"]) <= 1e-4, (r0["i_loss"],
                                                         ref["f32_loss"])
    for r in ranks:
        assert r["i_axes"] == ["data", "model"], r["i_axes"]
        assert r["i_opt_bytes"] == opt_bytes, (r["i_opt_bytes"], opt_bytes)
        assert torch.equal(r["i_tokens"], ref["i_tokens"][r["i_token_rows"]])
    whole = r0["i_fit"]
    np.testing.assert_allclose(whole, ref["f32_fit"], rtol=1e-4, atol=1e-4)
    for r in ranks:
        assert r["i_fit"] == whole and r["i_first"] == whole[:len(
            r["i_first"])]
        assert r["i_mesh_restart"] == {"data": 2, "model": 1}
    half = len(r0["i_first"])
    for r in ranks[:2]:
        np.testing.assert_allclose(r["i_resumed"], whole[half:],
                                   rtol=1e-5, atol=1e-5)
    assert all("i_resumed" not in r for r in ranks[2:])
    worst = max((r["i_grad_worst"] for r in ranks), key=lambda t: t[1])
    print(f"  leg I f32, TinyLlama {lm.n_layers} layers with fsdp, 4 x "
          f"{c['f32_seq']} on (2, 2): loss {r0['i_loss']:.6f} vs one process "
          f"{ref['f32_loss']:.6f}; worst gradient part {worst[0]} at "
          f"{worst[1]:.3e} of its largest |g|; optimizer state "
          f"{r0['i_opt_bytes'] / 1e6:.1f} MB a rank, {r0['i_opt_bytes'] / one:.4f}"
          f" of one process's; greedy tokens equal to one process's rows; "
          f"{len(whole)} steps {whole}; {half} + a checkpoint, 2 ranks lost, "
          f"(2, 1) resumed {r0['i_resumed']} (1e-5)")
    return launches(g16)


def split_configs() -> dict:
    """Leg K's models and sizes (one picklable dict: the ranks take
    everything from it): musicgen-medium FULL cut to SPLIT_F32_LAYERS in
    float32 and to SPLIT_BF16_LAYERS in bfloat16, xlstm-125m FULL whole in
    float32, on (1, world) and (2, world / 2)."""
    from repro_torch.configs import get_config

    mg, xl = get_config(SPLIT_ARCH), get_config(XLSTM_ARCH)
    return {"mg_f32": dataclasses.replace(mg, n_layers=SPLIT_F32_LAYERS,
                                          dtype=torch.float32),
            "mg_bf16": dataclasses.replace(mg, n_layers=SPLIT_BF16_LAYERS),
            "xl_f32": dataclasses.replace(xl, dtype=torch.float32),
            "prefill": PREFILL, "xl_seq": SPLIT_XLSTM_SEQ,
            "prompt": SPLIT_PROMPT, "new": SPLIT_NEW, "world": SPLIT_WORLD,
            "mg_layers": mg.n_layers}


def split_meshes(c: dict) -> dict:
    """Leg K's meshes as {name: {axis: size}}: (1, world) and (2, world /
    2)."""
    return {"m1": {"data": 1, "model": c["world"]},
            "m2": {"data": 2, "model": c["world"] // 2}}


def split_inputs(c: dict, dev):
    """Leg K's inputs, the same in the parent and in every rank:
    musicgen's frame embeddings (1, prefill, d) float32, drawn on ``dev``
    from SPLIT_SEED, and its prompt (1, prompt); xlstm's tokens (2,
    xl_seq) and prompt (2, prompt)."""
    mg, xl = c["mg_f32"], c["xl_f32"]
    g = torch.Generator(device=dev).manual_seed(SPLIT_SEED)
    embeds = torch.randn((1, c["prefill"], mg.d_model), generator=g,
                         device=dev)
    rng = np.random.default_rng(SPLIT_SEED)
    return (embeds, *(torch.from_numpy(rng.integers(0, v, shape).astype(
        np.int32)).to(dev) for v, shape in (
            (mg.vocab, (1, c["prompt"])), (xl.vocab, (2, c["xl_seq"])),
            (xl.vocab, (2, c["prompt"])))))


def within(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Max |got - want| in float32; every element within tol * (1 +
    |want|) (``check`` without its line: each rank's worst is printed by
    the report)."""
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all() and bool((err <= rel(want, tol)).all()), (
        float(err.max()))
    return float(err.max())


def split_reference(c: dict, dev, d: str) -> dict:
    """Leg K in one process: musicgen's float32 cut (prefill logits to
    ``d``, launches, greedy tokens), its bfloat16 cut (logits to ``d``,
    launches, host ms), xlstm's float32 prefill (logits to ``d``) and
    greedy tokens; every model freed before the ranks start."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    ref = {}
    embeds, mg_prompt, xl_toks, xl_prompt = split_inputs(c, dev)
    with torch.no_grad():
        cfg = c["mg_f32"]
        model = transformer.init(cfg, seed=0, device=dev)
        got, ref["mg_f32_launches"] = counted(lambda: transformer.forward(
            model, cfg, embeds=embeds, use_kernel=True)[0], dev)
        torch.save(got.cpu(), os.path.join(d, "k_mg_f32.pt"))
        del got
        ref["mg_tokens"] = serve.greedy_generate(model, cfg, mg_prompt,
                                                 c["new"]).cpu()
        del model
        empty_cache(dev)
        cfg = c["mg_bf16"]
        model = transformer.init(cfg, seed=0, device=dev)
        x = embeds.to(cfg.dtype)
        fwd = lambda: transformer.forward(model, cfg, embeds=x,  # noqa: E731
                                          use_kernel=True)[0]
        got, ref["mg_bf16_launches"] = counted(fwd, dev)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        torch.save(got.cpu(), os.path.join(d, "k_mg_bf16.pt"))
        del got
        if dev.type == "cuda":
            ref["mg_bf16_ms"] = host_ms(fwd)
        del model
        empty_cache(dev)
        cfg = c["xl_f32"]
        model = transformer.init(cfg, seed=0, device=dev)
        got, ref["xl_launches"] = counted(
            lambda: transformer.forward(model, cfg, xl_toks)[0], dev)
        torch.save(got.cpu(), os.path.join(d, "k_xl_f32.pt"))
        chunked, _ = transformer.forward(
            model, dataclasses.replace(cfg, mlstm_chunk=MLSTM_CHUNK), xl_toks)
        ref["xl_spread"] = float(((got - chunked).abs()
                                  / (1 + chunked.abs())).max())
        del got, chunked
        torch.save(mlstm_layer_io(model, cfg, xl_toks),
                   os.path.join(d, "k_xl_layers.pt"))
        ref["xl_tokens"] = serve.greedy_generate(model, cfg, xl_prompt,
                                                 c["new"]).cpu()
        del model
        empty_cache(dev)
    return ref


def mlstm_layer_io(model, cfg, toks) -> list:
    """Each mLSTM layer's input (the normed hidden state) and output in the
    forward of ``toks``, on the CPU."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import rms_norm

    x, io = model.embed[toks], []
    for blk in model.layers:
        h = rms_norm(x, blk.norm1)
        mo = transformer._mix(blk, cfg, h, None, False)
        if blk.desc["mixer"] == "mlstm":
            io.append((h.cpu(), mo.cpu()))
        x = x + mo
    return io


def split_rank(rank: int, c: dict, d: str, device_type: str) -> dict:
    """Leg K of one rank, on ``device_type`` device 0 (every rank on the
    one card): musicgen's float32 cut on (1, world) against one process's
    logits at 1e-3 and its greedy tokens, each rank's parameter and cache
    bytes; its bfloat16 cut counted and timed once, with the collectives
    (``STATS``, the head gathers' ``heads_`` keys apart) and the peak;
    xlstm's float32 prefill on (1, world) and (2, world / 2): each mLSTM
    layer on the one process's input of the rank's rows against its
    output at 1e-3, the stack's logits' relative gap (printed beside the
    one process's own parallel vs chunked gap: through 12 float32 layers
    the stack moves further than one layer, PERF.md), its greedy tokens
    and its cache's bytes; the wall-clock time at each leg's end.  Asserts fail
    the rank and the leg."""
    from repro_torch.core import sharding
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer, xlstm
    from repro_torch.runtime import elastic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device_type, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out: dict = {"rank": rank, "t0": time.time()}
    w = c["world"]
    meshes = {"m1": elastic.carve_mesh(model_parallel=w, device_type=dev.type),
              "m2": elastic.carve_mesh(model_parallel=w // 2,
                                       device_type=dev.type)}
    embeds, mg_prompt, xl_toks, xl_prompt = split_inputs(c, dev)
    L = c["prompt"] + c["new"]
    marks = out["marks"] = [("meshes", time.time())]
    with torch.no_grad():
        cfg = c["mg_f32"]
        model = transformer.init(cfg, seed=0, device=dev, mesh=meshes["m1"])
        out["mg_heads"] = model.layers[0].mixer.heads
        out["mg_f32_bytes"] = param_bytes(model)
        got, out["mg_f32_launches"] = counted(lambda: transformer.forward(
            model, cfg, embeds=embeds, use_kernel=True)[0], dev)
        out["mg_f32_err"] = within(got, torch.load(os.path.join(
            d, "k_mg_f32.pt")).to(dev), 1e-3)
        del got
        marks.append(("musicgen f32", time.time()))
        out["mg_tokens"] = serve.greedy_generate(model, cfg, mg_prompt,
                                                 c["new"]).cpu()
        out["mg_cache"] = cache_parts(serve.make_cache(model, cfg, 1, L))
        del model
        empty_cache(dev)
        marks.append(("musicgen greedy", time.time()))

        cfg = c["mg_bf16"]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        model = transformer.init(cfg, seed=0, device=dev, mesh=meshes["m1"])
        out["mg_bf16_bytes"] = param_bytes(model)
        x = embeds.to(cfg.dtype)
        fwd = lambda: transformer.forward(model, cfg, embeds=x,  # noqa: E731
                                          use_kernel=True)[0]
        got, out["mg_bf16_launches"] = counted(fwd, dev)
        want = torch.load(os.path.join(d, "k_mg_bf16.pt")).to(dev)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        out["mg_bf16_err"] = float((got.float() - want.float()).abs().max())
        out["mg_bf16_agree"] = float((got.argmax(-1) == want.argmax(-1))
                                     .float().mean())
        del got, want
        sync(dev)
        sharding.reset_stats()
        t0 = time.perf_counter()
        fwd()
        sync(dev)
        out["mg_ms"] = (time.perf_counter() - t0) * 1e3
        out["mg_stats"] = dict(sharding.STATS)
        if dev.type == "cuda":
            out["mg_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        del model
        empty_cache(dev)
        marks.append(("musicgen bf16", time.time()))

        cfg = c["xl_f32"]
        whole = torch.load(os.path.join(d, "k_xl_f32.pt"))
        io = torch.load(os.path.join(d, "k_xl_layers.pt"))
        for name, mesh in meshes.items():
            model = transformer.init(cfg, seed=0, device=dev, mesh=mesh)
            mixer = next(b.mixer for b in model.layers
                         if b.desc["mixer"] == "mlstm")
            out[f"xl_{name}_split"] = (mixer.split.n, mixer.v_layout[0])
            out[f"xl_{name}_bytes"] = param_bytes(model)
            rows = train.rows(2, mesh)
            out[f"xl_{name}_rows"] = (rows.start, rows.stop)
            sharding.reset_stats()
            got, out[f"xl_{name}_launches"] = counted(
                lambda: transformer.forward(model, cfg, xl_toks[rows])[0],
                dev)
            out[f"xl_{name}_stats"] = dict(sharding.STATS)
            marks.append((f"xlstm {name} forward", time.time()))
            want = whole[rows].to(dev)
            out[f"xl_{name}_stack"] = float(((got - want).abs()
                                             / (1 + want.abs())).max())
            del got, want
            mlstm = [b.mixer for b in model.layers
                     if b.desc["mixer"] == "mlstm"]
            out[f"xl_{name}_err"] = max(
                within(xlstm.apply_mlstm(p, cfg, h[rows].to(dev)),
                       mo[rows].to(dev), 1e-3)
                for p, (h, mo) in zip(mlstm, io))
            marks.append((f"xlstm {name} layers", time.time()))
            out[f"xl_{name}_tokens"] = serve.greedy_generate(
                model, cfg, xl_prompt, c["new"]).cpu()
            out[f"xl_{name}_cache"] = cache_parts(serve.make_cache(
                model, cfg, 2, L))
            del model
            empty_cache(dev)
            marks.append((f"xlstm {name} greedy", time.time()))
        del whole, io
        if dev.type == "cuda":
            out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def split_phase(dev, card: str) -> dict[str, int]:
    """Leg K: tensor parallelism inside a head, ``world`` ranks (processes
    from ``launch.mesh.spawn``) on the one card over DIST_BACKEND with
    CUDA tensors, in one launch (``split_rank``; the one process's
    references first, ``split_reference``), then ``split_report`` ->
    the launches a rank of musicgen's bfloat16 prefill."""
    import tempfile

    from repro_torch.launch import mesh as lmesh

    c = split_configs()
    work = os.path.join(ROOT, "build", "repro_torch")
    os.makedirs(work, exist_ok=True)
    print(f"split: leg K, {c['world']} ranks on {card} over {DIST_BACKEND} "
          f"with {dev.type} tensors")
    empty_cache(dev)
    with tempfile.TemporaryDirectory(dir=work) as d:
        t0 = time.perf_counter()
        ref = split_reference(c, dev, d)
        print(f"  one process: {time.perf_counter() - t0:.2f} s")
        t0, wall = time.perf_counter(), time.time()
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            ranks = lmesh.spawn(split_rank, c["world"], c, d, dev.type,
                                backend=DIST_BACKEND, timeout=600, workdir=d)
        finally:
            if alloc is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        start = [r["t0"] - wall for r in ranks]
        print(f"  {c['world']} ranks: {time.perf_counter() - t0:.2f} s: "
              f"started {min(start):.2f}–{max(start):.2f} s after the "
              f"launch, meshes at "
              f"{max(r['marks'][0][1] for r in ranks) - wall:.2f} s, then "
              f"{leg_seconds(ranks)}")
    return split_report(c, ranks, ref, dev, card)


def leg_seconds(ranks: list) -> str:
    """The seconds of each leg the ranks marked (``out["marks"]``: the
    first mark, then one at each leg's end), the last rank's."""
    legs, at = [], max(r["marks"][0][1] for r in ranks)
    for i, (label, _) in enumerate(ranks[0]["marks"][1:], 1):
        end = max(r["marks"][i][1] for r in ranks)
        legs.append(f"{label} {end - at:.2f}")
        at = end
    return f"(s, the last rank's) {', '.join(legs)}"


def split_report(c: dict, ranks: list, ref: dict, dev, card: str) -> dict:
    """Leg K's gates and lines (``split_rank``) -> the launches a rank of
    musicgen's bfloat16 prefill."""
    from repro_torch.models import attention, layers, xlstm

    cuda = int(dev.type == "cuda")
    f32, bf16, xl = c["mg_f32"], c["mg_bf16"], c["xl_f32"]
    meshes = split_meshes(c)
    L = c["prompt"] + c["new"]
    m = c["world"]
    for key, cfg in (("mg_f32_launches", f32), ("mg_bf16_launches", bf16)):
        want = {"flash_attention": cuda * cfg.n_layers}
        assert {k: ref[key][k] for k in want} == want, (key, ref[key])
        for r in ranks:
            assert {k: r[key][k] for k in want} == want, (r["rank"], key,
                                                         r[key])
            assert sum(r[key].values()) == sum(want.values()), r[key]
    spec = reference_cache_parts(f32, 1, L, meshes["m1"])
    whole = reference_cache_parts(f32, 1, L, {"data": 1, "model": 1})
    for r in ranks:
        kv = attention.kv_heads(f32, m, r["rank"])
        kept = kv.stop - kv.start
        assert r["mg_heads"] == (kept, kept), r["mg_heads"]
        assert r["mg_cache"]["kv"] * f32.n_kv_heads == whole["kv"] * kept
        assert torch.equal(r["mg_tokens"], ref["mg_tokens"]), (
            r["rank"], r["mg_tokens"], ref["mg_tokens"])
        for key, cfg in (("mg_f32_bytes", f32), ("mg_bf16_bytes", bf16)):
            assert r[key] == reference_bytes(cfg, meshes["m1"]), (
                r["rank"], key, r[key])
    r0 = ranks[0]
    kept = r0["mg_heads"][0]
    print(f"  leg K: {f32.name} (d {f32.d_model}, {f32.n_heads} heads "
          f"of {f32.hd}, MHA) on (data 1, model {m}): "
          f"{f32.n_heads * f32.hd // m} columns a rank, "
          f"{f32.n_heads * f32.hd / m / f32.hd:g} heads, {kept} heads "
          f"computed a rank ({kept * m} for {f32.n_heads}); parameters a "
          f"rank equal to the byte to the reference's specs: "
          f"{r0['mg_f32_bytes']} B at {f32.n_layers} layers float32, "
          f"{r0['mg_bf16_bytes']} B at {bf16.n_layers} bfloat16")
    print(f"  leg K f32, {f32.n_layers} layers, prefill of 1 x {c['prefill']}"
          f" seeded frame embeddings: vs one process max |diff| "
          f"{max(r['mg_f32_err'] for r in ranks):.3e} (1e-3 relative) on "
          f"every rank; flash_attention {r0['mg_f32_launches']['flash_attention']}"
          f" launches a rank; greedy 1 x ({c['prompt']} + {c['new']}) tokens "
          f"equal to one process's on every rank: {ref['mg_tokens'].tolist()};"
          f" keys and values a rank {r0['mg_cache']['kv']} B, {kept} of "
          f"{f32.n_kv_heads} kv heads whole: "
          f"{r0['mg_cache']['kv'] / spec['kv']:.4f} x the reference's cache "
          f"specs' {spec['kv']} B (one process {whole['kv']} B)")
    st = r0["mg_stats"]
    print(f"  leg K bf16, {bf16.n_layers} of {c['mg_layers']} layers, "
          f"prefill 1 x "
          f"{c['prefill']}: {[round(r['mg_ms'], 2) for r in ranks]} ms a rank "
          f"(one timed; one process "
          f"{ref.get('mg_bf16_ms', float('nan')):.2f} ms); flash_attention "
          f"{r0['mg_bf16_launches']['flash_attention']} launches a rank; the "
          f"head gathers on rank 0: {st['heads_calls']} calls, "
          f"{st['heads_bytes'] / 1e6:.1f} MB, {st['heads_seconds'] * 1e3:.2f}"
          f" ms of host time (all collectives {st['calls']}, "
          f"{st['bytes'] / 1e6:.1f} MB, {st['seconds'] * 1e3:.2f} ms); peak "
          f"{[round(r.get('mg_peak_gb', 0.0), 2) for r in ranks]} GB a rank; "
          f"vs one process max |diff| "
          f"{max(r['mg_bf16_err'] for r in ranks):.3e}, argmax agrees at "
          f"{min(r['mg_bf16_agree'] for r in ranks):.4f}; on {card}")
    assert not any(ref["xl_launches"].values()), ref["xl_launches"]
    for name, dims in meshes.items():
        M, D = dims["model"], dims["data"]
        spec = reference_cache_parts(xl, 2, L, dims)
        params = reference_bytes(xl, dims)
        for r in ranks:
            assert not any(r[f"xl_{name}_launches"].values()), r
            assert r[f"xl_{name}_bytes"] == params, (r["rank"], name)
            a, b = r[f"xl_{name}_rows"]
            assert b - a == 2 // D
            assert torch.equal(r[f"xl_{name}_tokens"],
                               ref["xl_tokens"][a:b]), (r["rank"], name)
            sp = xlstm.mlstm_split(xl, M, r["rank"] % M)
            assert r[f"xl_{name}_split"] == (sp.n,
                                             layers.padded_layout(sp)[0])
            assert r[f"xl_{name}_cache"]["C"] == spec["C"], (
                r["rank"], name, r[f"xl_{name}_cache"], spec)
        r0 = ranks[0]
        n, cols = r0[f"xl_{name}_split"]
        st = r0[f"xl_{name}_stats"]
        print(f"  leg K {xl.name} f32, {xl.n_layers} layers on (data {D}, "
              f"model {M}): {cols} columns a rank in {n} of {xl.n_heads} "
              f"heads of {xl.d_model // xl.n_heads} "
              f"({cols / (xl.d_model // xl.n_heads):g} of a head); prefill "
              f"{2 // D} x {c['xl_seq']} a rank: each mLSTM layer vs one "
              f"process max |diff| "
              f"{max(r[f'xl_{name}_err'] for r in ranks):.3e} (1e-3 "
              f"relative), the stack's logits "
              f"{max(r[f'xl_{name}_stack'] for r in ranks):.3e} relative "
              f"(not held: the one process's own parallel vs chunked "
              f"{ref['xl_spread']:.3e}); head gathers of the prefill on "
              f"rank 0 {st['heads_calls']} calls, "
              f"{st['heads_bytes'] / 1e6:.1f} MB, "
              f"{st['heads_seconds'] * 1e3:.2f} ms (all collectives "
              f"{st['calls']}, {st['bytes'] / 1e6:.1f} MB, "
              f"{st['seconds'] * 1e3:.2f} ms); greedy 2 x "
              f"({c['prompt']} + {c['new']}) tokens equal to one process's "
              f"rows on every rank; parameters a rank {params} B, the "
              f"specs'; cache a rank C {r0[f'xl_{name}_cache']['C']} B (the "
              f"specs' {spec['C']} B), n {r0[f'xl_{name}_cache']['n']} B "
              f"(specs' {spec['n']} B), m {r0[f'xl_{name}_cache']['m']} B "
              f"(specs' {spec['m']} B); no launch")
    print(f"  leg K peak memory "
          f"{[round(r.get('peak_gb', 0.0), 2) for r in ranks]} GB a rank")
    return {"flash_attention": ranks[0]["mg_bf16_launches"]["flash_attention"]}


def dryrun_record(d: str, cell: tuple, flags=()) -> dict:
    """The record the dry-run wrote for ``cell`` under ``flags`` into
    ``d``."""
    return json.load(open(dryrun_path(d, cell, flags)))


def dryrun_path(d: str, cell: tuple, flags=()) -> str:
    """The file of ``cell``'s record (the reference's names)."""
    from repro_torch.configs import get_config

    arch, shape, mesh = cell
    name = "2x16x16" if mesh == "multi" else "16x16"
    tag = "opt-" + "-".join(flags) + "_" if flags else ""
    return os.path.join(d, f"{tag}{get_config(arch).name}_{shape}_{name}"
                           ".json")


def dryrun_cmd(d: str, cell: tuple, flags=()) -> list:
    arch, shape, mesh = cell
    return ([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", d]
            + (["--opt", ",".join(flags)] if flags else []))


def run_together(cmds: list, env: dict, timeout: float = 600) -> list:
    """Every command of ``cmds`` started at once -> (returncode, stdout,
    stderr, seconds from the start to its exit) of each; none is left
    running."""
    import threading

    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs: list = [None] * len(procs)

    def wait(i: int) -> None:
        try:
            o, e = procs[i].communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            procs[i].kill()
            o, e = procs[i].communicate()
        outs[i] = (procs[i].returncode, o, e, time.perf_counter() - t0)
    threads = [threading.Thread(target=wait, args=(i,))
               for i in range(len(procs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def dryrun_phase(dev, card: str, examples: bool = False) -> None:
    """Leg a: ``python3 -m repro_torch.launch.dryrun`` on each of
    DRYRUN_CELLS; leg a': ``--opt tp1`` on each of DRYRUN_TP1 and ``--opt
    dp_all`` on DRYRUN_REFUSED; legs b and b': DRYRUN_CHILDREN's ranks on
    ``dev``, each in a child (``dryrun_child``); with ``examples`` the
    examples phase's processes (``example_cmds``); all at once.  Then
    each record is read back and checked (``dryrun_report``,
    ``tp1_report``), the refusal read from the CLI's output, each
    child's bytes held to its cell's record, and each example's output
    checked (``examples_report``)."""
    import tempfile

    work = os.path.join(ROOT, "build", "repro_torch")
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    labels = ([f"{a} {sh}" for a, sh, _ in DRYRUN_CELLS]
              + [f"{a} {sh} --opt tp1" for a, sh, _ in DRYRUN_TP1]
              + [f"{DRYRUN_REFUSED[0]} {DRYRUN_REFUSED[1]} --opt dp_all"]
              + [f"leg {leg}" for leg in DRYRUN_CHILDREN])
    with tempfile.TemporaryDirectory(dir=work) as d:
        t0 = time.perf_counter()
        cmds = ([dryrun_cmd(d, cell) for cell in DRYRUN_CELLS]
                + [dryrun_cmd(d, cell, ("tp1",)) for cell in DRYRUN_TP1]
                + [dryrun_cmd(d, DRYRUN_REFUSED, ("dp_all",))]
                + [[sys.executable, os.path.abspath(__file__),
                    "--dryrun-child", dev.type, leg]
                   for leg in DRYRUN_CHILDREN])
        n_dry = len(cmds)
        outs = run_together(cmds + (example_cmds(dev) if examples else []),
                            env)
        outs, shown = outs[:n_dry], outs[n_dry:]
        n1 = len(DRYRUN_CELLS) + len(DRYRUN_TP1)
        refused, children = outs[n1], outs[n1 + 1:]
        for i, (cmd, (rc, out, err, _)) in enumerate(zip(cmds, outs)):
            if i != n1:
                assert rc == 0, (cmd, rc, err[-3000:])
        for rc, out, _, _ in outs[:n1]:
            assert out.rstrip().endswith(
                "[dryrun] all requested cells traced OK"), out[-3000:]
        print(f"dryrun: {n_dry} processes (legs a, a', b, b')"
              f"{' and the examples' if examples else ''} at once: "
              f"{time.perf_counter() - t0:.2f} s (the records name "
              f"{card.split(',')[0]}); each process's seconds: "
              + ", ".join(f"{lb} {o[3]:.2f}" for lb, o in zip(labels, outs)))
        if examples:
            examples_report(dev, shown)
        recs = [dryrun_record(d, cell) for cell in DRYRUN_CELLS]
        tp1 = [dryrun_record(d, cell, ("tp1",)) for cell in DRYRUN_TP1]
        # dp_all: the reference's jit refuses a batch that the data axes
        # and "model" do not divide; the CLI fails there and writes no
        # record
        rc, out, _, _ = refused
        arch, shape, _ = DRYRUN_REFUSED
        assert rc != 0 and "batch 32 does not split over 256 ranks of " \
            "('data', 'model')" in out, (rc, out[-3000:])
        assert not os.path.exists(dryrun_path(d, DRYRUN_REFUSED,
                                              ("dp_all",)))
        print(f"  {arch} x {shape} x 16x16 --opt dp_all: refused, exit "
              f"{rc}: " + next(line for line in out.splitlines()
                               if "does not split" in line).strip())
    dryrun_report(recs)
    tp1_report(tp1)
    for (leg, (cell, flags)), child in zip(DRYRUN_CHILDREN.items(),
                                           children):
        want = (recs[DRYRUN_CELLS.index(cell)] if not flags
                else tp1[DRYRUN_TP1.index(cell)])["memory_per_device"]
        got = json.loads(child[1].strip().splitlines()[-1])
        keys = ("parameters", "gradients", "optimizer_state", "cache")
        for k in keys:
            assert got[k] == want[k], (leg, k, got[k], want[k])
        arch, shape, _ = cell
        line = (f"  leg {leg}: {arch} x {shape}"
                f"{' --opt ' + ','.join(flags) if flags else ''} rank 0 on "
                f"{dev.type}, one step in {got['seconds']:.2f} s: "
                + ", ".join(f"{k.replace('_', ' ')} {got[k]} B" for k in keys)
                + ", equal to the meta trace's to the byte; ")
        peak = want["total_per_device"]
        if got["peak"] is None:
            line += (f"the trace's peak {peak / 1e9:.3f} GB; the card's not "
                     f"measured")
        else:
            line += (f"torch.cuda.max_memory_allocated "
                     f"{got['peak'] / 1e9:.3f} GB beside the trace's peak "
                     f"{peak / 1e9:.3f} GB: ratio {got['peak'] / peak:.4f}")
        print(line)


def tp1_report(recs: list) -> None:
    """Leg a''s gates: each tp1 record traced, its parameters a rank the
    reference's specs without "model" (``reference_bytes(tp1=True)``);
    train: gradients the parameters', optimizer state six times them and
    the step, no collective but the data-parallel all-reduces; decode:
    fits 80 GB (leg b' runs it on the card), its keys and values every
    kv head over the rank's rows, 16 times the reference's cache specs'
    (which still split them over "model": ROADMAP queue 3)."""
    from repro_torch.configs import SHAPES, get_config

    for cell, rec in zip(DRYRUN_TP1, recs):
        arch, shape, mesh = cell
        cfg, dims = get_config(arch), DRYRUN_MESHES[mesh]
        mem = rec["memory_per_device"]
        assert rec["status"] == "OK", (cell, rec["status"])
        assert mem["parameters"] == reference_bytes(cfg, dims, tp1=True), (
            cell, mem["parameters"], reference_bytes(cfg, dims, tp1=True))
        c = rec["collectives"]
        extra = ""
        if SHAPES[shape].kind == "train":
            assert mem["gradients"] == mem["parameters"]
            assert mem["optimizer_state"] == 6 * mem["parameters"] + 4
            assert set(c["by_kind"]) == {"all-reduce"}, c["by_kind"]
        else:
            assert rec["hbm_ok"], (cell, mem["total_per_device"])
            sh = SHAPES[shape]
            rows = sh.batch // dims["data"]
            kv = mem["cache"] - cfg.n_layers * 4 * rows     # int32 lens
            whole = cfg.n_layers * 2 * sh.batch * cfg.n_kv_heads * sh.seq \
                * cfg.hd * 2
            assert kv * dims["data"] == whole, (mem["cache"], whole)
            spec = reference_cache_bytes(cfg, sh.batch, sh.seq, dims)
            assert kv == 16 * spec, (kv, spec)
            extra = (f"; keys and values a rank {kv} B, every kv head of its "
                     f"rows: {kv / spec:.4f} x the reference's cache "
                     f"specs' {spec} B")
        print(f"  {arch} x {shape} x {rec['mesh']} --opt tp1: peak "
              f"{mem['total_per_device'] / 1e9:.3f} GB a rank (fits 80 GB: "
              f"{rec['hbm_ok']}; parameters {mem['parameters'] / 1e9:.3f}, "
              f"{mem['parameters'] / reference_bytes(cfg, dims):.4f} x the "
              f"specs' with 'model'; activations "
              f"{mem['activations'] / 1e9:.3f}, temporaries "
              f"{mem['temporaries'] / 1e9:.3f}); "
              f"{rec['cost_per_device']['flops']:.4e} FLOPs a rank; "
              f"collectives {c['count']}"
              + "".join(f", {k} {v['count']} x {v['bytes'] / 1e6:.1f} MB"
                        for k, v in sorted(c["by_kind"].items()))
              + f"{extra}; traced in {rec['trace_seconds']:.2f} s")


def dryrun_report(recs: list) -> None:
    """Leg a's gates: each record traced ("OK"), named the card of
    ``core.perfmodel.GpuModel`` and tested ``hbm_ok`` against its 80 GB;
    the parameter bytes a rank the reference's specs' (``reference_bytes``);
    TinyLlama's gradients its parameters' and its optimizer state six
    times them (master, mu, nu in float32) and the step; DeepSeek's
    collectives its MoE layers' all-reduces and the logits' gather; the
    Danube rank's keys and values its block of 524,288 positions of the
    kv heads it keeps."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention

    for cell, rec in zip(DRYRUN_CELLS, recs):
        arch, shape, mesh = cell
        cfg, dims = get_config(arch), DRYRUN_MESHES[mesh]
        mem = rec["memory_per_device"]
        assert rec["status"] == "OK", (cell, rec["status"])
        assert rec["card"] == "NVIDIA H100 80GB HBM3, 700.00 W", rec["card"]
        assert rec["hbm_ok"] == (mem["total_per_device"] <= 80 * 10**9)
        assert mem["parameters"] == reference_bytes(cfg, dims), (
            cell, mem["parameters"], reference_bytes(cfg, dims))
        c = rec["collectives"]
        assert c["count"] == sum(k["count"] for k in c["by_kind"].values())
        assert rec["cost_per_device"]["flops"] > 0 and c["count"] > 0
        bound = max(rec["roofline"][f"t_{k}_s"]
                    for k in ("compute", "memory", "collective"))
        print(f"  {arch} x {shape} x {rec['mesh']}: peak "
              f"{mem['total_per_device'] / 1e9:.3f} GB a rank (fits 80 GB: "
              f"{rec['hbm_ok']}; parameters {mem['parameters'] / 1e9:.3f}, "
              f"gradients {mem['gradients'] / 1e9:.3f}, optimizer "
              f"{mem['optimizer_state'] / 1e9:.3f}, cache "
              f"{mem['cache'] / 1e9:.3f}, activations "
              f"{mem['activations'] / 1e9:.3f}, temporaries "
              f"{mem['temporaries'] / 1e9:.3f}); "
              f"{rec['cost_per_device']['flops']:.4e} FLOPs, "
              f"{rec['cost_per_device']['bytes']:.4e} bytes a rank; "
              f"collectives {c['count']}, "
              + ", ".join(f"{k} {v['count']} x {v['bytes'] / 1e6:.1f} MB"
                          for k, v in sorted(c["by_kind"].items()))
              + f"; bound {rec['roofline']['bound']} {bound:.4f} s; "
              f"traced in {rec['trace_seconds']:.2f} s")
    tiny, deep, danube = (r["memory_per_device"] for r in recs)
    assert tiny["gradients"] == tiny["parameters"]
    assert tiny["optimizer_state"] == 6 * tiny["parameters"] + 4
    kinds = recs[1]["collectives"]["by_kind"]
    assert set(kinds) == {"all-reduce", "all-gather"}, kinds
    assert kinds["all-gather"]["count"] == 1, kinds
    cfg = get_config(DRYRUN_CELLS[2][0])
    kv = attention.kv_heads(cfg, 16, 0)
    kept = kv.stop - kv.start if isinstance(kv, slice) else len(kv)
    whole = cfg.n_layers * 2 * cfg.n_kv_heads * SEQ_MAX_LEN * cfg.hd * 2
    kv = danube["cache"] - cfg.n_layers * 4        # each layer's int32 len
    assert kv * cfg.n_kv_heads * 16 == whole * kept, (danube["cache"], whole,
                                                      kept)
    spec = reference_cache_bytes(cfg, 1, SEQ_MAX_LEN, DRYRUN_MESHES["single"])
    print(f"  {cfg.name}: keys and values a rank {kv} B, its 1/16 of the "
          f"positions of {kept} of {cfg.n_kv_heads} kv heads: "
          f"{kv / spec:.4f} x the reference's cache specs' {spec} B (which "
          f"split the positions over 'data' alone)")


def dryrun_child(device: str, leg: str) -> None:
    """Leg b or b' (DRYRUN_CHILDREN): the cell's rank 0 built on
    ``device`` (its weights uninitialised) over the fake group of 256
    ranks and its step run once; prints a JSON line of its parameter,
    gradient, optimizer-state and cache bytes, the step's seconds and,
    on a card, the step's ``torch.cuda.max_memory_allocated`` ("peak";
    None elsewhere).  Values are not checked: over a fake group the
    collectives move nothing."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    (arch, shape, mesh), flags = DRYRUN_CHILDREN[leg]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    with dryrun.fake_world(256):
        m = make_production_mesh(multi_pod=mesh == "multi",
                                 device_type="cpu")
        t = dryrun.trace_cell(get_config(arch), SHAPES[shape], m,
                              opt_flags=flags, device=dev)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        t.step()
        if cuda:
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
    held = {k: sum(x.numel() * x.element_size()
                   for x in dryrun._tensors(t.held.get(k, [])))
            for k in ("optimizer_state", "cache")}
    print(json.dumps({
        "parameters": param_bytes(t.model),
        "gradients": sum(t.grads.values()), **held,
        "seconds": secs,
        "peak": torch.cuda.max_memory_allocated(dev) if cuda else None}))


def example_cmds(dev) -> list:
    """EXAMPLES as a user starts them: ``python3 examples/<name>.py`` on
    the card (``--device`` elsewhere)."""
    return [[sys.executable, os.path.join(ROOT, "examples", f"{name}.py")]
            + (["--device", dev.type] if dev.type != "cuda" else [])
            for name in EXAMPLES]


def examples_report(dev, outs: list) -> None:
    """Each example's process (``run_together``'s outputs, in EXAMPLES'
    order) ended with 0 and printed its closing check line (results
    against ``ref()``, the decode engine's tokens against
    ``greedy_generate``): a line for each, with its seconds."""
    for (name, check), (rc, out, err, secs) in zip(EXAMPLES.items(), outs):
        assert rc == 0, (name, rc, err[-3000:])
        assert check in out, (name, out[-3000:])
        line = next(ln for ln in out.splitlines() if check in ln)
        print(f"  examples/{name}.py on {dev.type}: exit 0 at {secs:.2f} s "
              f"from the start: {line.strip()}")


def examples_phase(dev) -> None:
    """The examples phase alone: EXAMPLES' processes at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    examples_report(dev, run_together(example_cmds(dev), env))


def held_line(dev, after: str) -> None:
    """The device memory still allocated after a phase (what the next
    phases start from)."""
    gc.collect()
    print(f"memory: {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB "
          f"allocated after {after}")


def main() -> int:
    argv = sys.argv[1:]
    if "--dryrun-child" in argv:    # dryrun_phase's leg b or b'
        sys.path.insert(0, os.path.join(ROOT, "src"))
        i = argv.index("--dryrun-child")
        dryrun_child(argv[i + 1], argv[i + 2])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import cuda_lib

    if "--restart-child" in argv:   # restart_leg's child: deterministic
        torch.use_deterministic_algorithms(True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        restart_run(torch.device("cuda", 0))
        return 0
    only = (set(argv[argv.index("--only") + 1].split(","))
            if "--only" in argv else None)
    assert only is None or only <= set(PHASES), f"--only takes {PHASES}"
    run = lambda phase: only is None or phase in only  # noqa: E731
    kind, smi = torch.cuda.get_device_name(0), smi_line()
    print(f"device: {kind}  ({smi}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    paths, log = cuda_lib.build()
    cuda_lib.library()
    print(f"build: {time.perf_counter() - t0:.2f} s, one nvcc per source -> "
          + ", ".join(os.path.relpath(p, ROOT) for p in paths))
    for line in ptxas_summary(log):
        print(f"  ptxas: {line}")
    if "--build" in argv:
        return 0

    dev = torch.device("cuda", 0)
    held = lambda after: held_line(dev, after)  # noqa: E731
    rows: list[dict] = []
    if run("kernels"):
        print("kernels (2,048 banks; against the plain PyTorch version):")
        rows = kernel_phase(dev)
        held("kernels")
    row = {r["name"]: r for r in rows}
    if run("suite"):
        args_2048: dict = {}
        t0 = time.perf_counter()
        counts, serialized = suite_phase(args_2048)
        print(f"suite: {time.perf_counter() - t0:.2f} s; launches {counts}")
        held("suite")
        # every kernel has a row; each row's launches come from the path
        # that runs it: the suite's five kernels from the suite,
        # flash_attention from one TinyLlama prefill forward, moe_gmm from
        # one DeepSeek-MoE forward, ssd_scan from one forward of the Jamba
        # cut (phases below)
        assert not rows or sorted(counts) == sorted(row), counts
        for name, r in row.items():
            r["launches"] = counts[name]
        for kernel in ("flash_attention", "moe_gmm", "ssd_scan"):
            assert counts[kernel] == 0, counts
        if run("session"):
            t0 = time.perf_counter()
            session_counts = session_phase(args_2048, serialized)
            print(f"session: {time.perf_counter() - t0:.2f} s; launches "
                  f"{session_counts} (the chunked phases run the plain "
                  f"oracles)")
            t0 = time.perf_counter()
            flat_session_phase(args_2048)
            print(f"flat session: {time.perf_counter() - t0:.2f} s")
            held("session")
        del serialized
    else:
        args_2048 = {}
    if run("tune"):
        t0 = time.perf_counter()
        tune_counts = tune_phase(args_2048)
        print(f"tune: {time.perf_counter() - t0:.2f} s; launches "
              f"{tune_counts}")
        held("tune")
        for name, r in row.items():
            r["tune_launches"] = tune_counts[name]
    del args_2048

    from repro_torch.configs import get_config
    if run("lm"):
        t0 = time.perf_counter()
        # one seeded float32 TinyLlama for the three LM legs; only the bf16
        # timing leg of prefill_phase builds its own
        from repro_torch.models import transformer
        model = transformer.init(
            dataclasses.replace(get_config(LM_ARCH), dtype=torch.float32),
            seed=0, device=dev)
        launches = prefill_phase(model, dev)
        if "flash_attention" in row:
            row["flash_attention"]["launches"] = launches
        consistency_phase(model, dev)
        print(f"prefill + consistency: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        decode_phase(model, dev)
        print(f"decode: {time.perf_counter() - t0:.2f} s")
        del model
        torch.cuda.empty_cache()
        held("lm")
    if run("moe"):
        t0 = time.perf_counter()
        counts = family_phase(MOE_ARCH, MOE_F32_LAYERS,
                              get_config(MOE_ARCH).n_layers, 1e-3, dev)
        if "moe_gmm" in row:
            row["moe_gmm"]["launches"] = counts["moe_gmm"]
        print(f"moe: {time.perf_counter() - t0:.2f} s")
        held("moe")
    if run("hybrid"):
        t0 = time.perf_counter()
        counts = family_phase(HYBRID_ARCH, HYBRID_LAYERS, HYBRID_LAYERS, 5e-3,
                              dev)
        if "ssd_scan" in row:
            row["ssd_scan"]["launches"] = counts["ssd_scan"]
        print(f"hybrid: {time.perf_counter() - t0:.2f} s")
        held("hybrid")
    if run("vlm"):
        t0 = time.perf_counter()
        counts = vlm_phase(dev)
        if "flash_attention" in row:
            row["flash_attention"]["vision_launches"] = \
                counts["flash_attention"]
        print(f"vlm: {time.perf_counter() - t0:.2f} s")
        held("vlm")
    if run("xlstm"):
        t0 = time.perf_counter()
        counts = xlstm_phase(dev)
        assert not any(counts.values()), counts
        print(f"xlstm: {time.perf_counter() - t0:.2f} s")
        held("xlstm")
    if run("train"):
        t0 = time.perf_counter()
        counts = train_phase(dev, smi)
        if "flash_attention" in row:
            row["flash_attention"]["train_eval_launches"] = \
                counts["flash_attention"]
        print(f"train: {time.perf_counter() - t0:.2f} s")
        held("train")
    if run("dist"):
        t0 = time.perf_counter()
        counts = dist_phase(dev, smi)
        for name in ("flash_attention", "moe_gmm"):
            if name in row:
                row[name]["dist_launches_per_rank"] = counts["ep"][name]
        for name in ("flash_attention", "ssd_scan", "moe_gmm"):
            if name in row:
                row[name]["tp_launches_per_rank"] = counts["tp"][name]
        if "flash_attention" in row:
            row["flash_attention"]["danube_prefill_launches"] = \
                counts["seq"]["flash_attention"]
        if "ssd_scan" in row:
            row["ssd_scan"]["cut_launches_per_rank"] = \
                counts["cut"]["ssd_scan"]
        print(f"dist: {time.perf_counter() - t0:.2f} s")
        held("dist")
    if run("split"):
        t0 = time.perf_counter()
        counts = split_phase(dev, smi)
        if "flash_attention" in row:
            row["flash_attention"]["split_launches_per_rank"] = \
                counts["flash_attention"]
        print(f"split: {time.perf_counter() - t0:.2f} s")
        held("split")
    if run("dryrun"):
        # the examples' processes start with the dry-run's
        t0 = time.perf_counter()
        dryrun_phase(dev, smi, examples=run("examples"))
        both = " and examples" if run("examples") else ""
        print(f"dryrun{both}: {time.perf_counter() - t0:.2f} s")
        held(f"dryrun{both}")
    elif run("examples"):
        t0 = time.perf_counter()
        examples_phase(dev)
        print(f"examples: {time.perf_counter() - t0:.2f} s")
        held("examples")
    for r in rows:
        print(f"  {r['name']:15s} {r.get('launches', '-')} wrapper launches "
              f"on its path; {fmt(r['cuda_launches_per_call'])} CUDA "
              f"launches per wrapper call")
    if only is None:
        missing = [r["name"] for r in rows if r["launches"] <= 0]
        assert not missing, f"the main path launched no {missing}"

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
