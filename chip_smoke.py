#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a card and ``nvcc``.
Phases, each printed as it ends; any failure raises and exits non-zero:

1. device — the card's name and power limit, as ``nvidia-smi`` gives them;
2. build — K1-K7 compiled from ``src/repro_torch/kernels/csrc`` (sm_90a),
   one ``nvcc`` per source, all at once; registers and spills of each;
   the registers, shared memory and spills of every tensor-core K1-K4
   kernel and of K3/K4's narrow-N and mixed kernels, and (where
   ``cuobjdump`` is present) the HMMA/HGMMA, LDGSTS and LDSM instructions
   of the K1-K4 libraries, per kernel: none of the tensor cores fails;
3. kernels — K1 and K2 against their plain PyTorch versions, in bf16 and
   float32, at every projection shape of the served model (decode M=2,
   prefill M=64), at ragged shapes with ``counts == 0`` blocks and
   partial last slices, at split-heavy shapes (few tiles, K = 16384) and
   at whisper-base's encoder shapes (bf16, 6000 rows and the stems);
   bf16 timings (CUDA events and the profiler's device time) at the
   served and whisper shapes beside the bound, the plain version and
   ``torch.matmul`` (a yardstick only);
4. grouped kernels — K3 and K4 against their plain versions at the two
   decode attention products of a 4096-slot cache holding 257 and 271
   tokens (bf16, float32, and the served value's float32 p against bf16
   V), and at a ragged shape with an empty problem on every route's
   types; each shape's route, splits, CUDA events and device time (the
   host's share between them) beside the bound, the bytes of B read, the
   plain version and ``torch.bmm`` over the whole capacity; the wrapper's
   host time at the served shapes, by part; then the dense GQA families'
   first decode over a 32768-slot cache holding 3000 tokens (yi-34b G = 7,
   qwen1.5-110b G = 8, chatglm3-6b G = 16): the score on the narrow route
   at N = G and the value on the mixed route, K3 and K4 against their
   plain walks, with route, splits, steps and times;
5. conv kernels — K5, K6 and K7 bit-equal to their plain versions in bf16
   and float32 at whisper-base's stem shapes (4 segments, conv1 k=1x3 s=1
   over 80 mel bins, conv2 s=2 over 512 channels), the vision patch shape
   (560 x 560 x 3, k = s = 14) and ragged shapes that take every route of
   K5, K6 and K7; at the stem shapes, bf16, each kernel's route and blocks,
   device time (K5's by pass) and CUDA events beside the byte bound, the
   achieved bytes per second, the plain version and ``F.unfold``;
6. reference — the smoke models (nemotron, whisper) on the card against
   the CPU plain path, the sparse-KV modes included;
7. serving — full-width ``nemotron-4-340b`` cut to 2 layers (random bf16
   weights from a seed) through ``generate``: dense, dual (K1) and
   dual+kcondense (K2), 2 prompts of 32 tokens, 8 new tokens each; each
   kernel must launch exactly 13 dispatches x 8 forwards = 104 times in
   its run, prefill logits must match dense, and greedy tokens may part
   from dense only where dense's top-2 logits are within the tolerance;
8. serving, sparse KV — the same model, 2 prompts of 256 tokens in a
   4096-slot context, 16 new tokens: dual with plain caches (the
   baseline), dual+kv (K1 + K3) and dual+kc+kv (K2 + K4).  K3 (K4) must
   launch 2 sites x 2 layers x 15 decodes = 60 times and K1 (K2) 13 x 16 =
   208 times; prefill logits equal the same mode's without the sparse
   cache; decode logits, fed the baseline's tokens, stay within the
   tolerance of the baseline's; the tape's attention entries execute what
   they count, less than dense; then one decode attention call is split
   into planning, operand copies, kernels and the rest;
9. serving, whisper — full-width, full-depth ``whisper-base`` (random bf16
   weights) through ``generate``: 4 segments of 3000 mel frames, the
   4-token start-of-transcript prompt, 32 new tokens, in dense, dual and
   dual+kc; launches exactly K5 2, K6 1, K7 1 and K1 (K2) 1618; the stem
   convs execute what they count; prefill logits and tokens against dense
   as in 7; then the stem convs of one prefill are split into K5, K6/K7,
   the lowering glue, planning, K1/K2 and the rest, beside ``F.conv2d``;
10. pruned serving, traffic A — the model of 7 in dual and dual+kc through
   its own prefill/decode loop over ``Transformer.forward``, unpruned with
   per-call and with cached weight plans (``plan_weight_activities``,
   built once, as the JAX engine builds them); then every layer's
   mlp.w_up and mlp.w_down block-pruned in place (``block_mask`` at
   sparsity 0.5 in (slice_k, block_n) tiles; layer 0's mask on the card
   held against the CPU's), dense, and dual and dual+kc with per-call and
   with cached plans.  Each run: tokens/s, one prefill, the decode-step
   median, launches (exactly 104 of K1 or K2), steps per site, the
   dispatch's planning time (a second pass), and for the cached runs K1/K2
   device time beside its bound (a third, profiled pass).  Checks:
   executed == counted everywhere, each cached run's tape equal to the
   per-call run's, the pruned MLP sites under dense (mlp.up near half),
   pruned sparse logits and tokens against pruned dense as in 7;
11. pruned serving, traffic C — the same for whisper-base (its encoder
   layers pruned too, the stem's plans among the cached ones), with the
   launch counts of 9;
12. engine, traffic D — a control-plane smoke of continuous batching
   through the paged engine (``serving.engine.Engine``) on the model of 10,
   as 10 left it (MLPs block-pruned): 8 requests of 17-256 prompt tokens,
   16 new tokens each, one submitted a tick while the earlier ones decode,
   4 slots of 4096 cache slots in a fully provisioned pool; dense, dual
   (K1 + K3) and dual+kc (K2 + K4, per-slot schedules).  Checks: every
   request gets its 16 tokens, the pool drains, no eviction; K1 (K2)
   launches exactly 13 x (prefill calls + decode calls) and K3 (K4) 2 x
   layers x decode calls; the tape executes what it counts; dense engine
   tokens against ``generate`` at batch 1 and sparse against dense,
   parting only at top-2 ties.  Then, with the four longest requests in
   the four slots: every launch of the tick that admits them (a packed
   prefill, the other prefills, a decode of 4 slots) held against its
   plain walk on the same inputs at phases 3-4's tolerances, and the next
   decode tick's ``attn.score``/``attn.value`` steps against the blocks
   each slot's query sees, worked out on the host from the slot's
   position and the window, and one more such tick's K1/K2 and K3/K4
   launches replayed on their inputs for their device time beside their
   bound; ``profile_sparsity`` executes what it counts.
   Reports tokens/s (a path smoke: 128 tokens, no throughput meaning),
   ticks, calls, the decode-tick median, prefill ms a call, one decode
   tick split into the ``paged_read`` gather, planning, K1/K2, K3/K4 and
   the rest, the scheduled share of cache-block steps and peak memory.
   Then a pressure run in dual on a 15-page pool: it evicts, every budget
   is met, the pool drains, and how many streams equal the fully
   provisioned run's.

13. paper evaluation — the paper's own Fig. 21 / Fig. 22 workloads at
   their published shapes (``configs/paper_models.py``), operands drawn
   as the JAX package's benches draw them (numpy ``default_rng(0)``):
   Fig. 21's OHMMA and block-skip step models over the 7 x 4 sparsity
   grid at n = 1024 and Fig. 22's OHMMA models of all 22 layers, each
   StepCounts integer equal to the JAX package's (tabled below); K1
   through ``core.spgemm.spgemm`` and K2 through ``bitmap_spgemm_kfused``
   at 4096 x 4096 x 4096 bf16 over the same grid and a block-structured
   case: one launch each, executed steps equal to ``mxu_steps`` /
   ``kcondensed_counts``, outputs within 2e-2 of ``spgemm_ref``, plain
   walks at two points, device time beside ``torch.matmul`` and the
   bound; the 14 CONV layers through ``sparse.conv.conv2d`` dense / dual /
   dual+kc in float32 with exact launches (K5, K6, K1 or K2 once each),
   scheduled steps equal to the JAX package's and outputs within 1e-4 of
   ``F.conv2d``, the kernels held to their plain versions in float32 and
   bf16 at VGG-16 conv1_2 and Mask R-CNN res2; each layer in bf16 (the
   tensor-core route) within 2e-2 of ``F.conv2d`` on the same operands
   in float32 and timed by part beside ``F.conv2d``; the stride-2
   check through ``core.spconv.conv2d_dual_sparse`` (K7); the BERT-base
   and RNN GEMM layers through ``core.layers`` in dense / weight / dual
   (K1), agreeing within 1e-4.
14. MoE serving, traffic E — first the MoE smoke models (mixtral-8x7b's,
   12 prompt tokens and 8 new past its 16-token window, and
   qwen3-moe-235b-a22b's) on the card against the CPU plain path in
   float32, dense / dual / dual+kc: logits within 1e-4 x max, the
   auxiliary loss within 1e-5, greedy tokens equal.  Then full-width
   ``mixtral-8x7b`` cut to 2 layers (random bf16 weights from a seed),
   2 prompts of 32 tokens, 8 new: dense, dual (K1 + K3) and dual+kc (K2 +
   K4), each through ``generate`` (per-call plans) and the phase-10 loop
   on cached plans; then full-width ``qwen3-moe-235b-a22b`` cut to 2
   layers in dense and dual on cached plans.  Each sparse run launches
   exactly (4 x layers + 1) x 8 = 72 K1 (K2) and 3 x layers x 8 = 48 K3
   (K4), executes what it counts on every tape entry, and reports the
   ``moe.*`` steps of the prefill and of the decode steps (the decode
   must execute fewer than dense: experts no token picked are never
   read).  Against dense, the routing of every MoE call is compared token
   by token: a token whose set of experts differs must be a near-tie
   (k-th and (k+1)-th gates within ``GATE_MARGIN`` in one run) unless an
   earlier flip of its row reaches it; prefill logits within
   ``SERVE_RTOL`` x max|dense| on the tokens that kept their experts;
   greedy tokens part from dense only at a top-2 tie or after a flip in
   their row.  Every kernel launch of one prefill and one decode held to
   its plain walk (E = 8 and E = 128 for K3).  Numbers: tokens/s, one
   prefill, the decode-step median, planning a generate, peak memory;
   and one cached-plan generate's K1-K4 launches replayed on their
   inputs: CUDA events, the profiler's device time, the bound from the
   schedules, the plain walks, and ``torch.bmm`` over every expert (what
   the JAX dense einsum computes).
15. dense GQA families, traffic F — first the smoke models of yi-34b,
   qwen1.5-110b and chatglm3-6b (random qkv biases) on the card against
   the CPU plain path in float32: logits within 1e-4 x max and greedy
   tokens equal in dense, dual and dual+kc, tokens equal in dual+kv on
   int8 caches.  Then full-width ``qwen1.5-110b`` cut to 2 layers (random
   bf16 weights and qkv biases from a seed) under the run table's
   ``decode_32k`` config (int8 KV, KV chunks of 2048): 2 prompts of 3000
   tokens into 32768-slot caches, 16 new tokens, on cached weight plans:
   dense on int8 plain caches, dual (K1) and dual+kv (K1 + K3 on an int8
   ``SparseKVCache``).  Each launches exactly 15 x 16 = 240 K1 and 2 x
   layers x 15 = 60 K3 where it runs them, executes what it counts, and
   dual+kv's scheduled share of cache-block steps equals the occupancy
   reckoned from the positions; sparse logits within ``SERVE_RTOL`` x
   max|dense| (prefill, and decode while the tokens agree), tokens
   parting from dense only at top-2 ties.  Then dense on a bf16 cache
   against the int8 one (reported), dual+kv through ``generate`` (its
   tokens equal the cached-plan run's), and the ``Engine`` on an int8 pool
   of 2 slots x 32768 in dual+kv (exact launches, the pool drains, tokens
   against dense as above).  Last, the cached-plan dual+kv run's K1 and
   K3 launches kept and every one held to its plain walk, then replayed:
   CUDA events, device time, the bound, the plain walks' time and
   ``torch.matmul`` / ``torch.bmm`` over every slot.  Numbers: tokens/s,
   prefill ms, the decode-step median and peak memory per mode.

16. Mamba2 and the hybrid, traffics G and H — first the smoke models of
   mamba2-370m (tied head) and jamba-1.5-large (cut to one period of 8
   layers: attention + 7 Mamba, MoE at odd positions) on the card
   against the CPU plain path as in 15.  Then traffic G: full-width
   ``jamba-1.5-large-398b`` cut to 2 layers (attention + dense SwiGLU,
   Mamba + MoE of 16 experts top-2; 11.9 B random bf16 parameters from a
   seed) under its ``decode_32k`` run config (int8 KV, chunks of 2048),
   traffic F's 2 x 3000 prompt tokens into 32768-slot caches, 16 new, on
   cached weight plans: dense, dual (K1 + K3 on the experts), dual+kv (K1
   + K3, int8 ``SparseKVCache``) and dual+kc+kv (K2 + K4), each with exact
   launches (K1/K2 8 and K3/K4 3 a forward, K3/K4 2 a decode's
   attention), executing what it counts, the sparse-KV modes' scheduled
   share of cache-block steps equal to the positions' reckoning; against
   dense, routing flips only at near-ties, prefill logits within
   ``SERVE_RTOL`` on the tokens routed alike and tokens parting only at
   top-2 ties or after a flip, as in 14; the Mamba layer's SSD scan and
   causal conv as shares of one prefill's and one decode's device time;
   dual+kv through ``generate`` (the same tokens) and the ``Engine`` on an
   int8 pool of 2 slots x 32768 with per-slot SSM state (exact launches,
   tokens parting from generate's only at top-2 ties); then every launch
   of a dual+kv and of a dual+kc+kv generate held to its plain walk and
   replayed for device time, bound, ``torch.bmm`` over every expert or
   slot.  Then traffic H: ``mamba2-370m`` whole (48 layers, 0.37 B
   parameters, tied head) through ``generate``, 4 prompts of 2048 tokens,
   32 new, dense and dual (K1 on the tied head, planned per call): exact
   launches, dual logits within ``SERVE_RTOL`` of dense and tokens parting
   only at ties; one forward over 2048 + 31 tokens against the prefill and
   the 31 decode steps (continuity, bf16); the tied head's per-call plan
   and contiguous copy timed; the SSD shares; the ``Engine`` on 4 slots
   with 8 requests of 256-2048 prompt tokens and 32 new each, every
   request's tokens against its own batch-1 generate; the dual generate's
   K1 launches held to their plain walks and replayed.  Numbers: tokens/s,
   prefill ms, the decode-step median and peak memory per mode.
17. the VLM, traffic I — first llama-3.2-vision-90b's smoke model (10
   layers, 16 x 16 images, the cross layers' gates drawn non-zero) on the
   card against the CPU plain path as in 15, each prompt with an image.
   Then full-width ``llama-3.2-vision-90b`` cut to one period of 5 layers
   (a tanh-gated cross layer, 4 self layers; 6.40 B random bf16
   parameters from a seed, the gates drawn in [0.5, 1)) under its
   ``decode_32k`` run config (int8 self caches, chunks of 2048), traffic
   F's 2 x 3000 prompt tokens into 32768-slot caches, 16 new, each request
   with a 560 x 560 x 3 ReLU-clipped normal image (1601 image tokens with
   the cls token), on cached weight plans: dense, dual (K1, K5, K7),
   dual+kv (adds K3) and dual+kc+kv (K2, K4, K5, K7), each with exact
   launches (K1/K2 37 a prefill and 34 a decode step, K3/K4 8 a decode
   step, K5 and K7 1 a prefill), executing what it counts, the scheduled
   share of cache-block steps equal to the positions' reckoning; sparse
   logits within ``SERVE_RTOL`` x max|dense|, tokens parting only at
   top-2 ties; the two requests' images swapped must move each row's
   first-token logits by more than the tolerance and more than 10 x the
   sparse modes' own first-token difference from dense; the frontend's
   and the cross layer's shares of one prefill's device time (profiler
   ranges), the patch conv as ``F.conv2d`` and ``F.unfold`` and its GEMM
   on K1 replayed beside ``torch.matmul``; dual+kv through ``generate``
   (the same tokens; the cross caches plain bf16 of 1601 slots); the
   ``Engine`` refusing the config with ``ValueError``; then every K1-K4
   launch of a dual+kv and a dual+kc+kv generate held to its plain walk
   and replayed, and the generate's K5 and K7 launches held bit-equal and
   replayed beside their bound (and ``F.unfold`` for K7).
18. tuning and guards — full-width ``nemotron-4-340b`` (2 layers, MLPs
   block-pruned to half as in 10) in dual: ``Engine.autotune_keys`` on
   traffic D's 4 slots x 4096, then one served pass of traffic A
   (``generate``) and of traffic D (the engine) with ``sparse_autotune``
   on an empty cache, every lookup logged and each key's operands
   captured; ``tune_matmul`` on each matmul key (the card timer, at most
   4 cost-model survivors, the baseline and the kfused twin of the
   model's pick) and ``tune_attn`` at the engine's decode geometry (the
   block_t lattice on K3 and K4), one line per key with the baseline, the
   winner and their times; the cache saved under ``build/`` and checked
   with ``check_tuning_cache``; traffic A and D served on it with
   ``sparse_autotune``: hits, misses and stale entries equal to the
   logged lookups replayed on the cache, tokens against the untuned dual
   runs parting only at top-2 ties, every tape entry executing what it
   counts, every K1-K4 launch of a tuned generate held to its plain walk,
   tokens/s beside untuned dual and dense; the cost-model tier
   (``sparse_costmodel``, empty cache) with its knobs per site; traffic D
   under ``faults.chaos`` (kernel faults, allocator faults, preemption
   storm, one poisoned uid): exactly the sites that ran K1 and K3
   quarantined, the poisoned request retired ``nonfinite_logits``, the
   others finishing with the fault-free tokens but for near-ties; traffic
   D with ``RunConfig(validate=True)`` and the dispatch boundary checks on
   (no ``ValidationError``), then a broken ``PlannedWeight`` and a broken
   block table each raising.  Every earlier phase must end with no site
   quarantined.
19. training on one device, traffic J — (a) one float32 train step (2
   microbatches, adamw, remat full, TF32 off) of the smoke model of every
   family the port serves (chatglm3-6b, nemotron-4-340b, qwen1.5-110b,
   yi-34b, mixtral-8x7b, qwen3-moe-235b-a22b, mamba2-370m,
   jamba-1.5-large-398b, whisper-base, llama-3.2-vision-90b) on the card
   against the same step on the CPU: gradients within 1e-4 x max|g|, a
   finite loss, grad_norm > 0, no kernel launched.  (b) Traffic J:
   full-width ``chatglm3-6b`` cut to 4 of its 28 layers (1.35 B float32
   masters, random from a seed) under its ``train_4k`` run config (8
   microbatches, adamw, a float32 accumulator, bf16 compute copies, remat
   full), 8 sequences of 4096 tokens of ``SyntheticTokens`` a step: one
   warm-up and 5 timed steps (the median, tokens/s, 6 N D over the median
   as a share of 989 TFLOP/s, peak memory), then one step each under remat
   none and dots; every loss finite; ``make_eval_step`` on the last batch
   at the parameters the last step started from equal to that step's loss
   within 1e-2.  (c) The trained masters cast to bf16 and served, 2
   prompts of 32 tokens of an unseen batch, 4 new: dense, dual (K1) and
   dual+kc (K2) through ``generate`` and on cached plans, each with exact
   launches and the same tokens both ways; sparse prefill logits within
   ``SERVE_RTOL`` x max|dense|, tokens parting only at top-2 ties; every
   K1 and K2 launch of a cached-plan generate held to its plain walk and
   replayed for device time.  (d) tests/test_system.py's crash-restart on
   chatglm3-6b-smoke (2 microbatches, lr 1e-3, warmup 2, 8 x 16 tokens, 6
   steps, a checkpoint a step through ``CheckpointManager``, a crash
   before step 3) in a child process with deterministic CUDA: the resumed
   run's losses within 1e-5 and its parameters within 1e-6 of the
   uninterrupted run's, and whether they are bitwise equal.  (e) ``python
   -m repro_torch.launch.train --arch chatglm3-6b --smoke --steps 20
   --ckpt-every 10`` twice: the second run resumes at step 20 and trains
   nothing; a train step in dual mode with the kernel raises
   ``NotImplementedError``, launching nothing.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without a card, or
outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import array
import copy
import dataclasses
import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense): device memory and math rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# per-output-scale tolerances: |kernel - plain| <= rtol * max|plain|
RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
# dense vs sparse serving logits, relative to max|dense logits|: the repo's
# bf16 tolerance; the paths differ only in f32 summation order and bf16
# rounding of each projection's output
SERVE_RTOL = 2e-2

ARCH = "nemotron-4-340b"
N_LAYERS = 2
PROMPTS, PROMPT_LEN, NEW_TOKENS = 2, 32, 8
MODES = {
    "dense": dict(),
    "dual": dict(sparse_mode="dual", sparse_use_kernel=True),
    "dual+kc": dict(sparse_mode="dual", sparse_use_kernel=True,
                    sparse_kcondense=True),
}
# the sparse-KV traffic: a context allocated far past the live one
KV_PROMPTS, KV_PROMPT_LEN, KV_NEW_TOKENS, CAPACITY = 2, 256, 16, 4096
KV_MODES = {
    "dual": MODES["dual"],
    "dual+kv": dict(MODES["dual"], sparse_kv=True),
    "dual+kc+kv": dict(MODES["dual+kc"], sparse_kv=True),
}
# grouped launches per generate and site: one per layer and decode step
KV_CALLS = N_LAYERS * (KV_NEW_TOKENS - 1)
# cache slots written at the first and the last decode step
KV_WRITTEN = (KV_PROMPT_LEN + 1, KV_PROMPT_LEN + KV_NEW_TOKENS - 1)

# traffic D, a control-plane smoke of continuous batching (a hand-picked
# ladder of lengths, not a measured request mix): requests of these prompt
# lengths (seeded tokens), D_NEW new tokens each, one submitted a tick
# while the earlier ones decode, through the paged engine: D_SLOTS slots
# of D_CAPACITY logical cache slots, fully provisioned (512 pages of 32)
D_PROMPT_LENS = (17, 32, 48, 64, 100, 128, 200, 256)
D_NEW, D_SLOTS, D_CAPACITY = 16, 4, 4096
# the pressure run's pool: fewer pages than the four longest requests hold
# together (9 + 7 + 5 + 4 = 25); the largest pool on which traffic D evicts
D_PRESSURE_PAGES = 15
# sparse_kv only decides what profile_sparsity's contiguous caches are: the
# paged decode schedules its cache blocks in every sparse mode
ENGINE_MODES = {"dense": MODES["dense"],
                "dual": dict(MODES["dual"], sparse_kv=True),
                "dual+kc": dict(MODES["dual+kc"], sparse_kv=True)}
# K1 (K2) dispatches a forward: q/k/v/out and mlp up/down a layer, the head
PROJ_PER_FORWARD = 6 * N_LAYERS + 1

# the whisper traffic: 4 segments of 30 s audio (3000 mel frames x 80
# bins each), whisper's start-of-transcript prefix as the prompt, 32 greedy
# tokens; whisper-base at full width and depth
WHISPER = "whisper-base"
W_SEGMENTS, W_NEW = 4, 32
# <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>
W_PROMPT = (50258, 50259, 50359, 50363)
# the vision patch conv's shape (k = s = 14 over a 560 x 560 x 3 image):
# K7's other caller, checked here and served in phase 17
PATCH = (1, 560, 560, 3, 14, 14, 14)
# ragged conv shapes (N, H, W, C, kh, kw, stride): 3x3 at strides 1 and
# 2, windows that cross or end on a word boundary, W multiple of 32, and
# shapes that take K5's, K6's and K7's other routes
CONV_RAGGED = [(1, 7, 9, 3, 3, 3, 1), (2, 9, 10, 2, 3, 3, 2),
               (1, 1, 66, 2, 1, 34, 1), (1, 1, 65, 2, 1, 2, 1),
               (1, 1, 100, 2, 1, 33, 2), (1, 2, 96, 3, 2, 1, 1),
               # stride 3 on K5's channels route with a part tile (C 40);
               # K7 in pieces (a 70000-column row); K7's lowered route
               (2, 1, 500, 40, 1, 3, 3), (1, 1, 70000, 2, 1, 3, 2),
               (1, 1, 5000, 2, 1, 4100, 2),
               # K6 in pieces; K6's lowered route; the patch kernel at
               # stride 1 (K6, 43 output rows of a 56-row map)
               (1, 1, 70000, 2, 1, 3, 1), (1, 1, 5000, 2, 1, 4100, 1),
               (1, 56, 56, 3, 14, 14, 1)]


# traffic F, a long-context decode on an int8 cache: full-width
# qwen1.5-110b cut to F_LAYERS layers under its decode_32k run config, 2
# prompts of 3000 tokens into 32768-slot caches, 16 new tokens
DENSE_GQA = ("yi-34b", "qwen1.5-110b", "chatglm3-6b")
QWEN15 = "qwen1.5-110b"
F_LAYERS = 2
F_PROMPTS, F_PROMPT_LEN, F_NEW, F_CAPACITY = 2, 3000, 16, 32768
F_MODES = {"dense": MODES["dense"], "dual": MODES["dual"],
           "dual+kv": dict(MODES["dual"], sparse_kv=True)}


def whisper_k1_launches(cfg) -> int:
    """K1 (K2) launches per whisper generate: at prefill the two stem
    convs, 6 per encoder layer, 10 per decoder layer (self q/k/v/o, cross
    q/k/v/o, mlp up/down) and the head; at each decode 8 per decoder layer
    (the cross K/V are cached) and the head."""
    prefill = 2 + 6 * cfg.n_encoder_layers + 10 * cfg.n_layers + 1
    return prefill + (W_NEW - 1) * (8 * cfg.n_layers + 1)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s); float32 matmuls in full "
        "float32 (TF32 off)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# the kernels of the redesigned K1-K4 whose resources phase_build reports:
# the tensor-core kernel (K1-K4 bf16), K3/K4's narrow-N and mixed kernels
REPORTED_KERNELS = ("spgemm_mma_kernel", "narrow_kernel", "mixed_kernel")


def kernel_lines(text, gathers):
    """(kernel, registers, shared memory, stack, spill stores) of every
    instantiation of :data:`REPORTED_KERNELS` in an ``-Xptxas -v`` log;
    ``gathers`` names the gathering variant (K2 or K4)."""
    rows = []
    for block in text.split("Compiling entry function")[1:]:
        name = block.split("'")[1]
        base = next((b for b in REPORTED_KERNELS if b in name), None)
        if base is None:
            continue
        num = (lambda pat: int(re.search(pat, block).group(1))
               if re.search(pat, block) else 0)
        rows_tpl = re.search(r"ILi(\d+)E", name)
        fused = re.search(r"Lb([01])E", name).group(1) == "1"
        rows.append((f"{base}<{rows_tpl.group(1) + ' rows, ' if rows_tpl else ''}"
                     f"{gathers if fused else 'slices'}>",
                     num(r"Used (\d+) registers"), num(r"(\d+) bytes smem"),
                     num(r"(\d+) bytes stack frame"),
                     num(r"(\d+) bytes spill stores")))
    return rows


def sass_counts(lib):
    """Tensor-core and asynchronous-copy instructions in a library's SASS
    (``cuobjdump -sass``), or None without cuobjdump."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops = ("HMMA", "HGMMA", "LDGSTS", "LDSM")
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}
    # and per kernel of REPORTED_KERNELS, from its "Function :" section
    for part in sass.split("Function : ")[1:]:
        base = next((b for b in REPORTED_KERNELS
                     if b in part.split("\n", 1)[0]), None)
        if base is not None:
            per = counts.setdefault(base, dict.fromkeys(ops, 0))
            for op in ops:
                per[op] += len(re.findall(rf"\b{op}\b", part))
    return counts


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(libs)} libraries "
        f"(nvcc {' '.join(build.NVCC_FLAGS)}, one process each)")
    for src, path in libs.items():
        text = path.with_name(path.stem[3:] + ".log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(s) for s in
                  re.findall(r"(\d+) bytes spill stores", text)]
        log(f"build: {src}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, "
            f"{max(spills, default=0)} bytes of spill stores at most")
    # the bf16 K1-K4: tensor-core kernels (K1/K2's fed by cp.async, K3/K4's
    # narrow-N one by registers), and K3/K4's float32 x bf16 kernel
    for src, gathers in (("bitmap_spgemm.cu", "K2"),
                         ("bitmap_spgemm_kfused.cu", "K2"),
                         ("grouped_spgemm.cu", "K4"),
                         ("grouped_spgemm_kfused.cu", "K4")):
        text = libs[src].with_name(libs[src].stem[3:] + ".log").read_text()
        rows = kernel_lines(text, gathers)
        if not any(r[0].startswith("spgemm_mma_kernel") for r in rows):
            raise AssertionError(f"{src}: no tensor-core kernel in the build")
        if src.startswith("grouped") and not {
                "narrow_kernel", "mixed_kernel"} <= {
                r[0].split("<")[0] for r in rows}:
            raise AssertionError(f"{src}: no narrow-N or mixed kernel")
        for name, regs, smem, stack, spill in rows:
            log(f"build: {src} {name}: {regs} registers, {smem} bytes "
                f"static shared memory (rings and staged B are dynamic), "
                f"{stack} bytes stack, {spill} bytes spilled")
        counts = sass_counts(libs[src])
        if counts is None:
            log(f"build: {src}: no cuobjdump, SASS not counted")
            continue
        log(f"build: {src} SASS: " + ", ".join(
            f"{op} {n}" if isinstance(n, int) else
            f"{op} (" + ", ".join(f"{o} {c}" for o, c in n.items()) + ")"
            for op, n in counts.items()))
        if counts["HMMA"] + counts["HGMMA"] == 0:
            raise AssertionError(f"{src}: no HMMA/HGMMA instruction in the "
                                 "bf16 kernels")
        if src.startswith("grouped") and not counts.get(
                "narrow_kernel", {}).get("HMMA"):
            raise AssertionError(f"{src}: the narrow-N kernel has no HMMA")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps):
    """Median of ``reps`` timed calls (CUDA events), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms_by_kernel(torch, fn, reps=20):
    """Device time per call of each kernel ``fn`` launches, by name, from a
    ``torch.profiler`` (CUPTI) trace of ``reps`` calls: the card's own
    time, without the host's time in the wrapper, which CUDA events around
    a call of a microsecond-scale kernel mostly measure.  None when three
    traces hold no device event: with the host's activity, with the
    device's alone (late in a long run a trace of a kernel launched
    through ctypes can come back empty with the host's activity on),
    then with both again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for activities in (both, [ProfilerActivity.CUDA], both):
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per[e.name] = per.get(e.name, 0.0) + e.device_time_total
        if sum(per.values()) > 0:
            return {k: us / reps / 1e3 for k, us in per.items()}
    return None


def device_ms(torch, fn, reps=20):
    """Device time per call of all the kernels ``fn`` launches (see
    :func:`device_ms_by_kernel`), or None."""
    per = device_ms_by_kernel(torch, fn, reps)
    return None if per is None else sum(per.values())


def kernel_counters():
    """Every kernel's wrapper by name (K1-K7), each counting the launches
    of its kernel in ``launches``."""
    from repro_torch.kernels import bitmap_encode as k5
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.kernels import grouped_spgemm as gsk
    from repro_torch.kernels import sparse_im2col as k67
    return {"K1": bsk.bitmap_spgemm_planned,
            "K2": bsk.bitmap_spgemm_kfused_planned,
            "K3": gsk.grouped_spgemm_planned,
            "K4": gsk.grouped_spgemm_kfused_planned,
            "K5": k5.bitmap_encode, "K6": k67.sparse_im2col,
            "K7": k67.sparse_im2col_strided}


def served_geometry(a, b):
    """The clamped (block_m, block_n, slice_k) of ``a @ b`` at the
    config's 128/128/128 knobs, as the dispatch resolves them."""
    from repro_torch.sparse import plan as pln
    bm, bn, sk = pln.clamp_geometry(a.shape[0], b.shape[1], a.shape[1],
                                    128, 128, 128)
    return dict(block_m=bm, block_n=bn, slice_k=sk)


def plan_gathers(a, b, geom):
    """K2's element-condensed schedule (a KPlan), built the same way."""
    from repro_torch.sparse import plan as pln
    return pln.plan_kcondensed(
        pln.element_activity_lhs(a, geom["block_m"]),
        pln.element_activity_rhs(b, geom["block_n"]), geom["slice_k"])


def plan_k1(a, b):
    from repro_torch.kernels import bitmap_spgemm as bsk
    geom = served_geometry(a, b)
    return (geom, *bsk.plan_slices(a, b, geom["block_m"], geom["block_n"],
                                   geom["slice_k"]))


def plan_k2(a, b):
    return plan_gathers(a, b, served_geometry(a, b))


def splits_of(a, b, geom):
    """The shares the bf16 wrapper cuts each tile's schedule into for
    ``a (M, K) @ b (K, N)`` at ``geom`` on this card."""
    import torch
    from repro_torch.kernels import bitmap_spgemm as bsk
    (m, k), n = a.shape, b.shape[1]
    bm, bn, sk = geom["block_m"], geom["block_n"], geom["slice_k"]
    blocks = bsk.mma_blocks(1, -(-m // bm), -(-n // bn), bm, bn)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    return bsk.split_count(blocks, -(-k // sk), sms, m=m, k=k)


def schedules(a, b):
    geom, ks, counts = plan_k1(a, b)
    return geom, ks, counts, plan_k2(a, b)


def needed_work(torch, a, b, out_dtype, geom, sched, counts, kfused):
    """(bytes, flops, bytes of b) that this data needs for a (E, M, K) @
    b (E, K, N)
    on the schedule ``sched`` (ks, or a KPlan when ``kfused``) / counts
    (E, Mt, Nt): each A row block reads the contraction positions some of
    its blocks schedule, each B column block likewise, the schedule is
    read and the output written once; 2 flops per scheduled
    multiply-add."""
    e, m, k = a.shape
    n = b.shape[2]
    bm, bn, sk = geom["block_m"], geom["block_n"], geom["slice_k"]
    mt, nt = counts.shape[1:]
    dev = a.device
    if kfused:                       # positions: the gathered k's
        idx = sched.gk.reshape(e, mt, nt, -1).long()
        live = torch.arange(idx.shape[-1], device=dev) < sched.nnz[..., None]
        width = (torch.arange(idx.shape[-1], device=dev) < k).double()
        sched_bytes = 4 * (int(counts.sum()) * sk + counts.numel())
    else:                            # positions: whole k-slices
        idx = sched.long()
        live = torch.arange(idx.shape[-1], device=dev) < counts[..., None]
        width = torch.clamp(k - torch.arange(idx.shape[-1], device=dev) * sk,
                            max=sk).double()
        sched_bytes = 4 * (int(counts.sum()) + counts.numel())
    act = torch.zeros(idx.shape, dtype=torch.int32, device=dev).scatter_add_(
        -1, idx, live.int()) > 0                       # (E, Mt, Nt, X)
    rows = torch.clamp(m - torch.arange(mt, device=dev) * bm,
                       max=bm).double()
    cols = torch.clamp(n - torch.arange(nt, device=dev) * bn,
                       max=bn).double()
    depth = (act * width).sum(-1)                      # (E, Mt, Nt)
    a_depth = (act.any(2) * width).sum(-1)             # (E, Mt)
    b_depth = (act.any(1) * width).sum(-1)             # (E, Nt)
    b_bytes = float((b_depth * cols).sum()) * b.element_size()
    nbytes = (float((a_depth * rows).sum()) * a.element_size() + b_bytes
              + sched_bytes + e * m * n * out_dtype.itemsize)
    flops = 2.0 * float((depth * rows[:, None] * cols[None, :]).sum())
    return nbytes, flops, b_bytes


def check_pair(torch, name, y, p, dtype, what):
    scale = p.float().abs().max().item()
    err = (y.float() - p.float()).abs().max().item()
    tol = RTOL[dtype] * max(scale, 1e-30)
    if not err <= tol:
        raise AssertionError(f"{name} {what}: max |kernel - plain| {err:.3e}"
                             f" > {tol:.3e} ({RTOL[dtype]} x max|plain| "
                             f"{scale:.3e})")
    return err


# whisper-base's encoder products at 4 segments (6000 rows; the stem's
# first conv lowers 12000 positions): (site, M, K, N); the deeper ones are
# above the card's ridge, so their flops bound them
WHISPER_SHAPES = [("enc.attn", 6000, 512, 512),
                  ("enc.mlp.up", 6000, 512, 2048),
                  ("enc.mlp.down", 6000, 2048, 512),
                  ("stem1", 12000, 240, 512), ("stem2", 6000, 1536, 512)]
# shapes whose few tiles split their schedules over many CUDA blocks:
# (M, K, N, block_m, block_n, slice_k); N <= block_n with K = 16384,
# slice_k 40 and 96, block_m 37, N = 300 (a counts == 0 column tile
# beside split ones)
SPLIT_SHAPES = [(2, 16384, 96, 8, 128, 128), (2, 16384, 300, 8, 128, 40),
                (37, 16384, 300, 37, 128, 96), (64, 16384, 256, 64, 128, 128)]


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f}"


def main_path_shapes(cfg):
    """(K, N, dispatches per forward) of every projection of the path."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    assert hq == d
    return [("attn.q/o", d, d, 2 * N_LAYERS), ("attn.k/v", d, hkv,
            2 * N_LAYERS), ("mlp.up", d, f, N_LAYERS),
            ("mlp.down", f, d, N_LAYERS), ("lm_head", d, v, 1)]


def phase_kernels(torch, cfg):
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.sparse import plan as pln
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    kernels = {
        "K1": (bsk.bitmap_spgemm_planned, bsk.bitmap_spgemm_planned_plain),
        "K2": (bsk.bitmap_spgemm_kfused_planned,
               bsk.bitmap_spgemm_kfused_planned_plain),
    }
    err = {"K1": 0.0, "K2": 0.0}
    totals = {kn: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, plan_ms=0.0,
                       nbytes=0.0, op_s=0.0, device_ms=0.0,
                       library_device_ms=0.0) for kn in kernels}
    planners = {"K1": plan_k1, "K2": plan_k2}
    # forwards per generate: one prefill of PROMPTS*PROMPT_LEN rows, then
    # NEW_TOKENS - 1 decode steps of PROMPTS rows
    per_generate = ((PROMPTS * PROMPT_LEN, 1), (PROMPTS, NEW_TOKENS - 1))

    def run_pair(kn, a, b, geom, ks, counts, kp, out_dtype=None):
        kern, plain = kernels[kn]
        sched = (kp.gk, kp.counts) if kn == "K2" else (ks, counts)
        y = kern(a, b, *sched, out_dtype=out_dtype, **geom)
        p = plain(a, b, *sched, out_dtype=out_dtype, **geom)
        torch.cuda.synchronize()
        return y, p, (lambda: kern(a, b, *sched, **geom)), \
            (lambda: plain(a, b, *sched, **geom))

    # the served shapes: weights dense random (as the served model's),
    # activations dense, relu2 (about half zeros) into mlp.down
    for site, k, n, per_fwd in main_path_shapes(cfg):
        b16 = torch.randn(k, n, device=dev, generator=g,
                          dtype=torch.bfloat16)
        for m, fwds in per_generate:
            a32 = torch.randn(m, k, device=dev, generator=g)
            if site == "mlp.down":
                a32 = a32.clamp(min=0).square()
            for dtype in ("bfloat16", "float32"):
                tdt = getattr(torch, dtype)
                a = a32.to(tdt)
                b = b16 if dtype == "bfloat16" else b16.float()
                geom, ks, counts, kp = schedules(a, b)
                line = [f"{site} M={m} K={k} N={n} {dtype} "
                        f"blocks={tuple(counts.shape)} steps K1 "
                        f"{int(counts.sum())} K2 {int(kp.counts.sum())} of "
                        f"{counts.numel() * ks.shape[-1]}"]
                for kn in kernels:
                    y, p, kfn, pfn = run_pair(kn, a, b, geom, ks, counts, kp)
                    e = check_pair(torch, kn, y, p, dtype, line[0])
                    err[kn] = max(err[kn], e)
                    line.append(f"{kn} err {e:.2e}")
                    if dtype != "bfloat16":
                        continue
                    mult = per_fwd * fwds
                    ms = cuda_ms(torch, kfn, 10)
                    dms = device_ms(torch, kfn, 10)
                    pms = cuda_ms(torch, pfn, 2)
                    lms = cuda_ms(torch, lambda: torch.matmul(a, b), 10)
                    ldms = device_ms(torch, lambda: torch.matmul(a, b), 10)
                    plan_ms = cuda_ms(torch, lambda: planners[kn](a, b), 3)
                    # one problem: a leading axis of 1 on every operand
                    kp1 = type(kp)(*(t[None] for t in kp))
                    nb, fl, _ = needed_work(
                        torch, a[None], b[None], a.dtype, geom,
                        kp1 if kn == "K2" else ks[None],
                        kp1.counts if kn == "K2" else counts[None],
                        kn == "K2")
                    t = totals[kn]
                    t["ms"] += mult * ms
                    t["plain_ms"] += mult * pms
                    t["library_ms"] += mult * lms
                    t["plan_ms"] += mult * plan_ms
                    t["nbytes"] += mult * nb
                    t["op_s"] += mult * fl / PEAK_FLOPS[dtype]
                    for key, x in (("device_ms", dms),
                                   ("library_device_ms", ldms)):
                        t[key] = None if x is None or t[key] is None \
                            else t[key] + mult * x
                    bound = max(nb / HBM_BYTES_PER_S,
                                fl / PEAK_FLOPS[dtype]) * 1e3
                    line.append(f"{ms:.3f} ms, device {fmt_ms(dms)} (bound "
                                f"{bound:.3f}, plain {pms:.1f}, torch.matmul "
                                f"{lms:.3f}, device {fmt_ms(ldms)}, planning "
                                f"{plan_ms:.3f}, splits "
                                f"{splits_of(a, b, geom)})")
                log("kernels: " + "; ".join(line))
                del a, b
        del b16
        torch.cuda.empty_cache()

    # ragged shapes: M, N, K off their blocks, relu2 activations,
    # block-pruned weights (counts == 0 blocks), partial last slices
    ragged = [(37, 200, 300), (2, 130, 300), (200, 1000, 520),
              (64, 4000, 1000)]
    for m, k, n in ragged:
        a32 = torch.randn(m, k, device=dev, generator=g).clamp(min=0).square()
        b32 = torch.randn(k, n, device=dev, generator=g)
        b32[torch.rand(k, n, device=dev, generator=g) < 0.5] = 0
        b32[:, :128] = 0                                # a dead block column
        for dtype in ("bfloat16", "float32"):
            for out_dtype in (None, torch.float32, torch.bfloat16):
                tdt = getattr(torch, dtype)
                a, b = a32.to(tdt), b32.to(tdt)
                geom, ks, counts, kp = schedules(a, b)
                if not ((counts == 0).any() and (kp.counts == 0).any()):
                    raise AssertionError("ragged case lost its empty blocks")
                odt = dtype if out_dtype is None else str(out_dtype)[6:]
                for kn in kernels:
                    y, p, _, _ = run_pair(kn, a, b, geom, ks, counts, kp,
                                          out_dtype)
                    if y.dtype != p.dtype:
                        raise AssertionError(f"{kn}: dtype {y.dtype}")
                    err[kn] = max(err[kn], check_pair(
                        torch, kn, y, p, odt, f"ragged {m}x{k}x{n}"))
        log(f"kernels: ragged M={m} K={k} N={n} geometry "
            f"{tuple(geom.values())}: K1 and K2 agree with their plain "
            "versions (bf16/float32 in, default/float32/bf16 out)")

    # split-heavy shapes: few tiles, deep schedules cut over many blocks
    for m, k, n, bm, bn, sk in SPLIT_SHAPES:
        a32 = torch.randn(m, k, device=dev, generator=g).clamp(min=0).square()
        b32 = torch.randn(k, n, device=dev, generator=g)
        if n > bn:
            b32[:, :bn] = 0                             # a dead block column
        b32[torch.rand(k, n, device=dev, generator=g) < 0.5] = 0
        geom = dict(zip(("block_m", "block_n", "slice_k"),
                        pln.clamp_geometry(m, n, k, bm, bn, sk)))
        for dtype in ("bfloat16", "float32"):
            tdt = getattr(torch, dtype)
            a, b = a32.to(tdt), b32.to(tdt)
            ks, counts = bsk.plan_slices(a, b, geom["block_m"],
                                         geom["block_n"], geom["slice_k"])
            kp = plan_gathers(a, b, geom)
            if n > bn and not ((counts == 0).any() and (kp.counts == 0).any()):
                raise AssertionError("split case lost its empty blocks")
            for kn in kernels:
                y, p, _, _ = run_pair(kn, a, b, geom, ks, counts, kp)
                err[kn] = max(err[kn], check_pair(
                    torch, kn, y, p, dtype, f"split {m}x{k}x{n}"))
        log(f"kernels: split M={m} K={k} N={n} geometry "
            f"{tuple(geom.values())}, splits {splits_of(a32, b32, geom)} in "
            "bf16: K1 and K2 agree with their plain versions (bf16 and "
            "float32)")

    # whisper-base's encoder products in bf16
    for site, m, k, n in WHISPER_SHAPES:
        a = torch.randn(m, k, device=dev, generator=g, dtype=torch.bfloat16)
        b = torch.randn(k, n, device=dev, generator=g, dtype=torch.bfloat16)
        geom, ks, counts, kp = schedules(a, b)
        line = [f"whisper {site} M={m} K={k} N={n} bf16 blocks="
                f"{tuple(counts.shape)} splits {splits_of(a, b, geom)}"]
        for kn in kernels:
            y, p, kfn, _ = run_pair(kn, a, b, geom, ks, counts, kp)
            e = check_pair(torch, kn, y, p, "bfloat16", line[0])
            err[kn] = max(err[kn], e)
            kp1 = type(kp)(*(t[None] for t in kp))
            nb, fl, _ = needed_work(
                torch, a[None], b[None], a.dtype, geom,
                kp1 if kn == "K2" else ks[None],
                kp1.counts if kn == "K2" else counts[None], kn == "K2")
            t_bytes, t_ops = nb / HBM_BYTES_PER_S, fl / PEAK_FLOPS["bfloat16"]
            line.append(f"{kn} err {e:.2e} {cuda_ms(torch, kfn, 10):.4f} ms, "
                        f"device {fmt_ms(device_ms(torch, kfn, 10))} (bound "
                        f"{max(t_bytes, t_ops) * 1e3:.4f} by "
                        f"{'bytes' if t_bytes >= t_ops else 'flops'})")
        mm = lambda: torch.matmul(a, b)                    # noqa: E731
        line.append(f"torch.matmul {cuda_ms(torch, mm, 10):.4f} ms, device "
                    f"{fmt_ms(device_ms(torch, mm, 10))}")
        log("kernels: " + "; ".join(line))
        del a, b
    return err, totals


# ---------------------------------------------------------------------------
# phase 4: grouped kernels against their plain versions
# ---------------------------------------------------------------------------

def site_geometry(cfg, op, c, n, k):
    """The clamped (block_m, block_n, slice_k) the decode attention site
    ``op`` runs at for a (E, c, k) @ (E, k, n) product, as
    ``attention.attend_sparse`` resolves it."""
    from repro_torch.sparse import plan as pln
    from repro_torch.sparse import site
    kw = site.resolve(site.make(op, op, out_dtype="float32"), cfg, m=c,
                      n=n, k=k, device="cuda")
    if op == "attn.value":
        kw["slice_k"] = pln.effective_slice_k(k, kw["slice_k"])
    bm, bn, sk = pln.clamp_geometry(c, n, k, kw["block_m"], kw["block_n"],
                                    kw["slice_k"])
    return dict(block_m=bm, block_n=bn, slice_k=sk)


def attention_products(torch, cfg, written, g, capacity=CAPACITY):
    """The decode attention's two grouped products over a ``capacity``-slot
    cache whose first ``written`` slots hold tokens, as
    ``attend_sparse`` builds them: E = prompts x KV heads problems, the
    schedule = the written slots.  Returns {site: (x, w)} in float32,
    x a SparseActivation, w a tensor or PlannedWeight."""
    from repro_torch.sparse import kvcache as skvc
    from repro_torch.sparse import plan as pln
    dev = torch.device("cuda")
    e, grp, hd = KV_PROMPTS * cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.hd
    sched = torch.arange(capacity, device=dev) < written
    k_e = torch.randn(e, capacity, hd, device=dev, generator=g) \
        * sched[:, None]
    q_e = torch.randn(e, hd, grp, device=dev, generator=g)
    p = torch.rand(e, grp, capacity, device=dev, generator=g) * sched
    v_e = torch.randn(e, capacity, hd, device=dev, generator=g) \
        * sched[:, None]
    x_k = skvc.score_operand(
        k_e, sched, pln.effective_slice_k(hd, cfg.sparse_slice_k))
    x_p, w_v = skvc.value_operands(
        sched, p, v_e, sched,
        pln.effective_slice_k(capacity, cfg.sparse_block_t))
    return {"attn.score": (x_k, q_e), "attn.value": (x_p, w_v)}


def operand_arrays(x, w):
    """The value tensors of a dispatch operand pair."""
    from repro_torch.sparse.activation import SparseActivation
    from repro_torch.sparse.weights import PlannedWeight
    return (x.values if isinstance(x, SparseActivation) else x,
            w.w if isinstance(w, PlannedWeight) else w)


def as_dtype(x, w, a_dtype, b_dtype):
    """(x, w) of :func:`attention_products` with x's values cast to
    ``a_dtype`` and w's to ``b_dtype`` (the metadata stays)."""
    from repro_torch.sparse.weights import PlannedWeight
    x = dataclasses.replace(x, values=x.values.to(a_dtype))
    if isinstance(w, PlannedWeight):
        return x, dataclasses.replace(w, w=w.w.to(b_dtype))
    return x, w.to(b_dtype)


# the grouped products' operand types (A, B); "mixed" is the served
# value's: float32 probabilities against V as the cache stores it
GROUPED_TYPES = {"bfloat16": ("bfloat16", "bfloat16"),
                 "float32": ("float32", "float32"),
                 "mixed": ("float32", "bfloat16")}


def wrapper_parts(torch, kern, src, a, b, sched, counts, geom, reps=300):
    """Host microseconds per call of a K3/K4 wrapper and of its parts,
    from ``perf_counter`` around ``reps`` calls (the stream drained before
    and after): the whole wrapper, the device checks, the shape checks,
    the route and splits, the output's allocation, the current stream,
    the kernel's launch words and ctypes call (the launch included), and
    ``torch.cuda.current_stream``, which the wrapper no longer calls."""
    from repro_torch.core import device as devmod
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.kernels import build
    kfused = sched.ndim == 5
    f32 = torch.float32
    bm, bn = geom["block_m"], geom["block_n"]
    g = bsk.check_problem(a, b, sched, counts, kfused=kfused, **geom)
    e, m, n, k, mt, nt, s = g
    kind = bsk.route(src, a.dtype, b.dtype, n, k)
    sms = bsk._sm_count(a.device.index or 0)
    splits = bsk.route_splits(kind, g, bm, bn, sms)
    if splits != 1:
        raise AssertionError(f"{src}: served shape split {splits} ways")
    index = a.get_device()
    out = a.new_empty((e, m, n), dtype=f32)
    fn = build.function(src)
    stream = torch._C._cuda_getCurrentRawStream(index)

    def ctypes_launch():
        words = array.array("q", (
            bsk.ROUTES[kind], 1, a.data_ptr(), b.data_ptr(),
            sched.data_ptr(), counts.data_ptr(), out.data_ptr(), 0, e, m, n,
            k, mt, nt, s, bm, bn, geom["slice_k"], 1, stream))
        return fn(words.buffer_info()[0])

    parts = {
        "wrapper": lambda: kern(a, b, sched, counts, out_dtype=f32, **geom),
        "device checks": lambda: devmod.check_all_on(
            devmod.resolve(a.device), a=a, b=b, schedule=sched,
            counts=counts),
        "shape checks": lambda: bsk.check_problem(a, b, sched, counts,
                                                  kfused=kfused, **geom),
        "route and splits": lambda: bsk.route_splits(
            bsk.route(src, a.dtype, b.dtype, n, k), g, bm, bn,
            bsk._sm_count(index)),
        "allocation": lambda: a.new_empty((e, m, n), dtype=f32),
        "stream": lambda: torch._C._cuda_getCurrentRawStream(index),
        "launch words and ctypes call": ctypes_launch,
        # what the stream and the call cost before they were trimmed
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(
            a.device).cuda_stream,
    }
    us = {}
    for name, f in parts.items():
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        us[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    return us


def phase_grouped(torch, cfg):
    """K3/K4 against their plain versions at the decode attention shapes,
    in bf16, float32 and (the value) float32 p against bf16 V, and at a
    ragged shape on every route's types; each shape's route and splits,
    CUDA events and device time per call, their difference (the host's
    share), the bytes of B (V, for the value) the data needs; totals at
    the served types (score bf16 in, value float32 p against bf16 V,
    float32 out), summed over one generate's KV_CALLS launches per site;
    then the wrapper's host time at the served shapes, split into its
    parts."""
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.kernels import grouped_spgemm as gsk
    from repro_torch.sparse import dispatch as dsp
    from repro_torch.sparse import plan as pln
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    kv_cfg = dataclasses.replace(cfg, **KV_MODES["dual+kv"])
    kernels = {
        "K3": (gsk.grouped_spgemm_planned,
               gsk.grouped_spgemm_planned_plain, None, "grouped_spgemm.cu"),
        "K4": (gsk.grouped_spgemm_kfused_planned,
               gsk.grouped_spgemm_kfused_planned_plain, "k",
               "grouped_spgemm_kfused.cu"),
    }
    served = {"attn.score": "bfloat16", "attn.value": "mixed"}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = {kn: 0.0 for kn in kernels}
    totals = {kn: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
                       library_device_ms=0.0, plan_ms=0.0, nbytes=0.0,
                       op_s=0.0) for kn in kernels}
    last_served = {}

    def pair(kn, x, w, geom, out_dtype):
        """(kernel out, plain out, kernel fn, plain fn, a, b, sched,
        counts)."""
        kern, plain, condense, _ = kernels[kn]
        sched, counts = dsp.schedule(x, w, mode="dual", condense=condense,
                                     **geom)
        a, b = operand_arrays(x, w)
        a, b = a.contiguous(), b.contiguous()
        ks = sched.gk if condense else sched
        y = kern(a, b, ks, counts, out_dtype=out_dtype, **geom)
        p = plain(a, b, ks, counts, out_dtype=out_dtype, **geom)
        torch.cuda.synchronize()
        return (y, p, lambda: kern(a, b, ks, counts, out_dtype=out_dtype,
                                   **geom),
                lambda: plain(a, b, ks, counts, out_dtype=out_dtype, **geom),
                a, b, sched, counts)

    def add(t, key, x, mult):
        t[key] = None if x is None or t[key] is None else t[key] + mult * x

    for written in KV_WRITTEN:
        ops = attention_products(torch, kv_cfg, written, g)
        for op, (x32, w32) in ops.items():
            a32, b32 = operand_arrays(x32, w32)
            e_, c, k, n = a32.shape[0], a32.shape[1], a32.shape[2], \
                b32.shape[2]
            geom = site_geometry(kv_cfg, op, c, n, k)
            bm, bn, sk = geom["block_m"], geom["block_n"], geom["slice_k"]
            dims = (e_, c, n, k, pln._cdiv(c, bm), pln._cdiv(n, bn),
                    pln._cdiv(k, sk))
            types = ("bfloat16", "float32") + (
                ("mixed",) if op == "attn.value" else ())
            for dtype in types:
                at, bt = (getattr(torch, t) for t in GROUPED_TYPES[dtype])
                x, w = as_dtype(x32, w32, at, bt)
                line = [f"{op} E={e_} M={c} K={k} N={n} "
                        f"{dtype} in, float32 out, {written} slots written, "
                        f"blocks {tuple(geom.values())}"]
                peak = PEAK_FLOPS["bfloat16" if dtype == "bfloat16"
                                  else "float32"]
                b_lib = None if dtype != "mixed" else b32.contiguous()
                for kn, (_, _, condense, src) in kernels.items():
                    y, p, kfn, pfn, a, b, sched, counts = pair(
                        kn, x, w, geom, torch.float32)
                    e = check_pair(torch, kn, y, p, "float32", line[0])
                    err[kn] = max(err[kn], e)
                    kind = bsk.route(src, a.dtype, b.dtype, n, k)
                    splits = bsk.route_splits(kind, dims, bm, bn, sms)
                    s = counts.numel() * (
                        sched.gk.shape[-2] if condense else sched.shape[-1])
                    line.append(f"{kn} route {kind}, splits {splits}, steps "
                                f"{int(counts.sum())} of {s}, err {e:.2e}")
                    ms = cuda_ms(torch, kfn, 20)
                    dms = device_ms(torch, kfn, 20)
                    pms = cuda_ms(torch, pfn, 3)
                    # one PyTorch call over every slot; for the mixed pair
                    # on a float32 copy of V made beforehand (bmm takes one
                    # type), which the kernel does not need
                    lib = (lambda: torch.bmm(a, b)) if b_lib is None else \
                        (lambda: torch.bmm(a, b_lib))
                    lms = cuda_ms(torch, lib, 20)
                    ldms = device_ms(torch, lib, 20)
                    plan_ms = cuda_ms(torch, lambda: dsp.schedule(
                        x, w, mode="dual", condense=condense, **geom), 5)
                    nb, fl, b_bytes = needed_work(
                        torch, a, b, torch.float32, geom, sched, counts,
                        condense)
                    bound = max(nb / HBM_BYTES_PER_S, fl / peak) * 1e3
                    host = "not measured" if dms is None else \
                        f"{ms - dms:.4f}"
                    line.append(f"{ms:.4f} ms events, device {fmt_ms(dms)}, "
                                f"host {host} (bound {bound:.4f}, B read "
                                f"{b_bytes / 1e6:.3f} MB, plain {pms:.2f}, "
                                f"torch.bmm over all {CAPACITY} slots "
                                f"{lms:.4f}, device {fmt_ms(ldms)}, planning "
                                f"{plan_ms:.3f})")
                    if dtype == served[op]:
                        t = totals[kn]
                        mult = KV_CALLS / len(KV_WRITTEN)
                        t["ms"] += mult * ms
                        add(t, "device_ms", dms, mult)
                        t["plain_ms"] += mult * pms
                        t["library_ms"] += mult * lms
                        add(t, "library_device_ms", ldms, mult)
                        t["plan_ms"] += mult * plan_ms
                        t["nbytes"] += mult * nb
                        # each product's operations at its own type's peak
                        t["op_s"] += mult * fl / peak
                        last_served[(kn, op)] = (
                            a, b, sched.gk if condense else sched, counts,
                            geom)
                log("grouped: " + "; ".join(line))
        del ops
        torch.cuda.empty_cache()

    # the wrapper's host time at the served shapes, by part
    for (kn, op), (a, b, sched, counts, geom) in last_served.items():
        kern, _, _, src = kernels[kn]
        us = wrapper_parts(torch, kern, src, a, b, sched, counts, geom)
        log(f"grouped: wrapper host time, {kn} {op} (served types, "
            f"{KV_WRITTEN[-1]} slots): " + ", ".join(
                f"{name} {v:.1f} us" for name, v in us.items())
            + " a call (perf_counter over 300 calls)")

    # ragged: odd M, N, K, partial slices, an empty problem, and problems
    # filled to different depths
    e, c, k, n = 5, 37, 200, 50
    a32 = torch.randn(e, c, k, device=dev, generator=g)
    b32 = torch.randn(e, k, n, device=dev, generator=g)
    b32[torch.rand(e, k, n, device=dev, generator=g) < 0.3] = 0
    for i, frac in enumerate((1.0, 0.6, 0.0, 0.25, 0.9)):
        a32[i, int(c * frac):] = 0
    geom = dict(block_m=16, block_n=16, slice_k=32)
    for dtype, (at, bt) in GROUPED_TYPES.items():
        for out_dtype in (None, torch.float32, torch.bfloat16):
            a, b = a32.to(getattr(torch, at)), b32.to(getattr(torch, bt))
            odt = at if out_dtype is None else str(out_dtype)[6:]
            for kn in kernels:
                y, p, *_, counts = pair(kn, a, b, geom, out_dtype)
                if not (counts[2] == 0).all() or y[2].any():
                    raise AssertionError(f"{kn}: the empty problem ran")
                if y.dtype != p.dtype:
                    raise AssertionError(f"{kn}: dtype {y.dtype}")
                err[kn] = max(err[kn], check_pair(
                    torch, kn, y, p, odt, f"ragged {e}x{c}x{k}x{n}"))
    log(f"grouped: ragged E={e} M={c} K={k} N={n} geometry "
        f"{tuple(geom.values())}, problem 2 empty: K3 and K4 agree with "
        "their plain versions (bf16, float32 and float32 x bf16 in; "
        "default/float32/bf16 out)")

    # the dense GQA families' first decode over a 32768-slot cache that
    # holds the 3000-token prompts: the score on the narrow route at N = G
    # (7, 8, 16), the value on the mixed route, at the served types
    from repro_torch.configs import get_config
    for arch in DENSE_GQA:
        fcfg = dataclasses.replace(get_config(arch), **KV_MODES["dual+kv"])
        written = F_PROMPT_LEN + 1
        ops = attention_products(torch, fcfg, written, g, F_CAPACITY)
        for op, (x32, w32) in ops.items():
            a32, b32 = operand_arrays(x32, w32)
            e_, c, k, n = a32.shape[0], a32.shape[1], a32.shape[2], \
                b32.shape[2]
            geom = site_geometry(fcfg, op, c, n, k)
            at, bt = (getattr(torch, t)
                      for t in GROUPED_TYPES[served[op]])
            x, w = as_dtype(x32, w32, at, bt)
            line = [f"{arch} {op} E={e_} M={c} K={k} N={n} "
                    f"{served[op]} in, {written} of {F_CAPACITY} slots "
                    f"written, blocks {tuple(geom.values())}"]
            for kn, (_, _, condense, src) in kernels.items():
                y, p, kfn, _, a, b, sched, counts = pair(
                    kn, x, w, geom, torch.float32)
                e = check_pair(torch, kn, y, p, "float32", line[0])
                err[kn] = max(err[kn], e)
                kind = bsk.route(src, a.dtype, b.dtype, n, k)
                want = "narrow" if op == "attn.score" else "mixed"
                if kind != want:
                    raise AssertionError(f"{line[0]}: {kn} on route {kind}, "
                                         f"expected {want}")
                dims = (e_, c, n, k, pln._cdiv(c, geom["block_m"]),
                        pln._cdiv(n, geom["block_n"]),
                        pln._cdiv(k, geom["slice_k"]))
                splits = bsk.route_splits(kind, dims, geom["block_m"],
                                          geom["block_n"], sms)
                s = counts.numel() * (
                    sched.gk.shape[-2] if condense else sched.shape[-1])
                line.append(f"{kn} route {kind}, splits {splits}, steps "
                            f"{int(counts.sum())} of {s}, err {e:.2e}, "
                            f"{cuda_ms(torch, kfn, 10):.4f} ms events, "
                            f"device {fmt_ms(device_ms(torch, kfn, 10))}")
            log("grouped: " + "; ".join(line))
        del ops
        torch.cuda.empty_cache()
    return err, totals


# ---------------------------------------------------------------------------
# phase 5: a small reference
# ---------------------------------------------------------------------------

def phase_reference(torch):
    """The smoke model in float32: the card's kernels against the CPU
    plain path, same weights and tokens (1e-4 on the logits)."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    cfg = smoke_config(ARCH)
    cpu = tfm.init_model(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    gpu = copy.deepcopy(cpu).to("cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(1))
    rc = RunConfig(act_dtype="float32")
    for mode in ("dual", "dual+kc"):
        c = dataclasses.replace(cfg, **MODES[mode])
        want = cpu({"tokens": tokens}, c, rc=rc).logits
        got = gpu({"tokens": tokens.cuda()}, c, rc=rc).logits.cpu()
        err = (got - want).abs().max().item()
        if not err <= 1e-4 * want.abs().max().item():
            raise AssertionError(f"smoke {mode}: card vs CPU logits {err}")
        tc = serve_loop.generate(cpu, {"tokens": tokens}, c,
                                 max_new_tokens=6, rc=rc, device="cpu")
        tg = serve_loop.generate(gpu, {"tokens": tokens}, c,
                                 max_new_tokens=6, rc=rc)
        if not torch.equal(tc, tg.cpu()):
            raise AssertionError(f"smoke {mode}: tokens differ")
        log(f"reference: smoke {mode} on the card == CPU plain path "
            f"(logits max err {err:.2e}, 6 greedy tokens equal)")
    for mode in ("dual+kv", "dual+kc+kv"):
        # a 48-slot context in 8-slot blocks, 15 of its slots live
        c = dataclasses.replace(cfg, sparse_block_t=8, **KV_MODES[mode])
        tc = serve_loop.generate(cpu, {"tokens": tokens}, c,
                                 max_new_tokens=7, capacity=48, rc=rc,
                                 device="cpu")
        tg = serve_loop.generate(gpu, {"tokens": tokens}, c,
                                 max_new_tokens=7, capacity=48, rc=rc)
        if not torch.equal(tc, tg.cpu()):
            raise AssertionError(f"smoke {mode}: tokens differ")
        log(f"reference: smoke {mode} (48-slot cache) on the card == CPU "
            "plain path (7 greedy tokens equal)")


# ---------------------------------------------------------------------------
# phase 6: serving at full width
# ---------------------------------------------------------------------------

def make_model(torch, cfg):
    """The served model: full width, random bf16 weights from a seed."""
    from repro_torch.models import transformer as tfm
    t0 = time.perf_counter()
    model = tfm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serving: {cfg.name} at full width, {cfg.n_layers} layers, "
        f"{n_params / 1e9:.2f} B bf16 parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB), made in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def site_steps(tape, entries):
    """{tape name: [dense, counted, executed]} summed over the entries."""
    sites = {}
    for e in tape.summarize(entries):
        s = sites.setdefault(e["name"], [0, 0, 0])
        s[0] += e["dense_steps"]
        s[1] += e["sparse_steps"]
        s[2] += e["executed_steps"]
    return sites


def parting_report(torch, mode, toks, base_toks, base_steps, tol):
    """Greedy tokens may part from the baseline only where the
    baseline's top-2 logits are within ``tol``."""
    agree = []
    for r in range(toks.shape[0]):
        diff = (toks[r] != base_toks[r]).nonzero()
        if len(diff) == 0:
            agree.append(f"row {r}: all {toks.shape[1]} equal")
            continue
        t = int(diff[0])
        top2 = torch.topk(base_steps[t][r], 2).values
        gap = float(top2[0] - top2[1])
        if not gap <= tol:
            raise AssertionError(
                f"{mode}: row {r} parts from the baseline at step {t} "
                f"where its top-2 gap {gap:.3f} > {tol:.3f}")
        agree.append(f"row {r}: parts at step {t}, baseline top-2 gap "
                     f"{gap:.3f}")
    return agree


def traffic_a_batch(torch, cfg):
    """Traffic A's prompts: PROMPTS random prompts of PROMPT_LEN tokens."""
    prompts = torch.randint(0, cfg.vocab_size, (PROMPTS, PROMPT_LEN),
                            generator=torch.Generator().manual_seed(2))
    return {"tokens": prompts.cuda()}


def phase_serving(torch, cfg, model):
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    from repro_torch.sparse import tape
    batch = traffic_a_batch(torch, cfg)
    want = 13 * NEW_TOKENS
    counters = (bsk.bitmap_spgemm_planned, bsk.bitmap_spgemm_kfused_planned)
    launches, tokens, walls = {}, {}, {}
    for mode, knobs in MODES.items():
        c = dataclasses.replace(cfg, **knobs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        with tape.collect() as entries:
            out = serve_loop.generate(model, batch, c,
                                      max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        walls[mode] = dt * 1e3
        counts = [fn.launches for fn in counters]
        launches[mode] = counts
        expect = {"dense": [0, 0], "dual": [want, 0],
                  "dual+kc": [0, want]}[mode]
        if counts != expect:
            raise AssertionError(f"{mode}: launches K1/K2 {counts}, "
                                 f"expected {expect}")
        if tuple(out.shape) != (PROMPTS, NEW_TOKENS):
            raise AssertionError(f"{mode}: tokens of shape {out.shape}")
        tokens[mode] = out.cpu()
        sites = site_steps(tape, entries)
        log(f"serving: {mode}: {PROMPTS * NEW_TOKENS / dt:.2f} tokens/s "
            f"({dt:.2f} s for generate, stats tape on), launches K1/K2 "
            f"{counts}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; "
            "dense/executed steps " + ", ".join(
                f"{k} {v[0]}/{v[2]}" for k, v in sites.items()))

    # prefill logits of each path, and dense's per-step logits
    logits = {}
    for mode, knobs in MODES.items():
        c = dataclasses.replace(cfg, **knobs)
        caches = tfm.init_caches(c, PROMPTS, PROMPT_LEN + NEW_TOKENS)
        state, lg = serve_loop.make_prefill_step(c)(model, batch, caches)
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{mode}: non-finite prefill logits")
        logits[mode] = lg.float()
        if mode == "dense":
            steps = [lg[:, -1].float()]
            decode = serve_loop.make_decode_step(c)
            toks = [state.last_token[:, 0]]
            for _ in range(NEW_TOKENS - 1):
                state, lg1 = decode(model, state)
                steps.append(lg1.float())
                toks.append(state.last_token[:, 0])
            if not torch.equal(torch.stack(toks, 1).int().cpu(),
                               tokens["dense"]):
                raise AssertionError("dense stepwise != dense generate")
    scale = logits["dense"].abs().max().item()
    tol = SERVE_RTOL * scale
    for mode in ("dual", "dual+kc"):
        err = (logits[mode] - logits["dense"]).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{mode}: prefill logits differ from dense "
                                 f"by {err:.3f} > {tol:.3f}")
        agree = parting_report(torch, mode, tokens[mode], tokens["dense"],
                               steps, tol)
        log(f"serving: {mode}: prefill logits max |diff| {err:.4f} <= "
            f"{tol:.4f} ({SERVE_RTOL} x max|dense| {scale:.2f}); "
            + "; ".join(agree))
    return launches, walls


# ---------------------------------------------------------------------------
# phase 7: serving with sparse KV caches
# ---------------------------------------------------------------------------

def phase_serving_kv(torch, cfg, model):
    """Long allocated context, short live one: 2 prompts of 256 tokens in
    a 4096-slot cache, 16 new tokens, through ``generate``."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    from repro_torch.sparse import tape
    prompts = torch.randint(0, cfg.vocab_size, (KV_PROMPTS, KV_PROMPT_LEN),
                            generator=torch.Generator().manual_seed(3))
    batch = {"tokens": prompts.cuda()}
    counters = kernel_counters()
    proj = 13 * KV_NEW_TOKENS              # K1/K2: 13 dispatches a forward
    grouped = 2 * KV_CALLS                 # K3/K4: 2 sites a layer and step
    expect = {"dual": {"K1": proj},
              "dual+kv": {"K1": proj, "K3": grouped},
              "dual+kc+kv": {"K2": proj, "K4": grouped}}
    launches, tokens, walls, fractions = {}, {}, {}, {}
    for mode, knobs in KV_MODES.items():
        c = dataclasses.replace(cfg, **knobs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with tape.collect() as entries:
            out = serve_loop.generate(model, batch, c, capacity=CAPACITY,
                                      max_new_tokens=KV_NEW_TOKENS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        walls[mode] = dt * 1e3
        got = {kn: fn.launches for kn, fn in counters.items()}
        launches[mode] = got
        want = {kn: expect[mode].get(kn, 0) for kn in counters}
        if got != want:
            raise AssertionError(f"{mode}: launches {got}, expected {want}")
        if tuple(out.shape) != (KV_PROMPTS, KV_NEW_TOKENS):
            raise AssertionError(f"{mode}: tokens of shape {out.shape}")
        tokens[mode] = out.cpu()
        sites = site_steps(tape, entries)
        attn_entries = [e for e in tape.summarize(entries)
                        if e["name"] in ("attn.score", "attn.value")]
        if knobs.get("sparse_kv"):
            if len(attn_entries) != grouped:
                raise AssertionError(f"{mode}: {len(attn_entries)} attention "
                                     f"tape entries, expected {grouped}")
            for e in attn_entries:
                if not (e["executed_steps"] == e["sparse_steps"]
                        < e["dense_steps"]):
                    raise AssertionError(f"{mode}: tape entry {e}")
            fractions[mode] = {
                k: sites[k][1] / sites[k][0]
                for k in ("attn.score", "attn.value")}
        elif attn_entries:
            raise AssertionError(f"{mode}: plain caches ran attend_sparse")
        log(f"serving kv: {mode}: {KV_PROMPTS * KV_NEW_TOKENS / dt:.2f} "
            f"tokens/s ({dt:.2f} s for generate, {KV_PROMPTS} x "
            f"{KV_PROMPT_LEN}-token prompts, {CAPACITY}-slot caches, "
            f"stats tape on), launches {got}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB"
            + ("; scheduled share of cache-block steps " + ", ".join(
                f"{k} {v:.4f}" for k, v in fractions[mode].items())
               if mode in fractions else "")
            + "; dense/counted/executed steps " + ", ".join(
                f"{k} {v[0]}/{v[1]}/{v[2]}" for k, v in sites.items()))

    # logits: the baseline stepwise, then each KV mode's prefill and its
    # decode fed the baseline's tokens
    base = dataclasses.replace(cfg, **KV_MODES["dual"])
    state, lg = serve_loop.make_prefill_step(base)(
        model, batch, tfm.init_caches(base, KV_PROMPTS, CAPACITY))
    base_prefill = lg.float()
    steps, toks = [lg[:, -1].float()], [state.last_token[:, 0]]
    decode = serve_loop.make_decode_step(base)
    for _ in range(KV_NEW_TOKENS - 1):
        state, lg1 = decode(model, state)
        steps.append(lg1.float())
        toks.append(state.last_token[:, 0])
    if not torch.equal(torch.stack(toks, 1).int().cpu(), tokens["dual"]):
        raise AssertionError("dual stepwise != dual generate")
    tol = SERVE_RTOL * base_prefill.abs().max().item()
    base_toks = tokens["dual"].cuda().long()
    for mode in ("dual+kv", "dual+kc+kv"):
        c = dataclasses.replace(cfg, **KV_MODES[mode])
        plain = dataclasses.replace(c, sparse_kv=False)
        state, lg = serve_loop.make_prefill_step(c)(
            model, batch, tfm.init_caches(c, KV_PROMPTS, CAPACITY))
        _, lg_plain = serve_loop.make_prefill_step(plain)(
            model, batch, tfm.init_caches(plain, KV_PROMPTS, CAPACITY))
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{mode}: non-finite prefill logits")
        if not torch.equal(lg, lg_plain):
            raise AssertionError(f"{mode}: prefill logits differ from the "
                                 "same mode's with plain caches")
        pre_err = (lg.float() - base_prefill).abs().max().item()
        decode = serve_loop.make_decode_step(c)
        dec_err = 0.0
        for t in range(1, KV_NEW_TOKENS):
            state = state._replace(last_token=base_toks[:, t - 1:t])
            state, lg1 = decode(model, state)
            if not torch.isfinite(lg1).all():
                raise AssertionError(f"{mode}: non-finite decode logits")
            dec_err = max(dec_err,
                          (lg1.float() - steps[t]).abs().max().item())
        if not (pre_err <= tol and dec_err <= tol):
            raise AssertionError(
                f"{mode}: logits differ from the dual baseline by "
                f"{pre_err:.3f} (prefill) / {dec_err:.3f} (decode) > "
                f"{tol:.3f}")
        agree = parting_report(torch, mode, tokens[mode], tokens["dual"],
                               steps, tol)
        log(f"serving kv: {mode}: prefill logits == the same mode's with "
            f"plain caches; max |diff| to the dual baseline {pre_err:.4f} "
            f"(prefill), {dec_err:.4f} (15 decodes fed its tokens) <= "
            f"{tol:.4f} ({SERVE_RTOL} x max|baseline| "
            f"{tol / SERVE_RTOL:.2f}); " + "; ".join(agree))
    return launches, walls, fractions


def phase_attention_split(torch, cfg):
    """One decode attention call at the served geometry (2 rows, a
    4096-slot cache holding 264 tokens), timed whole and in parts:
    planning (occupancy, the slot schedule, the operands' metadata and
    both dispatch schedules), operand copies (the (E, T, hd) views of K
    and V; the kernels read V as stored, so there is no float32 copy of
    it), the two kernels, and the rest
    (scaling, masks, softmax, reshapes); beside it the dense attention
    the plain-cache baseline runs over every slot.  Returns ms per
    call."""
    from repro_torch.kernels import grouped_spgemm as gsk
    from repro_torch.models import attention as attn
    from repro_torch.models import cache as kvc
    from repro_torch.sparse import dispatch as dsp
    from repro_torch.sparse import kvcache as skvc
    from repro_torch.sparse import plan as pln
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    b, kvh, hd = KV_PROMPTS, cfg.n_kv_heads, cfg.hd
    grp, ne = cfg.n_heads // kvh, KV_PROMPTS * cfg.n_kv_heads
    written = KV_PROMPT_LEN + KV_NEW_TOKENS // 2
    cache = skvc.init_sparse_cache(b, CAPACITY, kvh, hd, window=CAPACITY,
                                   block_t=cfg.sparse_block_t, device=dev)
    kv = torch.randn(2, b, written, kvh, hd, device=dev, generator=g,
                     dtype=torch.bfloat16)
    cache = skvc.update(cache, kv[0], kv[1])
    q = torch.randn(b, 1, cfg.n_heads, hd, device=dev, generator=g,
                    dtype=torch.bfloat16)
    qpos = torch.tensor([written - 1], device=dev)
    kpos = kvc.key_positions(cache)
    split = {}
    for mode, kn in (("dual+kv", "K3"), ("dual+kc+kv", "K4")):
        c = dataclasses.replace(cfg, **KV_MODES[mode])
        condense = "k" if c.sparse_kcondense else None
        kern = (gsk.grouped_spgemm_kfused_planned if condense
                else gsk.grouped_spgemm_planned)

        def copies():
            kd, vd, _ = kvc.read(cache, dtype=q.dtype)
            k_e = kd.transpose(1, 2).reshape(ne, CAPACITY, hd)
            v_e = vd.transpose(1, 2).reshape(ne, CAPACITY, hd)
            return k_e, v_e

        k_e, v_e = copies()
        q_e = q.reshape(b, kvh, grp, hd).transpose(2, 3).reshape(ne, hd, grp)
        p_e = torch.rand(ne, grp, CAPACITY, device=dev, generator=g)
        g_s = site_geometry(c, "attn.score", CAPACITY, grp, hd)
        g_v = site_geometry(c, "attn.value", grp, hd, CAPACITY)

        def planning():
            occ = skvc.occupancy_mask(cache)
            sched = pln.kv_decode_slots(occ, kpos, qpos[0], None)
            x_k = skvc.score_operand(k_e, sched, g_s["slice_k"])
            s_s = dsp.schedule(x_k, q_e, mode="dual", condense=condense,
                               **g_s)
            x_p, w_v = skvc.value_operands(occ, p_e * sched, v_e, sched,
                                           g_v["slice_k"])
            s_v = dsp.schedule(x_p, w_v, mode="dual", condense=condense,
                               **g_v)
            return s_s, s_v, x_p.values

        (ks_s, cnt_s), (ks_v, cnt_v), p_sched = planning()
        if condense:
            ks_s, ks_v = ks_s.gk, ks_v.gk
        f32 = torch.float32
        # the dispatch hands the kernels contiguous operands
        q_c, p_c = q_e.contiguous(), p_sched.contiguous()

        def kernels():
            kern(k_e, q_c, ks_s, cnt_s, out_dtype=f32, **g_s)
            kern(p_c, v_e, ks_v, cnt_v, out_dtype=f32, **g_v)

        def dense():
            kd, vd, _ = kvc.read(cache, dtype=q.dtype)
            return attn.attend(q, kd, vd, qpos=qpos, kpos=kpos)

        parts = {"total": lambda: attn.attend_sparse(q, cache, c, qpos=qpos,
                                                     kpos=kpos),
                 "planning": planning, "copies": copies, "kernels": kernels,
                 "dense": dense}
        n0 = kern.launches
        # host-bound parts drift: time them in turns, 30 rounds, medians
        times = {name: [] for name in parts}
        for _ in range(30):
            for name, fn in parts.items():
                times[name].append(cuda_ms(torch, fn, 1))
        if kern.launches == n0:
            raise AssertionError(f"{kn}: attention split launched nothing")
        t = {name: statistics.median(v) for name, v in times.items()}
        t["rest"] = t["total"] - t["planning"] - t["copies"] - t["kernels"]
        split[mode] = t
        copy_mb = (k_e.numel() * k_e.element_size()
                   + v_e.numel() * v_e.element_size()) / 1e6
        log(f"attention split: {mode}: one decode attention call "
            f"{t['total']:.3f} ms = planning {t['planning']:.3f} + operand "
            f"copies {t['copies']:.3f} ({copy_mb:.1f} MB written) + {kn} "
            f"score and value {t['kernels']:.3f} + the rest "
            f"{t['rest']:.3f} (medians of 30 rounds in turns); x "
            f"{KV_CALLS} calls a generate = {t['total'] * KV_CALLS:.1f} ms; "
            f"dense attention over all {CAPACITY} slots {t['dense']:.3f} ms "
            f"a call")
    return split


# ---------------------------------------------------------------------------
# the conv kernels against their plain versions, and the whisper path
# ---------------------------------------------------------------------------

def raw_bits(t):
    """Bit patterns, so that equality is bit-equality (-0.0 != 0.0)."""
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def stem_inputs(torch, cfg, g, dtype):
    """The two stem convs' inputs at the whisper traffic's shapes, NHWC:
    conv1 reads the time-padded mel frames (ReLU-clipped normal, as the
    JAX package's ``frontend_inputs``), conv2 the time-padded GeLU of a
    normal (the GeLU output of conv1: dense)."""
    import torch.nn.functional as F
    t = 2 * cfg.encoder_len
    mel = torch.randn(W_SEGMENTS, t, cfg.n_mels, device="cuda",
                      generator=g).clamp(min=0)
    h = F.gelu(torch.randn(W_SEGMENTS, t, cfg.d_model, device="cuda",
                           generator=g), approximate="tanh")
    return (F.pad(mel[:, None], (0, 0, 1, 1)).to(dtype),
            F.pad(h[:, None], (0, 0, 1, 1)).to(dtype))


def conv_check(torch, x, kh, kw, stride, what):
    """K5 on the NHWC input's (N, C, H, W) view, then K6 (stride 1) or K7
    on K5's outputs, each held bit-equal against its plain version on the
    same inputs.  Returns the timing closures and the bound's bytes."""
    from repro_torch.kernels import bitmap_encode as k5
    from repro_torch.kernels import sparse_im2col as k67
    xv = x.permute(0, 3, 1, 2)
    bits, cond = k5.bitmap_encode(xv)
    pb, pc = k5.bitmap_encode_plain(xv)
    torch.cuda.synchronize()
    if not (torch.equal(bits, pb) and torch.equal(raw_bits(cond),
                                                  raw_bits(pc))):
        raise AssertionError(f"K5 != plain at {what}")
    if stride == 1:
        kern = functools.partial(k67.sparse_im2col, cond, bits, kh=kh, kw=kw)
        plain = functools.partial(k67.sparse_im2col_plain, cond, bits,
                                  kh=kh, kw=kw)
    else:
        kern = functools.partial(k67.sparse_im2col_strided, cond, bits,
                                 kh=kh, kw=kw, stride=stride)
        plain = functools.partial(k67.sparse_im2col_strided_plain, cond,
                                  bits, kh=kh, kw=kw, stride=stride)
    ob, ov = kern()
    qb, qv = plain()
    torch.cuda.synchronize()
    if not (torch.equal(ob, qb) and torch.equal(raw_bits(ov), raw_bits(qv))):
        raise AssertionError(f"{'K6' if stride == 1 else 'K7'} != plain at "
                             f"{what}")
    k5_bytes, k67_bytes = conv_kernel_bytes(torch, x, bits, cond, ob, ov)
    xn = xv.contiguous()
    return dict(
        routes=conv_routes(x, kh, kw, stride),
        k5=lambda: k5.bitmap_encode(xv),
        k5_plain=lambda: k5.bitmap_encode_plain(xv),
        k67=kern, k67_plain=plain,
        unfold=lambda: torch.nn.functional.unfold(xn, (kh, kw),
                                                  stride=stride),
        k5_bytes=k5_bytes, k67_bytes=k67_bytes,
        zero_share=1.0 - int(torch.count_nonzero(ov)) / ov.numel())


def conv_kernel_bytes(torch, x, bits, cond, ob, ov):
    """The bytes K5 and K6/K7 must move on input x, K5's outputs (bits,
    cond) and K6/K7's (ob, ov): K5 tests every element (x read whole, bits
    and cond written whole); K6/K7 read only the condensed rows'
    non-zeros and the bitmaps, and write their whole outputs (the zero
    tails included)."""
    e = x.element_size()
    return (x.numel() * e * 2 + bits.numel() * 4,
            int(torch.count_nonzero(cond)) * e + bits.numel() * 4
            + ob.numel() * 4 + ov.numel() * e)


def conv_routes(x, kh, kw, stride):
    """Each conv kernel's route on the NHWC input x and its CUDA blocks,
    from K5's, K6's and K7's rules."""
    from repro_torch.kernels import bitmap_encode as k5
    from repro_torch.kernels import sparse_im2col as k67
    xv = x.permute(0, 3, 1, 2)
    n, c, h, w = xv.shape
    r5 = k5.encode_route(xv)
    k5_route = (f"{r5}, {k5.encode_blocks(xv, r5)} blocks"
                + (" a pass, 2 passes" if r5 == "channels" else ""))
    if stride == 1:
        route, pj = k67.k6_route(n, c, h, w, kh, kw)
    else:
        route, pj = k67.strided_route(n, c, h, w, kh, kw, stride)
    if route == "feature":
        oww = -(-((w - kw) // stride + 1) // 32)
        return k5_route, (f"feature, {n * c * kh} blocks, pieces of {pj} "
                          f"output words ({-(-oww // pj)} a feature row)")
    return k5_route, f"lowered, {n * c * kh * kw} blocks"


def k6_lowered_route(torch, res):
    """K6 at ``res``'s shape on its lowered route (one block per lowered
    row, K6's whole kernel before its feature route existed): held
    bit-equal to plain, and its device time."""
    from repro_torch.kernels import sparse_im2col as k67
    rule = k67.k6_route
    k67.k6_route = lambda *args: ("lowered", 0)
    try:
        ob, ov = res["k67"]()
        per = device_ms_by_kernel(torch, res["k67"])
    finally:
        k67.k6_route = rule
    qb, qv = res["k67_plain"]()
    torch.cuda.synchronize()
    if not (torch.equal(ob, qb) and torch.equal(raw_bits(ov), raw_bits(qv))):
        raise AssertionError("K6's lowered route != plain at conv1")
    return None if per is None else sum(per.values())


def phase_conv_kernels(torch):
    """K5, K6 and K7 bit-equal to their plain versions in bf16 and float32
    at the whisper stem's shapes, the vision patch shape and ragged ones
    (every route of K5 and K7 among them); bf16 timings at the stem's
    shapes: each kernel's route, device time (K5's by pass) and CUDA
    events per launch beside the byte bound, the achieved bytes per second,
    the plain version and ``F.unfold`` (a dense im2col without bitmaps, a
    yardstick only).  Returns {kernel: totals over one generate's
    launches}."""
    from repro_torch.configs import get_config
    cfg = get_config(WHISPER)
    g = torch.Generator(device="cuda").manual_seed(7)
    totals = {kn: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0)
              for kn in ("K5", "K6", "K7")}
    for dtype in ("bfloat16", "float32"):
        x1, x2 = stem_inputs(torch, cfg, g, getattr(torch, dtype))
        for name, x, stride in (("conv.stem1", x1, 1), ("conv.stem2", x2, 2)):
            n, h, w, c = x.shape
            what = (f"{name} N={n} H={h} W={w} C={c} 1x3 s={stride} "
                    f"{dtype}")
            res = conv_check(torch, x, 1, 3, stride, what)
            if dtype != "bfloat16":
                log(f"conv kernels: {what}: K5 and "
                    f"{'K6' if stride == 1 else 'K7'} bit-equal to plain")
                continue
            kn = "K6" if stride == 1 else "K7"
            t = {k: cuda_ms(torch, res[k], reps)
                 for k, reps in (("k5", 20), ("k5_plain", 3), ("k67", 20),
                                 ("k67_plain", 3), ("unfold", 20))}
            # the kernels' and F.unfold's own device time, by kernel; CUDA
            # events around one call also hold the wrapper's host time
            per = {k: device_ms_by_kernel(torch, res[k])
                   for k in ("k5", "k67", "unfold")}
            if None in per.values():
                log("conv kernels: the profiler traced no device time; "
                    "the kernel times below are CUDA-event times")
                per = {k: {"(events)": t[k]} for k in per}
            dev = {k: sum(v.values()) for k, v in per.items()}
            passes = " + ".join(
                f"{p} {ms:.4f}" for p, ms in sorted(
                    (("pass 1" if "bits" in nm else "pass 2"
                      if "values" in nm else nm.split("(")[0][-40:]), ms)
                    for nm, ms in per["k5"].items()))
            for k, ms, pms, nb, route, extra in (
                    ("K5", dev["k5"], t["k5_plain"], res["k5_bytes"],
                     res["routes"][0], f" = {passes}"),
                    (kn, dev["k67"], t["k67_plain"], res["k67_bytes"],
                     res["routes"][1],
                     f"; F.unfold {dev['unfold']:.4f} "
                     f"(events {t['unfold']:.4f})")):
                totals[k]["ms"] += ms
                totals[k]["plain_ms"] += pms
                totals[k]["nbytes"] += nb
                bound = nb / HBM_BYTES_PER_S * 1e3
                ev = t["k5" if k == "K5" else "k67"]
                log(f"conv kernels: {what}: {k} route {route}: device "
                    f"{ms:.4f} ms{extra}, events {ev:.4f} ms (wrapper "
                    f"included), bound {bound:.4f} ms ({nb / 1e6:.2f} MB), "
                    f"{nb / ms / 1e6:.1f} GB/s = "
                    f"{nb / ms * 1e3 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s "
                    f"({bound / ms:.1%} of the bound), plain {pms:.3f} ms")
            totals[kn]["library_ms"] += dev["unfold"]
            if kn == "K6":
                low = k6_lowered_route(torch, res)
                log(f"conv kernels: {what}: K6 forced onto its lowered route "
                    f"(the earlier kernel, the same code): bit-equal to "
                    f"plain, device {fmt_ms(low)} ms")
            log(f"conv kernels: {what}: bit-equal to plain; "
                f"{res['zero_share']:.4f} of the lowered elements are zero")
        del x1, x2
        torch.cuda.empty_cache()
        routes = set()
        for shape in [PATCH] + CONV_RAGGED:
            n, h, w, c, kh, kw, s = shape
            x = torch.randn(n, h, w, c, device="cuda", generator=g)
            x[torch.rand(x.shape, device="cuda", generator=g) < 0.5] = 0
            x[0, 0, :, 0] = 0                          # an all-zero row
            x[..., 1::7, :] = -0.0
            x[-1, -1, :, -1] = 1.0                     # all non-zero
            if w >= 32:
                x[:, :, 31::32, ::2] = 1.5             # bit 31 set
            res = conv_check(torch, x.to(getattr(torch, dtype)), kh, kw, s,
                             f"{shape} {dtype}")
            routes.add("K5 " + res["routes"][0].split(",")[0])
            routes.add(("K6 " if s == 1 else "K7 ")
                       + res["routes"][1].split(",")[0])
        log(f"conv kernels: {dtype}: the patch shape {PATCH} and "
            f"{len(CONV_RAGGED)} ragged shapes bit-equal to plain; routes "
            f"{', '.join(sorted(routes))}")
    return totals


def phase_reference_whisper(torch):
    """whisper-base-smoke in float32: the card (K5-K7 in the stem, K1/K2
    everywhere, cuDNN in dense mode with TF32 off) against the CPU plain
    path, same weights, mel frames and prompts (1e-4 on the logits,
    greedy tokens equal)."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    cfg = smoke_config(WHISPER)
    cpu = tfm.init_model(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    gpu = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 4), generator=g),
             "mel": torch.randn(2, 2 * cfg.encoder_len, cfg.n_mels,
                                generator=g).clamp(min=0)}
    gbatch = {k: v.cuda() for k, v in batch.items()}
    rc = RunConfig(act_dtype="float32")
    for mode, knobs in MODES.items():
        c = dataclasses.replace(cfg, **knobs)
        want = cpu(batch, c, rc=rc).logits
        got = gpu(gbatch, c, rc=rc).logits.cpu()
        err = (got - want).abs().max().item()
        if not err <= 1e-4 * want.abs().max().item():
            raise AssertionError(f"whisper smoke {mode}: card vs CPU logits "
                                 f"{err}")
        tc = serve_loop.generate(cpu, batch, c, max_new_tokens=6, rc=rc,
                                 device="cpu")
        tg = serve_loop.generate(gpu, gbatch, c, max_new_tokens=6, rc=rc)
        if not torch.equal(tc, tg.cpu()):
            raise AssertionError(f"whisper smoke {mode}: tokens differ")
        log(f"reference: whisper smoke {mode} on the card == CPU plain path "
            f"(logits max err {err:.2e}, 6 greedy tokens equal)")


def whisper_batch(torch, cfg):
    """The whisper traffic: W_SEGMENTS segments of 2 x encoder_len mel
    frames (ReLU-clipped normal, as the JAX package's ``frontend_inputs``)
    and whisper's 4-token start-of-transcript prompt for each."""
    g = torch.Generator(device="cuda").manual_seed(8)
    mel = torch.randn(W_SEGMENTS, 2 * cfg.encoder_len, cfg.n_mels,
                      device="cuda", generator=g).clamp(min=0)
    tokens = torch.tensor([W_PROMPT] * W_SEGMENTS, device="cuda")
    return {"tokens": tokens, "mel": mel}


def phase_serving_whisper(torch, cfg):
    """Full-width, full-depth whisper-base (random bf16 weights from a
    seed) through ``generate`` in dense, dual and dual+kc: exact launch
    counts, stem convs executing what they count, prefill logits and
    tokens against dense."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    from repro_torch.sparse import tape
    t0 = time.perf_counter()
    model = tfm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serving whisper: {cfg.name} at full width and depth "
        f"({cfg.n_encoder_layers} + {cfg.n_layers} layers), "
        f"{n_params / 1e6:.1f} M bf16 parameters, made in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = whisper_batch(torch, cfg)
    counters = kernel_counters()
    n1 = whisper_k1_launches(cfg)
    conv = {"K5": 2, "K6": 1, "K7": 1}
    expect = {"dense": {}, "dual": {"K1": n1, **conv},
              "dual+kc": {"K2": n1, **conv}}
    launches, tokens, walls = {}, {}, {}
    for mode, knobs in MODES.items():
        c = dataclasses.replace(cfg, **knobs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with tape.collect() as entries:
            out = serve_loop.generate(model, batch, c, max_new_tokens=W_NEW)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {kn: fn.launches for kn, fn in counters.items()}
        want = {kn: expect[mode].get(kn, 0) for kn in counters}
        if got != want:
            raise AssertionError(f"whisper {mode}: launches {got}, "
                                 f"expected {want}")
        if tuple(out.shape) != (W_SEGMENTS, W_NEW):
            raise AssertionError(f"whisper {mode}: tokens of shape "
                                 f"{out.shape}")
        launches[mode], tokens[mode], walls[mode] = got, out.cpu(), dt * 1e3
        sites = site_steps(tape, entries)
        for stem in ("conv.stem1", "conv.stem2"):
            d, counted, executed = sites[stem]
            if mode != "dense" and counted != executed:
                raise AssertionError(f"whisper {mode}: {stem} executed "
                                     f"{executed} != counted {counted}")
        log(f"serving whisper: {mode}: {W_SEGMENTS * W_NEW / dt:.2f} "
            f"tokens/s ({dt:.2f} s for generate, {W_SEGMENTS} segments, "
            f"stats tape on), launches "
            f"{ {k: v for k, v in got.items() if v} }, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
            "dense/counted/executed steps " + ", ".join(
                f"{k} {v[0]}/{v[1]}/{v[2]}" for k, v in sites.items()))

    # prefill logits of each path (one prefill timed), dense's per-step
    # logits and decode time
    logits, times = {}, {}
    for mode, knobs in MODES.items():
        c = dataclasses.replace(cfg, **knobs)
        caches = tfm.init_caches(c, W_SEGMENTS, len(W_PROMPT) + W_NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, lg = serve_loop.make_prefill_step(c)(model, batch, caches)
        torch.cuda.synchronize()
        times[mode] = [(time.perf_counter() - t0) * 1e3]
        if not torch.isfinite(lg).all():
            raise AssertionError(f"whisper {mode}: non-finite prefill logits")
        logits[mode] = lg.float()
        decode = serve_loop.make_decode_step(c)
        steps, toks = [lg[:, -1].float()], [state.last_token[:, 0]]
        for _ in range(W_NEW - 1):
            t0 = time.perf_counter()
            state, lg1 = decode(model, state)
            torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t0) * 1e3)
            steps.append(lg1.float())
            toks.append(state.last_token[:, 0])
        if not torch.equal(torch.stack(toks, 1).int().cpu(), tokens[mode]):
            raise AssertionError(f"whisper {mode}: stepwise != generate")
        if mode == "dense":
            dense_steps = steps
    scale = logits["dense"].abs().max().item()
    tol = SERVE_RTOL * scale
    for mode in MODES:
        t = times[mode]
        line = (f"serving whisper: {mode}: one prefill {t[0]:.1f} ms, "
                f"decode steps median {statistics.median(t[1:]):.1f} ms")
        if mode != "dense":
            err = (logits[mode] - logits["dense"]).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"whisper {mode}: prefill logits differ "
                                     f"from dense by {err:.4f} > {tol:.4f}")
            agree = parting_report(torch, f"whisper {mode}", tokens[mode],
                                   tokens["dense"], dense_steps, tol)
            line += (f"; prefill logits max |diff| {err:.4f} <= {tol:.4f} "
                     f"({SERVE_RTOL} x max|dense| {scale:.3f}); "
                     + "; ".join(agree))
        log(line)
    lb = kops.sparse_im2col(
        torch.nn.functional.pad(batch["mel"][:, None], (0, 0, 1, 1)).to(
            torch.bfloat16), 1, 3, 1)
    zero = 1.0 - int(lb.counts.sum()) / lb.values.numel()
    log(f"serving whisper: conv1's lowered input ({W_SEGMENTS} x "
        f"{lb.values.shape[1]} x {lb.values.shape[2]}): {zero:.4f} of its "
        "elements are zero")
    return model, launches, walls, times


def phase_conv_split(torch, cfg, model):
    """One prefill's stem convs at the served shapes, timed whole and in
    parts: K5, K6/K7, the lowering glue (row-packed → flat bitmap, the
    popcount decode to positional values, the transposed repack and slice
    activity, the flattened contiguous rows), the dispatch's planning,
    K1/K2 and the rest; beside the dense ``F.conv2d`` (cuDNN).  Medians of
    20 rounds in turns.  Returns ms per part."""
    import torch.nn.functional as F
    from repro_torch.core import im2col as i2c
    from repro_torch.kernels import bitmap_encode as k5
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparse_im2col as k67
    from repro_torch.models import frontend as fem
    from repro_torch.sparse import activation as act
    from repro_torch.sparse import conv as scv
    from repro_torch.sparse import dispatch as dsp
    from repro_torch.sparse import plan as pln
    from repro_torch.sparse import site
    batch = whisper_batch(torch, cfg)
    fp = model.frontend
    x1 = F.pad(batch["mel"][:, None].to(torch.bfloat16), (0, 0, 1, 1))
    y1, _ = scv.conv2d(x1, fp.conv1, 1)
    x2 = F.pad(act.gelu(y1 + fp.b1), (0, 0, 1, 1))
    split = {}
    for mode in ("dual", "dual+kc"):
        c = dataclasses.replace(cfg, **MODES[mode])
        condense = "k" if c.sparse_kcondense else None
        kern = (bsk.bitmap_spgemm_kfused_planned if condense
                else bsk.bitmap_spgemm_planned)
        for key, x, stride in (("conv1", x1, 1), ("conv2", x2, 2)):
            w4 = getattr(fp, key)
            kh, kwid, _, f = w4.shape
            w2 = w4.reshape(-1, f)
            ow = i2c.out_size(x.shape[2], kwid, stride)
            st = fem.conv_site(key)
            kw_ = site.resolve(
                st, c, n=f, k=w2.shape[0],
                m=x.shape[0] * i2c.out_size(x.shape[1], kh, stride) * ow,
                device="cuda")
            xv = x.permute(0, 3, 1, 2)
            bits, cond = k5.bitmap_encode(xv)

            def im2col():
                if stride == 1:
                    return k67.sparse_im2col(cond, bits, kh=kh, kw=kwid)
                return k67.sparse_im2col_strided(cond, bits, kh=kh, kw=kwid,
                                                 stride=stride)
            ob, ov = im2col()

            def glue():
                lb = kops.rowpacked_to_flat(ob, ov, ow, ov.shape[-1])
                a = scv.lowered_to_activation(lb, kw_["slice_k"])
                a = a.flatten_leading()
                return a, a.values.contiguous()
            a2, av = glue()
            m, k = av.shape
            bm_, bn_, sk_ = pln.clamp_geometry(m, f, k, kw_["block_m"],
                                               kw_["block_n"],
                                               kw_["slice_k"])
            geom = dict(block_m=bm_, block_n=bn_, slice_k=sk_)

            def planning():
                return dsp.schedule(a2, w2, mode="dual", condense=condense,
                                    **geom)
            sched, counts = planning()
            ks = sched.gk if condense else sched
            parts = {
                "total": lambda: site.conv2d(x, w4, stride, site=st, cfg=c),
                "K5": lambda: k5.bitmap_encode(xv), "im2col": im2col,
                "glue": glue, "planning": planning,
                "gemm": lambda: kern(av, w2, ks, counts, **geom),
                "dense": lambda: scv.conv2d(x, w4, stride)}
            times = {name: [] for name in parts}
            for _ in range(20):
                for name, fn in parts.items():
                    times[name].append(cuda_ms(torch, fn, 1))
            t = {name: statistics.median(v) for name, v in times.items()}
            t["rest"] = t["total"] - sum(t[p] for p in (
                "K5", "im2col", "glue", "planning", "gemm"))
            split[(mode, key)] = t
            kn = ("K2" if condense else "K1")
            ki = "K6" if stride == 1 else "K7"
            log(f"conv split: {mode} {fem.conv_site(key).name} ({m} x {k} "
                f"@ {k} x {f}, {int(counts.sum())} of "
                f"{counts.numel() * (ks.shape[-2] if condense else ks.shape[-1])}"
                f" steps): {t['total']:.3f} ms = K5 {t['K5']:.3f} + {ki} "
                f"{t['im2col']:.3f} + lowering glue {t['glue']:.3f} + "
                f"planning {t['planning']:.3f} + {kn} {t['gemm']:.3f} + the "
                f"rest {t['rest']:.3f}; dense F.conv2d {t['dense']:.3f} ms "
                "(medians of 20 rounds in turns)")
    return split


# ---------------------------------------------------------------------------
# phases 10-11: block-pruned models served on cached weight plans
# ---------------------------------------------------------------------------

# every layer's mlp.w_up and mlp.w_down block-pruned at the kernels' skip
# granularity (slice_k x block_n) by core/pruning.block_mask, as the JAX
# package's benchmarks/bench_models.py::run_dispatch prunes them
PRUNE_SPARSITY = 0.5
# the kernels K1 and K2 launch (their split sums included)
K1K2_KERNELS = ("spgemm_mma_kernel", "spgemm_tile_kernel", "split_sum_kernel")


def serve_with_plans(torch, model, c, batch, new, plans, rc=None,
                     capacity=None):
    """``serve_loop.generate``'s prefill and greedy decode steps over
    ``Transformer.forward``, every forward given ``plans`` (the cached
    weight plans, or None: each dispatch plans its weight per call), as
    the JAX engine passes its plans to every prefill and decode; caches of
    ``capacity`` slots (default: the prompt and the new tokens), int8
    under ``rc.kv_quant``.  Each step ends in a synchronize.  Returns the
    tokens (B, new) on the host, the prefill logits, the last position's
    logits of every step and the ms of every step."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    b, s = batch["tokens"].shape
    caches = tfm.init_caches(c, b, capacity or s + new,
                             quantized=bool(rc and rc.kv_quant))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model(batch, c, caches=caches,
                positions=torch.arange(s, device="cuda"), rc=rc,
                weight_plans=plans)
    state = serve_loop.DecodeState(caches=out.caches,
                                   last_token=out.logits[:, -1:].argmax(-1),
                                   pos=s)
    prefill = out.logits.float()
    steps, toks = [prefill[:, -1]], [state.last_token[:, 0]]
    torch.cuda.synchronize()
    times = [(time.perf_counter() - t0) * 1e3]
    for _ in range(new - 1):
        t0 = time.perf_counter()
        out = model({"tokens": state.last_token}, c, caches=state.caches,
                    positions=torch.tensor([state.pos], device="cuda"),
                    rc=rc, weight_plans=plans)
        lg = out.logits[:, 0]
        state = serve_loop.DecodeState(caches=out.caches,
                                       last_token=lg.argmax(-1)[:, None],
                                       pos=state.pos + 1)
        steps.append(lg.float())
        toks.append(state.last_token[:, 0])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(tokens=torch.stack(toks, 1).int().cpu(), prefill=prefill,
                steps=steps, times=times)


def planning_ms(torch, fn):
    """(ms, calls) of the dispatch's planning (``sparse.dispatch.schedule``,
    synchronized on both sides) during ``fn()``."""
    from repro_torch.sparse import dispatch as dsp
    orig, acc = dsp.schedule, [0.0, 0]

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        acc[0] += (time.perf_counter() - t0) * 1e3
        acc[1] += 1
        return out
    dsp.schedule = timed
    try:
        fn()
    finally:
        dsp.schedule = orig
    return acc[0], acc[1]


def k1k2_device_and_bound(torch, fn):
    """K1/K2's device time during one ``fn()`` (a ``torch.profiler``
    trace; None when the trace holds no device time) and their bound: over
    every dispatch, the larger of the bytes its data needs over 3.35 TB/s
    and its flops over the bf16 peak (:func:`needed_work` on the schedule
    the dispatch built), in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sparse import dispatch as dsp
    orig, bound = dsp.schedule, [0.0]

    def hooked(x, w, **kw):
        sched, counts = orig(x, w, **kw)
        if sched is not None:
            a, b = dsp._values(x), kw["w_arr"]
            kfused = kw["condense"] == "k"
            geom = {k: kw[k] for k in ("block_m", "block_n", "slice_k")}
            nb, fl, _ = needed_work(
                torch, a[None], b[None], a.dtype, geom,
                type(sched)(*(t[None] for t in sched)) if kfused
                else sched[None], counts[None], kfused)
            bound[0] += max(nb / HBM_BYTES_PER_S,
                            fl / PEAK_FLOPS["bfloat16"]) * 1e3
        return sched, counts
    # the device's activity alone keeps the trace small; with the host's
    # too where that traces nothing
    for activities in ([ProfilerActivity.CUDA],
                       [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        bound[0] = 0.0
        torch.cuda.synchronize()
        dsp.schedule = hooked
        try:
            with profile(activities=activities) as prof:
                fn()
                torch.cuda.synchronize()
        finally:
            dsp.schedule = orig
        total, k1k2 = 0.0, 0.0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                total += e.device_time_total
                if any(k in e.name for k in K1K2_KERNELS):
                    k1k2 += e.device_time_total
        if total > 0:
            return k1k2 / 1e3, bound[0]
    return None, bound[0]


def mask_on_card_vs_cpu(torch, w, block):
    """``block_mask`` of a served weight on the card and on the CPU: the
    tiles whose keep differs (bf16 tile norms tie often, and the card
    sums a tile in another order than the CPU), the tiles, and the CPU's
    time."""
    from repro_torch.core import pruning
    got = pruning.block_mask(w, PRUNE_SPARSITY, block=block)
    t0 = time.perf_counter()
    want = pruning.block_mask(w.cpu(), PRUNE_SPARSITY, block=block)
    cpu_s = time.perf_counter() - t0
    tiles = got[::block[0], ::block[1]].cpu()
    diff = int((tiles != want[::block[0], ::block[1]]).sum())
    return diff, tiles.numel(), cpu_s


def prune_mlps(torch, model, cfg):
    """Block-prune every layer's (and encoder layer's) mlp.w_up and
    mlp.w_down in place on the card, one weight at a time, so that peak
    memory grows by one weight's temporaries only.  Returns the kept
    share of each weight's tiles."""
    from repro_torch.core import pruning
    block = (cfg.sparse_slice_k, cfg.sparse_block_n)
    kept = []
    layers = list(model.layers) + list(getattr(model, "enc_layers", []))
    with torch.no_grad():
        for layer in layers:
            for w in (layer.mlp.w_up, layer.mlp.w_down):
                m = pruning.block_mask(w, PRUNE_SPARSITY, block=block)
                kept.append(float(m[::block[0], ::block[1]].float().mean()))
                w.mul_(m)
                del m
    torch.cuda.empty_cache()
    return kept


def tape_rows(tape, entries):
    """The tape's entries as (name, dense, counted, executed, tiles
    skipped) rows, in order."""
    return [(e["name"], e["dense_steps"], e["sparse_steps"],
             e["executed_steps"], e["tiles_skipped"])
            for e in tape.summarize(entries)]


def phase_pruned(torch, what, cfg, model, batch, new, expect):
    """One served model on cached weight plans, then block-pruned: for
    dual and dual+kc, the model unpruned with per-call plans and with
    cached plans; then every MLP weight block-pruned in place (layer 0's
    mlp.w_up mask on the card held against the CPU's), dense, and dual and
    dual+kc with per-call and with cached plans.  Each run: tokens/s,
    prefill, decode-step median, launches (exactly ``expect[mode]``),
    steps per site; a second pass times the dispatch's planning; the
    cached runs' K1/K2 device time from a profiled third pass.  Checks:
    executed == counted on every tape entry; each cached run's tape equal
    to the per-call run's on the same weights, site for site; pruned, the
    MLP sites execute fewer steps than dense (mlp.up near half); pruned
    sparse prefill logits within the tolerance of pruned dense, tokens
    parting only where its top-2 logits are within it."""
    from repro_torch.models import transformer as tfm
    from repro_torch.sparse import tape
    counters = kernel_counters()
    b = batch["tokens"].shape[0]
    runs = {}
    t_phase = time.perf_counter()

    def run(weights, mode, cached):
        c = dataclasses.replace(cfg, **MODES[mode])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plans = tfm.plan_weight_activities(model, c) if cached else None
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with tape.collect() as entries:
            r = serve_with_plans(torch, model, c, batch, new, plans)
        wall = (time.perf_counter() - t0) * 1e3
        got = {kn: fn.launches for kn, fn in counters.items()}
        want = {kn: expect[mode].get(kn, 0) for kn in counters}
        key = f"{what} {weights} {mode}" + (", cached plans" if cached
                                            else ", per-call plans")
        if got != want:
            raise AssertionError(f"{key}: launches {got}, expected {want}")
        rows = tape_rows(tape, entries)
        bad = [row for row in rows if mode != "dense" and row[2] != row[3]]
        if bad:
            raise AssertionError(f"{key}: executed != counted at {bad[:3]}")
        if not all(torch.isfinite(s).all() for s in r["steps"]):
            raise AssertionError(f"{key}: non-finite logits")
        t1 = time.perf_counter()
        plan_ms, calls = planning_ms(torch, lambda: serve_with_plans(
            torch, model, c, batch, new, plans))
        t2 = time.perf_counter()
        dev, bound = (k1k2_device_and_bound(torch, lambda: serve_with_plans(
            torch, model, c, batch, new, plans))
            if cached and mode != "dense" else (None, None))
        passes = f"passes {wall / 1e3:.1f} + {t2 - t1:.1f} + " \
                 f"{time.perf_counter() - t2:.1f} s"
        sites = site_steps(tape, entries)
        r.update(rows=rows, sites=sites, wall=wall, plan_ms=plan_ms,
                 calls=calls, dev=dev, bound=bound, build_ms=build_ms)
        runs[(weights, mode, cached)] = r
        t = r["times"]
        log(f"pruned serving: {key}: {b * new / wall * 1e3:.2f} tokens/s "
            f"({wall:.0f} ms, stats tape on), one prefill {t[0]:.1f} ms, "
            f"decode steps median {statistics.median(t[1:]):.1f} ms; "
            f"launches { {k: v for k, v in got.items() if v} }; planning "
            f"{plan_ms:.1f} ms in {calls} dispatches "
            f"({plan_ms / max(calls, 1):.3f} ms each, a second pass)"
            + (f"; plans built once in {build_ms:.1f} ms" if cached else "")
            + (f"; K1/K2 device ms {fmt_ms(dev)} against a bound of "
               f"{bound:.4f} ms (a third pass)" if cached and mode != "dense"
               else "") + f"; {passes}"
            + "; dense/counted/executed steps " + ", ".join(
                f"{k} {v[0]}/{v[1]}/{v[2]}" for k, v in sites.items()))

    sparse = ("dual", "dual+kc")
    for mode in sparse:
        run("unpruned", mode, False)
        run("unpruned", mode, True)
    block = (cfg.sparse_slice_k, cfg.sparse_block_n)
    diff, tiles, cpu_s = mask_on_card_vs_cpu(torch, model.layers[0].mlp.w_up,
                                             block)
    log(f"pruned serving: {what}: layer 0 mlp.w_up "
        f"{tuple(model.layers[0].mlp.w_up.shape)} block_mask{block} on the "
        f"card {'==' if diff == 0 else '!='} the CPU's: {diff} of {tiles} "
        f"tiles differ (CPU mask in {cpu_s:.1f} s)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kept = prune_mlps(torch, model, cfg)
    torch.cuda.synchronize()
    log(f"pruned serving: {what}: {len(kept)} MLP weights block-pruned in "
        f"place at {block}, kept tile share {min(kept):.4f}-{max(kept):.4f},"
        f" in {time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    run("pruned", "dense", False)
    for mode in sparse:
        run("pruned", mode, False)
        run("pruned", mode, True)

    for weights in ("unpruned", "pruned"):
        for mode in sparse:
            per, cached = runs[(weights, mode, False)], runs[
                (weights, mode, True)]
            if per["rows"] != cached["rows"]:
                raise AssertionError(f"{what} {weights} {mode}: the cached "
                                     "plans' tape != the per-call tape")
            same = torch.equal(per["tokens"], cached["tokens"])
            log(f"pruned serving: {what} {weights} {mode}: cached-plan tape "
                f"== per-call tape ({len(per['rows'])} entries); tokens "
                f"{'equal' if same else 'differ'}; planning "
                f"{per['plan_ms']:.1f} -> {cached['plan_ms']:.1f} ms a "
                "generate")
    dense = runs[("pruned", "dense", False)]
    scale = dense["prefill"].abs().max().item()
    tol = SERVE_RTOL * scale
    for mode in sparse:
        r = runs[("pruned", mode, True)]
        for site in ("mlp.up", "mlp.down"):
            d, _, executed = r["sites"][site]
            if not executed < d:
                raise AssertionError(f"{what} pruned {mode}: {site} executes "
                                     f"{executed} of {d} dense steps")
        d, _, up = r["sites"]["mlp.up"]
        if not 0.45 <= up / d <= 0.55:
            raise AssertionError(f"{what} pruned {mode}: mlp.up executes "
                                 f"{up / d:.4f} of its dense steps")
        err = (r["prefill"] - dense["prefill"]).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{what} pruned {mode}: prefill logits "
                                 f"differ from pruned dense by {err:.4f} > "
                                 f"{tol:.4f}")
        agree = parting_report(torch, f"{what} pruned {mode}", r["tokens"],
                               dense["tokens"], dense["steps"], tol)
        log(f"pruned serving: {what} pruned {mode}, cached plans: mlp.up "
            f"executes {up / d:.4f} of dense, mlp.down "
            f"{r['sites']['mlp.down'][2] / r['sites']['mlp.down'][0]:.4f}; "
            f"prefill logits max |diff| to pruned dense {err:.4f} <= "
            f"{tol:.4f} ({SERVE_RTOL} x max|pruned dense| {scale:.2f}); "
            + "; ".join(agree))

    def tps(r):
        return b * new / r["wall"] * 1e3
    for mode in sparse:
        up, uc, pp, pc = (runs[(w, mode, cached)] for w in ("unpruned",
                          "pruned") for cached in (False, True))
        log(f"time: {what} {mode}: tokens/s unpruned {tps(up):.2f} "
            f"per-call / {tps(uc):.2f} cached plans, pruned {tps(pp):.2f} / "
            f"{tps(pc):.2f} (pruned dense {tps(dense):.2f}); planning a "
            f"generate {up['plan_ms']:.1f} / {uc['plan_ms']:.1f} ms "
            f"unpruned, {pp['plan_ms']:.1f} / {pc['plan_ms']:.1f} pruned; "
            f"K1/K2 device ms a generate {fmt_ms(uc['dev'])} unpruned -> "
            f"{fmt_ms(pc['dev'])} pruned (bound {uc['bound']:.4f} -> "
            f"{pc['bound']:.4f})")
    log(f"pruned serving: {what}: {time.perf_counter() - t_phase:.0f} s")
    return runs


# ---------------------------------------------------------------------------
# phase 12: the continuous-batching engine, traffic D
# ---------------------------------------------------------------------------

def traffic_d_prompts(torch, cfg):
    """Traffic D's prompts: one of each length in ``D_PROMPT_LENS``."""
    g = torch.Generator().manual_seed(4)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
            for n in D_PROMPT_LENS]


def serve_traffic_d(torch, eng, prompts):
    """Traffic D through ``eng``: one submission a tick while the earlier
    requests decode, then drain with ``run_to_completion``.  Returns
    ({uid: request}, wall ms, {"prefill": [ms], "decode": [ms]}): each
    core call timed from a synchronize to its own host read of the next
    tokens."""
    from repro_torch.serving.engine import Request
    times = {"prefill": [], "decode": []}

    def timed(fn, acc):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            acc.append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    eng._prefill_impl = timed(eng._prefill_impl, times["prefill"])
    eng._decode_impl = timed(eng._decode_impl, times["decode"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = []
    try:
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=D_NEW))
            done.extend(eng.step())
        done.extend(eng.run_to_completion())
        torch.cuda.synchronize()
    finally:
        del eng._prefill_impl, eng._decode_impl
    return ({r.uid: r for r in done}, (time.perf_counter() - t0) * 1e3,
            times)


def check_engine_run(what, mode, eng, done, launches, evictions_ok):
    """Every request done with its D_NEW tokens, the pool drained (and no
    eviction unless ``evictions_ok``), and the launches exact: K1 (K2)
    once a dispatch of every prefill and decode call, K3 (K4) twice a
    layer and decode call."""
    st = eng.stats()
    short = [u for u, r in done.items()
             if len(r.output) != D_NEW or r.status != "done"]
    if sorted(done) != list(range(len(D_PROMPT_LENS))) or short:
        raise AssertionError(f"{what}: requests {short} missed their budget "
                             f"(finished {sorted(done)})")
    if st["pages_free"] != st["pages_total"]:
        raise AssertionError(f"{what}: pool not drained: {st}")
    if st["evictions"] and not evictions_ok:
        raise AssertionError(f"{what}: {st['evictions']} evictions")
    proj = PROJ_PER_FORWARD * (st["prefill_calls"] + st["decode_calls"])
    grouped = 2 * N_LAYERS * st["decode_calls"]
    want = {"dense": {}, "dual": {"K1": proj, "K3": grouped},
            "dual+kc": {"K2": proj, "K4": grouped}}[mode]
    want = {kn: want.get(kn, 0) for kn in launches}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    return st


def batch1_stream(torch, model, c, prompt, force=None):
    """``generate``'s own prefill and decode steps at batch 1 over a
    D_CAPACITY-slot cache: the greedy tokens (1, D_NEW) on the host and
    each step's logits; with ``force`` each decode is fed ``force``'s
    previous token instead (the logits along another stream)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    caches = tfm.init_caches(c, 1, D_CAPACITY)
    state, lg = serve_loop.make_prefill_step(c)(
        model, {"tokens": torch.tensor([prompt], device="cuda")}, caches)
    steps, toks = [lg[:, -1].float()], [state.last_token[:, 0]]
    decode = serve_loop.make_decode_step(c)
    for t in range(1, D_NEW):
        if force is not None:
            state = state._replace(last_token=torch.tensor(
                [[force[t - 1]]], device="cuda"))
        state, lg1 = decode(model, state)
        steps.append(lg1.float())
        toks.append(state.last_token[:, 0])
    return torch.stack(toks, 1).int().cpu(), steps


def held_to_plain(torch, eng, fn, stage="decode"):
    """``fn()`` with every kernel launch held against its plain walk on
    the same inputs, run right after the launch (before anything can write
    them), at the tolerance of its output type (``RTOL``, as in phases 3
    and 4).  With an engine ``eng``, launches are labelled by its calls:
    its prefill calls of more than one row (packed) are checked, one-row
    prefills run unchecked, the rest are ``stage``; without one, every
    launch is checked and labelled ``stage``.  Launches are seen at
    ``bitmap_spgemm.run``, which all four wrappers call; the plain walk is
    not a launch and is not counted.  Returns {source: dict(n, err,
    shapes, plain_ms)}, ``shapes`` the set of (stage, E, M, least, most
    scheduled steps of a problem), ``plain_ms`` the plain walks' time by
    CUDA events."""
    from repro_torch.kernels import bitmap_spgemm as bsk
    real_run = bsk.run
    label, seen = [stage], {}

    def run(src, plain, a, b, sched, counts, *, block_m, block_n, slice_k,
            out_dtype, **kw):
        geom = dict(block_m=block_m, block_n=block_n, slice_k=slice_k)
        y = real_run(src, plain, a, b, sched, counts, out_dtype=out_dtype,
                     **geom, **kw)
        if label[0] == "prefill 1":
            return y
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p = plain(a, b, sched, counts, out_dtype=out_dtype, **geom)
        end.record()
        end.synchronize()
        (e, m, k), n = a.shape, b.shape[-1]
        err = check_pair(torch, src, y, p, str(y.dtype).split(".")[-1],
                         f"{'engine ' if eng else ''}{label[0]} E={e} "
                         f"M={m} K={k} N={n}")
        steps = counts.reshape(e, -1).sum(1)
        got = seen.setdefault(src, dict(n=0, err=0.0, shapes=set(),
                                        plain_ms=0.0))
        got["n"] += 1
        got["plain_ms"] += start.elapsed_time(end)
        got["err"] = max(got["err"], err)
        got["shapes"].add((label[0], e, m, int(steps.min()),
                           int(steps.max())))
        return y

    bsk.run = run
    if eng is not None:
        real_prefill = eng._prefill_impl

        def prefill(tokens, *args):
            label[0] = f"prefill {tokens.shape[0]}" + (
                f"x{tokens.shape[1]}" if tokens.shape[0] > 1 else "")
            try:
                return real_prefill(tokens, *args)
            finally:
                label[0] = stage
        eng._prefill_impl = prefill
    try:
        fn()
    finally:
        bsk.run = real_run
        if eng is not None:
            del eng._prefill_impl
    return seen


def fill_slots(torch, eng, prompts):
    """Submit the D_SLOTS longest prompts to the idle ``eng`` and run the
    tick that admits them all (their prefills, one packed) and decodes the
    D_SLOTS slots once, the packed prefill's and the decode's launches
    held to their plain walks (:func:`held_to_plain`).  In a sparse mode the tick must have run K1
    (K2) at a packed prefill and at decode M = D_SLOTS, and K3 (K4) at E =
    slots x KV heads with problems scheduled to different depths (one
    schedule per slot).  Returns the held launches by source."""
    from repro_torch.serving.engine import Request
    for i, p in enumerate(prompts[-D_SLOTS:]):
        eng.submit(Request(uid=100 + i, prompt=p, max_new_tokens=D_NEW))
    seen = held_to_plain(torch, eng, eng.step)
    if sum(r is not None for r in eng.active.values()) != D_SLOTS:
        raise AssertionError("engine: not every slot is busy")
    if eng.cfg.sparse_mode == "dense":
        return seen
    shapes = [x for got in seen.values() for x in got["shapes"]]
    e_want = D_SLOTS * eng.cfg.n_kv_heads
    if not (any(st.startswith("prefill ") for st, *_ in shapes)
            and any(st == "decode" and m == D_SLOTS
                    for st, e, m, *_ in shapes if e == 1)
            and any(st == "decode" and e == e_want and lo < hi
                    for st, e, m, lo, hi in shapes)):
        raise AssertionError(f"engine: the admitting tick missed a packed "
                             f"prefill, a {D_SLOTS}-row decode or per-slot "
                             f"grouped schedules: {sorted(shapes)}")
    return seen


def slot_schedule_check(torch, eng):
    """One decode tick of ``eng``, every slot busy at its own length,
    under the stats tape: each ``attn.score`` and ``attn.value`` entry
    must schedule, summed over the slots, exactly the cache blocks each
    slot's query sees, worked out on the host from the slot's position
    and the model's window (score: the key rows' blocks at the score's
    block_m; value: the cache slices at its slice_k, or under kcondense
    the seen slots condensed into slices).  A schedule shared by the slots
    would give every slot the longest one's blocks.  Returns (the slots'
    query positions, {site: host blocks per slot}, {site: scheduled steps
    of each entry})."""
    from repro_torch.sparse import tape
    c = eng.cfg
    t, hd, grp = eng.capacity, c.hd, c.n_heads // c.n_kv_heads
    w = c.sliding_window or None
    qpos = list(eng.pos)            # the positions this tick attends from
    lo = [max(0, q - w + 1) if w else 0 for q in qpos]
    bm = site_geometry(c, "attn.score", t, grp, hd)["block_m"]
    bt = site_geometry(c, "attn.value", grp, hd, t)["slice_k"]

    def touched(size):
        return [-(-(q + 1) // size) - lq // size for q, lq in zip(qpos, lo)]
    want = {"attn.score": touched(bm),
            "attn.value": ([-(-(q + 1 - lq) // bt) for q, lq in zip(qpos, lo)]
                           if c.sparse_kcondense else touched(bt))}
    tiles = {"attn.score": -(-t // bm), "attn.value": -(-t // bt)}
    if len(set(want["attn.score"])) == 1:
        raise AssertionError(f"engine: every slot at one length: {qpos}")
    with tape.collect() as entries:
        eng.step()
    rows = tape.summarize(entries)
    got = {}
    for k, blocks in want.items():
        got[k] = [e["sparse_steps"] for e in rows if e["name"] == k]
        dense = {e["dense_steps"] for e in rows if e["name"] == k}
        if len(got[k]) != N_LAYERS or len(dense) != 1:
            raise AssertionError(f"engine: {len(got[k])} {k} entries")
        per_block, rem = divmod(dense.pop(), D_SLOTS * tiles[k])
        if rem or got[k] != [per_block * sum(blocks)] * N_LAYERS:
            raise AssertionError(
                f"engine: {k} scheduled {got[k]} steps a layer; the slots' "
                f"own blocks {blocks} (positions {qpos}) give "
                f"{per_block} x {sum(blocks)}")
    return qpos, want, got


def tick_split(torch, eng, reps=5):
    """``reps`` decode ticks of ``eng``, every slot busy, each timed whole
    and in parts: the ``paged_read`` gather, the dispatch's planning
    (``dispatch.schedule``), K1/K2 and K3/K4, and the rest; CUDA events,
    with a synchronize before each part and the tick, so the parts do not
    overlap.  The kernels are timed at ``bitmap_spgemm.run``, which all
    four wrappers call (a wrapper looks its own name up to count its
    launches, so it is not replaced).  Then ``eng`` is drained.  Medians
    of the ticks, in ms."""
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.sparse import dispatch as dsp
    from repro_torch.sparse import kvcache as skvc
    parts = {"paged_read": (skvc, "paged_read"),
             "planning": (dsp, "schedule"), "kernels": (bsk, "run")}
    acc = dict.fromkeys(("paged_read", "planning", "K1/K2", "K3/K4"), 0.0)

    def events(fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def timed(fn, part):
        def run(*args, **kwargs):
            out, ms = events(lambda: fn(*args, **kwargs))
            if part == "kernels":    # run(src, ...): K3/K4 are grouped_*.cu
                acc["K3/K4" if args[0].startswith("grouped")
                    else "K1/K2"] += ms
            else:
                acc[part] += ms
            return out
        return run
    saved = [(mod, name, getattr(mod, name))
             for mod, name in parts.values()]
    for part, (mod, name) in parts.items():
        setattr(mod, name, timed(getattr(mod, name), part))
    ticks = []
    try:
        for _ in range(reps):
            for part in acc:
                acc[part] = 0.0
            _, total = events(eng.step)
            ticks.append(dict(acc, total=total,
                              rest=total - sum(acc.values())))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    eng.run_to_completion()
    return {k: statistics.median(t[k] for t in ticks) for k in ticks[0]}


def phase_engine(torch, cfg, model, smi):
    """Traffic D through the paged continuous-batching engine; see the
    module docstring, phase 12.  ``smi`` is the card's name and power
    limit, printed beside every number."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving import serve_loop
    from repro_torch.serving.engine import Engine
    from repro_torch.sparse import tape
    t_phase = time.perf_counter()
    counters = kernel_counters()
    prompts = traffic_d_prompts(torch, cfg)
    n_tok = D_NEW * len(prompts)
    runs = {}

    def run(mode, pages=0):
        c = dataclasses.replace(cfg, **ENGINE_MODES[mode])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = Engine(model, c, serve=ServeConfig(
            slots=D_SLOTS, capacity=D_CAPACITY, pages=pages))
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        with tape.collect() as entries:
            done, wall, times = serve_traffic_d(torch, eng, prompts)
        launches = {kn: fn.launches for kn, fn in counters.items()}
        what = f"engine: {mode}" + (f", {pages}-page pool" if pages else "")
        st = check_engine_run(what, mode, eng, done, launches, bool(pages))
        rows = tape.summarize(entries)
        bad = [e for e in rows if e["executed_steps"] != e["sparse_steps"]]
        if mode != "dense" and bad:
            raise AssertionError(f"{what}: executed != counted at {bad[:3]}")
        attn = {k: [e for e in rows if e["name"] == k]
                for k in ("attn.score", "attn.value")}
        if mode != "dense":
            for k, es in attn.items():
                if len(es) != N_LAYERS * st["decode_calls"]:
                    raise AssertionError(f"{what}: {len(es)} {k} entries")
        share = {k: sum(e["sparse_steps"] for e in es)
                 / max(sum(e["dense_steps"] for e in es), 1)
                 for k, es in attn.items() if es}
        r = dict(eng=eng, done=done, st=st, wall=wall, times=times,
                 launches=launches, share=share, build_ms=build_ms,
                 peak=torch.cuda.max_memory_allocated() / 1e9)
        log(f"{what}: {n_tok / wall * 1e3:.2f} tokens/s (a path smoke with "
            f"no throughput meaning: {wall:.0f} ms for {len(prompts)} "
            f"requests x {D_NEW} tokens, stats tape on), "
            f"{st['ticks']} ticks, {st['prefill_calls']} prefill calls "
            f"(mean {statistics.mean(times['prefill']):.1f} ms a call, "
            f"median {statistics.median(times['prefill']):.1f}), "
            f"{st['decode_calls']} decode calls (tick median "
            f"{statistics.median(times['decode']):.1f} ms), evictions "
            f"{st['evictions']}, pool drained ({st['pages_total']} pages); "
            f"launches { {k: v for k, v in launches.items() if v} }"
            + ("; scheduled share of cache-block steps " + ", ".join(
                f"{k} {v:.4f}" for k, v in share.items()) if share else "")
            + f"; peak memory {r['peak']:.1f} GB; engine built in "
            f"{build_ms:.0f} ms; {smi}")
        return r

    for mode in ENGINE_MODES:
        r = runs[mode] = run(mode)
        eng = r.pop("eng")
        held = fill_slots(torch, eng, prompts)
        if mode != "dense":
            for src, got in held.items():
                log(f"engine: {mode}: {src}: {got['n']} launches (the "
                    f"packed prefill and the {D_SLOTS}-slot decode of the "
                    f"tick admitting the {D_SLOTS} longest requests) held to "
                    f"their plain walk, max |kernel - plain| "
                    f"{got['err']:.3e}; (stage, E, M, least..most steps a "
                    f"problem): " + ", ".join(
                        f"({st}, {e}, {m}, {lo}..{hi})"
                        for st, e, m, lo, hi in sorted(got["shapes"])))
            qpos, want, got = slot_schedule_check(torch, eng)
            log(f"engine: {mode}: the next tick's per-slot schedules: "
                + "; ".join(f"{k} schedules {got[k]} steps a layer = the "
                            f"slots' own blocks {want[k]}"
                            for k in want)
                + f" (query positions {qpos})")
            # one more such tick, its launches replayed: device time and
            # bound of K1/K2 and K3/K4 in a 4-slot decode tick
            launches = record_launches(torch, eng.step)
            for src, ls in sorted(launches.items()):
                t = replayed_numbers(torch, src, ls)
                log(f"engine: {mode}: one {D_SLOTS}-slot decode tick's "
                    f"{src}: {t['n']} launches, {t['ms']:.3f} ms events, "
                    f"device {fmt_ms(t['device_ms'])}, bound "
                    f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
                    f"({t['nbytes'] / 1e6:.2f} MB), plain "
                    f"{t['plain_ms']:.1f} ms, torch.bmm over the same "
                    f"operands (every slot, for K3/K4) {t['library_ms']:.3f}"
                    f" ms (device {fmt_ms(t['library_device_ms'])}); {smi}")
            del launches
        t = tick_split(torch, eng)
        log(f"engine: {mode}: one decode tick, {D_SLOTS} slots busy, "
            f"{t['total']:.2f} ms = paged_read gather {t['paged_read']:.2f} "
            f"+ planning {t['planning']:.2f} + K1/K2 {t['K1/K2']:.2f} + "
            f"K3/K4 {t['K3/K4']:.2f} + the rest {t['rest']:.2f} (CUDA "
            f"events, synchronized around each part; medians of 5 ticks); "
            f"{smi}")
        runs[mode]["split"] = t

    # references: generate at batch 1 for the dense engine, the dense
    # engine's streams (their batch-1 logits) for the sparse ones
    dense_c = dataclasses.replace(cfg, **ENGINE_MODES["dense"])
    ref, gen_toks = {}, {}
    for uid, p in enumerate(prompts):
        gen_toks[uid] = serve_loop.generate(
            model, {"tokens": torch.tensor([p], device="cuda")}, dense_c,
            max_new_tokens=D_NEW, capacity=D_CAPACITY).cpu()
        toks, steps = batch1_stream(torch, model, dense_c, p)
        if not torch.equal(toks, gen_toks[uid]):
            raise AssertionError(f"request {uid}: stepwise != generate")
        ref[uid] = steps
    tol = SERVE_RTOL * max(s[0].abs().max().item() for s in ref.values())

    def parting(mode, base_name, base_toks, base_steps):
        notes = []
        for uid, req in runs[mode]["done"].items():
            got = torch.tensor([req.output], dtype=torch.int32)
            (note,) = parting_report(torch, f"engine {mode} request {uid}",
                                     got, base_toks[uid], base_steps[uid],
                                     tol)
            notes.append(f"request {uid} " + note.split(": ", 1)[1])
        log(f"engine: {mode} tokens against {base_name}: " + "; ".join(notes)
            + f" (parting allowed where the reference's top-2 logits are "
            f"within {tol:.4f} = {SERVE_RTOL} x {tol / SERVE_RTOL:.2f})")
    parting("dense", "generate at batch 1", gen_toks, ref)
    dense_toks = {uid: torch.tensor([r.output], dtype=torch.int32)
                  for uid, r in runs["dense"]["done"].items()}
    dense_steps = {
        uid: ref[uid] if torch.equal(dense_toks[uid], gen_toks[uid])
        else batch1_stream(torch, model, dense_c, prompts[uid],
                           force=runs["dense"]["done"][uid].output)[1]
        for uid in dense_toks}
    for mode in ("dual", "dual+kc"):
        parting(mode, "the dense engine", dense_toks, dense_steps)
    del ref, dense_steps

    # profile_sparsity: executed == counted
    for mode in ("dual", "dual+kc"):
        c = dataclasses.replace(cfg, **ENGINE_MODES[mode])
        eng = Engine(model, c, serve=ServeConfig(slots=D_SLOTS,
                                                 capacity=D_CAPACITY))
        short = min(D_PROMPT_LENS)
        rows = eng.profile_sparsity([p[:short] for p in prompts[:D_SLOTS]],
                                    decode_steps=2)
        del eng
        steps = [e for e in rows if "executed_steps" in e]
        bad = [e for e in steps if e["executed_steps"] != e["sparse_steps"]]
        if bad:
            raise AssertionError(f"engine {mode} profile: executed != "
                                 f"counted at {bad[:3]}")
        for k in ("attn.score", "attn.value"):
            n = sum(e["name"] == k for e in rows)
            if n != 2 * N_LAYERS:
                raise AssertionError(f"engine {mode} profile: {n} {k} "
                                     f"entries")
        occ = [e for e in rows if e["name"].startswith("kvcache.")]
        log(f"engine: {mode}: profile_sparsity over {D_SLOTS} rows of "
            f"{short} tokens + 2 decodes: {len(steps)} dispatch entries, "
            f"executed == counted in each; occupancy "
            + ", ".join(f"{e['name']} {e['written_frac']:.4f}" for e in occ))

    # the pressure run: dual on a pool too small for the longest requests
    r = run("dual", D_PRESSURE_PAGES)
    r.pop("eng")
    if not r["st"]["evictions"]:
        raise AssertionError(f"engine: no eviction on a {D_PRESSURE_PAGES}-"
                             f"page pool")
    same = sum(r["done"][u].output == runs["dual"]["done"][u].output
               for u in r["done"])
    log(f"engine: pressure: dual on a {D_PRESSURE_PAGES}-page pool "
        f"({D_PRESSURE_PAGES * 32} cache slots): evictions "
        f"{r['st']['evictions']}, every budget met, pool drained; {same} of "
        f"{len(prompts)} token streams equal the fully provisioned run's "
        f"(recompute-preemption re-prefills prompt + output, so near-ties "
        f"may part on bf16); {smi}")
    for mode, r in runs.items():
        log(f"time: engine {mode}: {n_tok / r['wall'] * 1e3:.2f} tokens/s "
            f"(path smoke, {n_tok} tokens), "
            f"decode tick median {statistics.median(r['times']['decode']):.1f}"
            f" ms, prefill median "
            f"{statistics.median(r['times']['prefill']):.1f} ms a call; {smi}")
    log(f"engine: {time.perf_counter() - t_phase:.0f} s")
    return runs


# ---------------------------------------------------------------------------
# phase 13: the paper's own evaluation (Fig. 21 / Fig. 22) at its shapes
# ---------------------------------------------------------------------------

# benchmarks/bench_spgemm.py::run: its A x B sparsity grid and size
FIG21_A = (0.0, 0.25, 0.5, 0.75, 0.9, 0.99, 0.999)
FIG21_B = (0.0, 0.5, 0.75, 0.99)
FIG21_N = 1024
# the paper's Fig. 21 SpGEMM for the kernels, bf16, at the blocks of
# core.spgemm.spgemm (block_m, block_n, slice_k; block_k 256)
FIG21_KERNEL_N = 4096
SPGEMM_GEOM = dict(block_m=256, block_n=256, slice_k=128)
# benchmarks/bench_models.py::run_conv's blocks (block_m, block_n, slice_k)
CONV_BLOCKS = (64, 128, 128)
# run_conv's three schedules: (mode, condense)
CONV_MODES = {"dense": ("dense", None), "dual": ("dual", None),
              "dual+kc": ("dual", "k")}
CONV_LAUNCHES = {"dense": {}, "dual": {"K5": 1, "K6": 1, "K1": 1},
                 "dual+kc": {"K5": 1, "K6": 1, "K2": 1}}
# the full-size layers whose K5, K6, K1 and K2 are held to their plain
# versions: the first layer (49284 rows) and the largest (64516)
CONV_HELD = (("vgg16", "conv1_2"), ("mask_rcnn", "res2"))
# The JAX package's step counts on the CPU for the same operands (the
# benches' own code, unedited, numpy generator default_rng(0)), as
# (dense, sparse, tiles skipped).  bench_spgemm.run at n = 1024, per
# (A sparsity, B sparsity): (ohmma_steps, mxu_steps at 256/256/256/128)
FIG21_REF = {
    (0.0, 0.0): ((8388608, 8388608, 0), (128, 128, 0)),
    (0.25, 0.0): ((8388608, 7188480, 0), (128, 128, 0)),
    (0.5, 0.0): ((8388608, 5097728, 0), (128, 128, 0)),
    (0.75, 0.0): ((8388608, 2951360, 96), (128, 128, 0)),
    (0.9, 0.0): ((8388608, 2032704, 35488), (128, 128, 0)),
    (0.99, 0.0): ((8388608, 570048, 763552), (128, 128, 0)),
    (0.999, 0.0): ((8388608, 64064, 1016544), (128, 128, 0)),
    (0.0, 0.5): ((8388608, 6009344, 0), (128, 128, 0)),
    (0.25, 0.5): ((8388608, 5156363, 0), (128, 128, 0)),
    (0.5, 0.5): ((8388608, 3650318, 0), (128, 128, 0)),
    (0.75, 0.5): ((8388608, 2121214, 96), (128, 128, 0)),
    (0.9, 0.5): ((8388608, 1453059, 36896), (128, 128, 0)),
    (0.99, 0.5): ((8388608, 406651, 764896), (128, 128, 0)),
    (0.999, 0.5): ((8388608, 48168, 1014976), (128, 128, 0)),
    (0.0, 0.75): ((8388608, 4196352, 64), (128, 128, 0)),
    (0.25, 0.75): ((8388608, 3600509, 64), (128, 128, 0)),
    (0.5, 0.75): ((8388608, 2543125, 64), (128, 128, 0)),
    (0.75, 0.75): ((8388608, 1480101, 224), (128, 128, 0)),
    (0.9, 0.75): ((8388608, 1016820, 35806), (128, 128, 0)),
    (0.99, 0.75): ((8388608, 291916, 756826), (128, 128, 0)),
    (0.999, 0.75): ((8388608, 32536, 1016064), (128, 128, 0)),
    (0.0, 0.99): ((8388608, 1160448, 758464), (128, 128, 0)),
    (0.25, 0.99): ((8388608, 995491, 758464), (128, 128, 0)),
    (0.5, 0.99): ((8388608, 704539, 758464), (128, 128, 0)),
    (0.75, 0.99): ((8388608, 407501, 758490), (128, 128, 0)),
    (0.9, 0.99): ((8388608, 280463, 769040), (128, 128, 0)),
    (0.99, 0.99): ((8388608, 79652, 968924), (128, 128, 0)),
    (0.999, 0.99): ((8388608, 9080, 1039496), (128, 128, 0)),
}
# bench_models.run per layer: (ohmma_steps, ohmma_steps_single_side)
FIG22_REF = {
    ("vgg16", "conv1_2"): ((14201856, 7082014, 74), (18432, 16352, 0)),
    ("vgg16", "conv2_2"): ((13971456, 4354806, 412), (147456, 80144, 0)),
    ("vgg16", "conv3_3"): ((13565952, 3350444, 2680), (1179648, 604832, 0)),
    ("vgg16", "conv4_3"): ((12976128, 2684974, 17238),
                           (9437184, 4742912, 16)),
    ("vgg16", "conv5_3"): ((2949120, 515957, 1930), (9437184, 4720576, 288)),
    ("resnet18", "layer1-1"): ((847872, 421561, 48), (18432, 13096, 0)),
    ("resnet18", "layer2-1"): ((811008, 251691, 428), (147456, 80896, 0)),
    ("resnet18", "layer3-1"): ((737280, 176470, 0), (1179648, 605568, 0)),
    ("resnet18", "layer4-1"): ((589824, 122221, 49), (9437184, 4742208, 16)),
    ("resnet18", "layer5-4"): ((589824, 115640, 3), (9437184, 4729024, 48)),
    ("mask_rcnn", "res2"): ((18588672, 8538480, 32), (18432, 13128, 0)),
    ("mask_rcnn", "res3"): ((18321408, 5733244, 388), (147456, 80912, 0)),
    ("mask_rcnn", "res4"): ((17842176, 4233581, 3328),
                            (1179648, 604832, 0)),
    ("mask_rcnn", "fpn"): ((17842176, 5379385, 2528), (1179648, 723424, 0)),
    ("bert_base", "attn.qkv"): ((5308416, 2562096, 23028),
                                (5308416, 2562096, 23028)),
    ("bert_base", "attn.out"): ((1769472, 822768, 15492),
                                (1769472, 822768, 15492)),
    ("bert_base", "ffn.in"): ((7077888, 3045600, 123336),
                              (7077888, 3045600, 123336)),
    ("bert_base", "ffn.out"): ((7077888, 3026460, 121812),
                               (7077888, 3051696, 121812)),
    ("rnn", "enc.l0"): ((4512000, 2175968, 20008), (4512000, 2175968, 20008)),
    ("rnn", "enc.l1"): ((4512000, 1584074, 40000), (4512000, 2096000, 40000)),
    ("rnn", "dec.l0"): ((4512000, 1538444, 55872), (4512000, 2032512, 55872)),
    ("rnn", "dec.l3"): ((4512000, 1374079, 109984),
                        (4512000, 1816064, 109984)),
}
# bench_models.run_conv (a fresh default_rng(0)): scheduled steps of
# sparse.conv.conv2d dense / dual / dual+kc at CONV_BLOCKS; every mode's
# dense count is the dense column, no tile is skipped
CONV_REF = {
    ("vgg16", "conv1_2"): (3855, 3855, 1542),
    ("vgg16", "conv2_2"): (1710, 1710, 950),
    ("vgg16", "conv3_3"): (1656, 1656, 644),
    ("vgg16", "conv4_3"): (1584, 1584, 528),
    ("vgg16", "conv5_3"): (432, 432, 108),
    ("resnet18", "layer1-1"): (230, 230, 138),
    ("resnet18", "layer2-1"): (99, 99, 55),
    ("resnet18", "layer3-1"): (108, 108, 42),
    ("resnet18", "layer4-1"): (144, 144, 40),
    ("resnet18", "layer5-4"): (144, 144, 60),
    ("mask_rcnn", "res2"): (5045, 5045, 3027),
    ("mask_rcnn", "res3"): (2241, 2241, 1245),
    ("mask_rcnn", "res4"): (2196, 2196, 732),
    ("mask_rcnn", "fpn"): (2196, 2196, 976),
}


def step_ints(sc):
    """A StepCounts as a tuple of Python ints."""
    return tuple(int(v) for v in sc)


def check_ints(what, got, ref):
    """Raise unless every integer of ``got`` equals the JAX reference's."""
    bad = [(key, got.get(key), want) for key, want in ref.items()
           if got.get(key) != want]
    if bad or set(got) != set(ref):
        raise AssertionError(f"{what}: step counts differ from the JAX "
                             f"package's at {bad[:4]} ({len(bad)} in all)")


def bench_sparse(rng, shape, sparsity):
    """``benchmarks/bench_utils.py::sparse``, drawing from ``rng`` in its
    order: normal float32 values, each zeroed with probability
    ``sparsity``."""
    import numpy as np
    x = rng.normal(size=shape).astype(np.float32)
    x[rng.random(shape) < sparsity] = 0
    return x


def bench_kfiber_sparse(rng, shape, sparsity, axis=-1):
    """``benchmarks/bench_utils.py::kfiber_sparse``, in its order: normal
    float32 values with a random share of whole fibers along ``axis``
    (the input channels) zeroed."""
    import numpy as np
    x = rng.normal(size=shape).astype(np.float32)
    idx = [slice(None)] * len(shape)
    idx[axis] = rng.random(shape[axis]) < sparsity
    x[tuple(idx)] = 0
    return x


def magnitude_pruned(torch, w, sparsity, dev):
    """numpy weights on ``dev``, times their ``core.pruning`` magnitude
    mask at ``sparsity`` (as the benches prune)."""
    from repro_torch.core import pruning
    t = torch.from_numpy(w).to(dev)
    return t * pruning.magnitude_mask(t, sparsity)


def fig21_step_models(torch, dev, grid_a=FIG21_A, grid_b=FIG21_B,
                      n=FIG21_N):
    """``bench_spgemm.run``'s step models on ``dev``: for each B sparsity
    B, then A at each A sparsity, from ``default_rng(0)``; returns
    {(A sparsity, B sparsity): (ohmma_steps, mxu_steps) as ints}."""
    import numpy as np
    from repro_torch.core import stats
    rng = np.random.default_rng(0)
    out = {}
    for sb in grid_b:
        b = torch.from_numpy(bench_sparse(rng, (n, n), sb)).to(dev)
        for sa in grid_a:
            a = torch.from_numpy(bench_sparse(rng, (n, n), sa)).to(dev)
            out[(sa, sb)] = (step_ints(stats.ohmma_steps(a, b)),
                             step_ints(stats.mxu_steps(a, b, 256, 256, 256,
                                                       128)))
    return out


def fig22_layers(conv_only=False):
    """[(model, layer)] of ``configs/paper_models.py`` in ``MODELS`` order
    (the CONV layers alone with ``conv_only``)."""
    from repro_torch.configs import paper_models as pm
    return [(model, layer) for model, ls in pm.MODELS.items()
            for layer in ls
            if not conv_only or isinstance(layer, pm.ConvLayer)]


def fig22_operands(torch, dev, rng, layer):
    """``bench_models.conv_operands`` / ``gemm_operands`` on ``dev``, in
    their draw order: a CONV layer's (weights (F, KKC), lowered map L^T
    (KKC, P)) and a GEMM layer's (activation (M, K), weights (K, N)),
    magnitude-pruned weights."""
    import numpy as np
    from repro_torch.configs import paper_models as pm
    from repro_torch.core import im2col as i2c
    if isinstance(layer, pm.ConvLayer):
        x = bench_sparse(rng, (layer.h, layer.w, layer.cin),
                         layer.a_sparsity)
        w = magnitude_pruned(torch, rng.normal(size=(
            layer.k, layer.k, layer.cin, layer.cout)).astype(np.float32),
            layer.w_sparsity, dev)
        lt = i2c.im2col_outer(torch.from_numpy(x).to(dev), layer.k, layer.k,
                              layer.stride)
        return w.reshape(-1, layer.cout).T, lt
    act = bench_sparse(rng, (layer.m, layer.k), layer.a_sparsity)
    w = magnitude_pruned(torch, rng.normal(size=(layer.k, layer.n)).astype(
        np.float32), layer.w_sparsity, dev)
    return torch.from_numpy(act).to(dev), w


def fig22_step_models(torch, dev, layers):
    """``bench_models.run``'s models on ``dev``, from ``default_rng(0)``:
    ({(model, layer): (ohmma_steps, ohmma_steps_single_side) as ints},
    {(model, layer): a GEMM layer's (activation, weights)})."""
    import numpy as np
    from repro_torch.configs import paper_models as pm
    from repro_torch.core import stats
    rng = np.random.default_rng(0)
    steps, gemms = {}, {}
    for model, layer in layers:
        a, b = fig22_operands(torch, dev, rng, layer)
        gemm = isinstance(layer, pm.GemmLayer)
        single = stats.ohmma_steps_single_side(b if gemm else a.T,
                                               m=a.shape[0])
        steps[(model, layer.name)] = (step_ints(stats.ohmma_steps(a, b)),
                                      step_ints(single))
        if gemm:
            gemms[(model, layer.name)] = (a, b)
    return steps, gemms


def conv_inputs(torch, dev, rng, layer):
    """``bench_models.run_conv``'s operands of one layer, in its draw
    order: x (1, H, W, Cin) with dead input channels, w (k, k, Cin, Cout)
    normal and magnitude-pruned."""
    import numpy as np
    x = bench_kfiber_sparse(rng, (1, layer.h, layer.w, layer.cin),
                            layer.a_sparsity)
    w = rng.normal(size=(layer.k, layer.k, layer.cin, layer.cout)).astype(
        np.float32)
    return (torch.from_numpy(x).to(dev),
            magnitude_pruned(torch, w, layer.w_sparsity, dev))


def conv_modes(torch, x, w, stride, blocks, counters):
    """``run_conv``'s three schedules of one layer through
    ``sparse.conv.conv2d``, the sparse modes on the kernels; each run with
    ``counters`` (kernel wrappers) set to 0 just before it.  Returns
    {mode: (y, StepCounts, tape rows, launches)}."""
    from repro_torch.sparse import conv as spc
    from repro_torch.sparse import tape
    bm, bn, sk = blocks
    out = {}
    for mode, (base, condense) in CONV_MODES.items():
        for fn in counters.values():
            fn.launches = 0
        with tape.collect() as entries:
            y, sc = spc.conv2d(x, w, stride, mode=base, block_m=bm,
                               block_n=bn, slice_k=sk,
                               use_kernel=base != "dense",
                               condense=condense, collect_stats=True)
        out[mode] = (y, sc, tape_rows(tape, entries),
                     {kn: fn.launches for kn, fn in counters.items()})
    return out


def host_ms(torch, fn, reps=3):
    """Median host time of ``fn`` with the card synchronized on both
    sides (planning: host work and small device ops)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# launches of phase 13's main-path runs, by kernel (each run checked exact)
PAPER_LAUNCHES = {}


def expect_launches(what, counters, got, want):
    """Raise unless the launches ``got`` of one main-path run equal
    ``want``; add them to :data:`PAPER_LAUNCHES`."""
    want = {kn: want.get(kn, 0) for kn in counters}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    for kn, n in got.items():
        PAPER_LAUNCHES[kn] = PAPER_LAUNCHES.get(kn, 0) + n


def fig21_kernel_points(torch, n):
    """Fig. 21's operands for the kernels, bf16 on the card, from a seed:
    for each B sparsity of the grid, B, then A at each A sparsity; then
    the block-structured case (A's first half of rows and B's second half
    of columns empty)."""
    g = torch.Generator(device="cuda").manual_seed(21)

    def draw(s):
        x = torch.randn(n, n, device="cuda", generator=g)
        x[torch.rand(n, n, device="cuda", generator=g) < s] = 0
        return x.to(torch.bfloat16)
    for sb in FIG21_B:
        b = draw(sb)
        for sa in FIG21_A:
            yield f"A {sa:.1%} B {sb:.0%}", draw(sa), b
    a, b = draw(0.0), draw(0.0)
    a[: n // 2] = 0
    b[:, n // 2:] = 0
    yield "block-structured", a, b


def fig21_kernels(torch, n=FIG21_KERNEL_N):
    """K1 through ``core.spgemm.spgemm`` and K2 through
    ``bitmap_spgemm_kfused`` at every Fig. 21 point at n x n x n (bf16):
    exactly one launch each, K1's executed steps (its schedule's counts)
    equal to ``mxu_steps``' sparse count, K2's to ``kcondensed_counts``,
    outputs within 2e-2 x max|ref| of ``kernels.ref.spgemm_ref``; at the
    dense and the block-structured points each held to its plain walk.
    Logs planning, device times (the profiler's, and CUDA events around 5
    calls) beside ``torch.matmul``, the bound and K2's skipped share."""
    from repro_torch.core import spgemm as csp
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.kernels import ref
    from repro_torch.sparse import plan as pln
    counters = kernel_counters()
    geom = SPGEMM_GEOM
    bm, bn, sk = geom["block_m"], geom["block_n"], geom["slice_k"]
    steps_dense = -(-n // bm) * -(-n // bn) * -(-n // sk)
    mm_ms = mm_ev = None
    for name, a, b in fig21_kernel_points(torch, n):
        for fn in counters.values():
            fn.launches = 0
        res = csp.spgemm(a, b, block_m=bm, block_n=bn, block_k=256)
        y2 = bsk.bitmap_spgemm_kfused(a, b, **geom)
        torch.cuda.synchronize()
        expect_launches(f"Fig. 21 {name}", counters,
                        {kn: fn.launches for kn, fn in counters.items()},
                        {"K1": 1, "K2": 1})
        ks, counts = bsk.plan_slices(a, b, bm, bn, sk)
        col = pln.element_activity_lhs(a, bm)
        row = pln.element_activity_rhs(b, bn)
        kp = pln.plan_kcondensed(col, row, sk)
        k1_steps, k2_steps = int(counts.sum()), int(kp.counts.sum())
        if k1_steps != int(res.steps.sparse):
            raise AssertionError(f"Fig. 21 {name}: K1 executes {k1_steps} "
                                 f"steps, mxu_steps counts "
                                 f"{int(res.steps.sparse)}")
        if k2_steps != int(pln.kcondensed_counts(col, row, sk).sum()):
            raise AssertionError(f"Fig. 21 {name}: K2's schedule differs "
                                 "from kcondensed_counts")
        r = ref.spgemm_ref(a, b, out_dtype=torch.float32)
        scale = r.abs().max().item()
        errs = [(y.float() - r).abs().max().item() for y in (res.out, y2)]
        if not max(errs) <= 2e-2 * max(scale, 1e-30):
            raise AssertionError(f"Fig. 21 {name}: max |K1, K2 - ref| "
                                 f"{errs} > 2e-2 x {scale:.3e}")
        if name in ("A 0.0% B 0%", "block-structured"):
            p1 = bsk.bitmap_spgemm_planned_plain(a, b, ks, counts, **geom)
            p2 = bsk.bitmap_spgemm_kfused_planned_plain(a, b, kp.gk,
                                                        kp.counts, **geom)
            check_pair(torch, "K1", res.out, p1, "bfloat16", name)
            check_pair(torch, "K2", y2, p2, "bfloat16", name)
            log(f"paper: Fig. 21 {n}^3 {name}: K1 and K2 within 1e-2 of "
                f"their plain walks, which take " + " / ".join(
                    f"{cuda_ms(torch, fn, 1):.2f}" for fn in (
                        lambda: bsk.bitmap_spgemm_planned_plain(
                            a, b, ks, counts, **geom),
                        lambda: bsk.bitmap_spgemm_kfused_planned_plain(
                            a, b, kp.gk, kp.counts, **geom))) + " ms")
        plan1 = host_ms(torch, lambda: bsk.plan_slices(a, b, bm, bn, sk))
        plan2 = host_ms(torch, lambda: pln.plan_kcondensed(
            pln.element_activity_lhs(a, bm), pln.element_activity_rhs(b, bn),
            sk))
        def k1():
            return bsk.bitmap_spgemm_planned(a, b, ks, counts, **geom)

        def k2():
            return bsk.bitmap_spgemm_kfused_planned(a, b, kp.gk, kp.counts,
                                                    **geom)
        t1, t2 = device_ms(torch, k1, reps=5), device_ms(torch, k2, reps=5)
        # and CUDA events around 5 calls back to back: at these
        # millisecond kernels the host's launch hides behind the device
        e1, e2 = (cuda_ms(torch, lambda: [k() for _ in range(5)], 3) / 5
                  for k in (k1, k2))
        if mm_ms is None:
            mm_ms = device_ms(torch, lambda: a @ b, reps=5)
            mm_ev = cuda_ms(torch, lambda: [a @ b for _ in range(5)], 3) / 5
        bounds = []
        for sched, c, kf in ((ks, counts, False), (kp, kp.counts, True)):
            nb, fl, _ = needed_work(
                torch, a[None], b[None], torch.bfloat16, geom,
                type(sched)(*(t[None] for t in sched)) if kf else sched[None],
                c[None], kf)
            bounds.append(max(nb / HBM_BYTES_PER_S,
                              fl / PEAK_FLOPS["bfloat16"]) * 1e3)
        log(f"paper: Fig. 21 {n}^3 {name}: K1 {k1_steps} / K2 {k2_steps} "
            f"of {steps_dense} steps (K2 skips "
            f"{1 - k2_steps / steps_dense:.4f}); device K1 {fmt_ms(t1)} / "
            f"K2 {fmt_ms(t2)} ms, torch.matmul {fmt_ms(mm_ms)}; events "
            f"{e1:.4f} / {e2:.4f} / {mm_ev:.4f} ms; bounds "
            f"{bounds[0]:.4f} / {bounds[1]:.4f} ms; planning {plan1:.2f} / "
            f"{plan2:.2f} ms; max |y - ref| {errs[0]:.3e} / {errs[1]:.3e}")


CONV_KERNELS = {"K5": ("encode_",), "K6": ("feature_runs_kernel",
                                          "im2col_kernel"),
                "K7": ("feature_rows_kernel", "lowered_rows_kernel"),
                "K1/K2": K1K2_KERNELS}


def conv_split(torch, x, w, stride, condense, sk):
    """One dual (``condense=None``) or dual+kc conv in bf16 at
    ``CONV_BLOCKS``, timed: CUDA events around the call, the device time
    by kernel (K5, K6/K7, K1/K2 and the rest: the glue's and planning's
    PyTorch ops), the dispatch's planning (synchronized), the lowering
    glue alone (row-packed → flat bitmap → activation) and ``F.conv2d``
    in bf16; the conv's bound from the bytes of x, w and y and the flops
    of the schedule, and K5's and K6/K7's from the bytes each moves.
    Returns (ms by part, the conv's output)."""
    from repro_torch.core import im2col as i2c
    from repro_torch.core import spconv
    from repro_torch.kernels import bitmap_encode as k5
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparse_im2col as k67
    from repro_torch.sparse import conv as spc
    from repro_torch.sparse import dispatch as dsp
    from repro_torch.sparse import plan as pln
    bm, bn, _ = CONV_BLOCKS
    kh, kw, _, f = w.shape
    ow = i2c.out_size(x.shape[2], kw, stride)

    def call():
        return spc.conv2d(x, w, stride, mode="dual", block_m=bm,
                          block_n=bn, slice_k=sk, use_kernel=True,
                          condense=condense)
    y, _ = call()
    t = dict(total=cuda_ms(torch, call, 3))
    per = device_ms_by_kernel(torch, call, reps=3) or {}
    for part, names in CONV_KERNELS.items():
        t[part] = sum(ms for k, ms in per.items()
                      if any(nm in k for nm in names))
    t["device_rest"] = sum(per.values()) - sum(t[p] for p in CONV_KERNELS)
    t["planning"], _ = planning_ms(torch, call)
    bits, cond = k5.bitmap_encode(x.permute(0, 3, 1, 2))
    if stride == 1:
        lowb, lowv = k67.sparse_im2col(cond, bits, kh=kh, kw=kw)
    else:
        lowb, lowv = k67.sparse_im2col_strided(cond, bits, kh=kh, kw=kw,
                                               stride=stride)

    t["K5 bound"], t["K6 bound"] = (
        nb / HBM_BYTES_PER_S * 1e3
        for nb in conv_kernel_bytes(torch, x, bits, cond, lowb, lowv))

    def glue():
        lb = kops.rowpacked_to_flat(lowb, lowv, ow, lowv.shape[-1])
        a = spc.lowered_to_activation(lb, sk).flatten_leading()
        return a, a.values.contiguous()
    t["glue"] = cuda_ms(torch, glue, 3)
    t["F.conv2d"] = cuda_ms(torch, lambda: spconv.conv2d_ref(x, w, stride),
                            3)
    t["F.conv2d device"] = device_ms(torch, lambda: spconv.conv2d_ref(
        x, w, stride), reps=3)
    act, av = glue()
    w2 = w.reshape(-1, f)
    m, k = av.shape
    bm_, bn_, sk_ = pln.clamp_geometry(m, f, k, bm, bn, sk)
    geom = dict(block_m=bm_, block_n=bn_, slice_k=sk_)
    sched, counts = dsp.schedule(act, w2, mode="dual", condense=condense,
                                 **geom)
    kf = condense == "k"
    _, fl, _ = needed_work(
        torch, av[None], w2[None], x.dtype, geom,
        type(sched)(*(s[None] for s in sched)) if kf else sched[None],
        counts[None], kf)
    nbytes = (x.numel() + w.numel() + m * f) * x.element_size()
    t["bound"] = max(nbytes / HBM_BYTES_PER_S,
                     fl / PEAK_FLOPS["bfloat16"]) * 1e3
    return t, y


def hold_conv_to_plain(torch, x, w, what):
    """K5 and K6 bit-equal to their plain versions on x (``conv_check``),
    then K1 and K2 on the lowered GEMM within ``RTOL`` of x's dtype x
    max|plain|, at ``CONV_BLOCKS``."""
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.kernels import ops as kops
    from repro_torch.sparse import conv as spc
    from repro_torch.sparse import dispatch as dsp
    from repro_torch.sparse import plan as pln
    kh, kw, _, f = w.shape
    dtype = str(x.dtype).removeprefix("torch.")
    res = conv_check(torch, x, kh, kw, 1, what)
    bm, bn, sk = CONV_BLOCKS
    act = spc.lowered_to_activation(kops.sparse_im2col(x, kh, kw, 1),
                                    sk).flatten_leading()
    av, w2 = act.values.contiguous(), w.reshape(-1, f)
    m, k = av.shape
    bm, bn, sk = pln.clamp_geometry(m, f, k, bm, bn, sk)
    geom = dict(block_m=bm, block_n=bn, slice_k=sk)
    errs, plain_ms = [], []
    for kern, plain, condense in (
            (bsk.bitmap_spgemm_planned, bsk.bitmap_spgemm_planned_plain,
             None),
            (bsk.bitmap_spgemm_kfused_planned,
             bsk.bitmap_spgemm_kfused_planned_plain, "k")):
        sched, counts = dsp.schedule(act, w2, mode="dual",
                                     condense=condense, **geom)
        ks = sched.gk if condense else sched
        errs.append(check_pair(
            torch, "K2" if condense else "K1", kern(av, w2, ks, counts,
                                                   **geom),
            plain(av, w2, ks, counts, **geom), dtype, what))
        plain_ms.append(cuda_ms(torch, lambda: plain(av, w2, ks, counts,
                                                     **geom), 1))
    k6_plain = cuda_ms(torch, res["k67_plain"], 1)
    log(f"paper: {what}: K5 and K6 bit-equal to plain (K6's plain "
        f"{k6_plain:.2f} ms); K1 / K2 against their plain walks at {m} x "
        f"{k} @ {k} x {f}, blocks {bm}/{bn}/{sk}: max |kernel - plain| "
        f"{errs[0]:.3e} / {errs[1]:.3e}, the walks {plain_ms[0]:.2f} / "
        f"{plain_ms[1]:.2f} ms ({dtype})")


def fig22_convs(torch, layers, blocks=CONV_BLOCKS):
    """``bench_models.run_conv`` on the card: every layer of ``layers``
    from one ``default_rng(0)`` in its order, dense / dual / dual+kc
    through ``sparse.conv.conv2d`` with the kernels, float32.  Each run's
    launches exact (dual: K5, K6, K1 once; dual+kc: K5, K6, K2 once), its
    tape executing what it counts, its output within 1e-4 x max of
    ``conv2d_ref`` (``F.conv2d``); the kernels of the layers in
    :data:`CONV_HELD` held to their plain versions in float32 and in
    bf16; then each layer in bf16 (the tensor-core route), timed by part
    (:func:`conv_split`), its output within 2e-2 x max of ``conv2d_ref``
    on the same bf16 operands taken to float32.  Then run_conv's own stride-2 check through
    ``core.spconv.conv2d_dual_sparse`` (K5 → K7 → K1), from the same
    generator.  Returns {(model, layer): scheduled steps dense / dual /
    dual+kc}."""
    import numpy as np
    from repro_torch.configs import paper_models as pm
    from repro_torch.core import spconv
    from repro_torch.sparse import tape
    counters = kernel_counters()
    rng = np.random.default_rng(0)
    steps = {}
    for model, layer in layers:
        x, w = conv_inputs(torch, "cuda", rng, layer)
        what = f"{model} {layer.name}"
        runs = conv_modes(torch, x, w, layer.stride, blocks, counters)
        ref = spconv.conv2d_ref(x, w, layer.stride)
        scale = ref.abs().max().item()
        errs = {}
        for mode, (y, sc, rows, launches) in runs.items():
            expect_launches(f"{what} {mode}", counters, launches,
                            CONV_LAUNCHES[mode])
            if any(r[2] != r[3] for r in rows):
                raise AssertionError(f"{what} {mode}: executed != counted: "
                                     f"{rows}")
            errs[mode] = (y - ref).abs().max().item()
            if not errs[mode] <= 1e-4 * scale:
                raise AssertionError(f"{what} {mode}: max |y - F.conv2d| "
                                     f"{errs[mode]:.3e} > 1e-4 x {scale:.3e}")
        steps[(model, layer.name)] = tuple(int(runs[m][1].sparse)
                                           for m in CONV_MODES)
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        if (model, layer.name) in CONV_HELD:
            hold_conv_to_plain(torch, x, w, what)
            hold_conv_to_plain(torch, xb, wb, what)
        refb = spconv.conv2d_ref(xb.float(), wb.float(), layer.stride)
        scaleb = refb.abs().max().item()
        # K6's yardstick on this path: F.unfold's dense im2col of the same
        # bf16 map (NCHW), the profiler's device time
        xn = xb.permute(0, 3, 1, 2).contiguous()
        unfold_ms = device_ms(torch, lambda: torch.nn.functional.unfold(
            xn, (w.shape[0], w.shape[1]), stride=layer.stride), reps=3)
        for mode in ("dual", "dual+kc"):
            t, yb = conv_split(torch, xb, wb, layer.stride,
                               CONV_MODES[mode][1], blocks[2])
            errb = (yb.float() - refb).abs().max().item()
            if not errb <= 2e-2 * scaleb:
                raise AssertionError(f"{what} {mode} bf16: max |y - F.conv2d|"
                                     f" {errb:.3e} > 2e-2 x {scaleb:.3e}")
            kn = "K2" if mode == "dual+kc" else "K1"
            log(f"paper: Fig. 22 conv {what} {mode}: steps "
                f"{steps[(model, layer.name)]} (dense/dual/dual+kc), float32 "
                f"max |y - F.conv2d| {errs[mode]:.2e}; bf16 "
                f"max |y - F.conv2d| {errb:.2e} ({errb / scaleb:.1e} of "
                f"max), {t['total']:.3f} ms "
                f"(events) = device K5 "
                f"{fmt_ms(t['K5'])} (bound {t['K5 bound']:.4f}) + K6 "
                f"{fmt_ms(t['K6'])} (bound {t['K6 bound']:.4f}) + {kn} "
                f"{fmt_ms(t['K1/K2'])} + other ops {fmt_ms(t['device_rest'])}"
                f"; planning {t['planning']:.3f}, lowering glue "
                f"{t['glue']:.3f} (events); F.unfold bf16 device "
                f"{fmt_ms(unfold_ms)}; F.conv2d bf16 "
                f"{t['F.conv2d']:.3f} (device {fmt_ms(t['F.conv2d device'])})"
                f"; bound {t['bound']:.4f} ms")
    # run_conv's kernel check: stride 2, so K7
    layer = pm.RESNET18[3]._replace(h=10, w=10, cin=8, cout=16, stride=2)
    x = torch.from_numpy(bench_sparse(rng, (2, layer.h, layer.w, layer.cin),
                                      layer.a_sparsity)).cuda()
    w = magnitude_pruned(torch, rng.normal(size=(
        layer.k, layer.k, layer.cin, layer.cout)).astype(np.float32),
        layer.w_sparsity, "cuda")
    for fn in counters.values():
        fn.launches = 0
    with tape.collect() as entries:
        res = spconv.conv2d_dual_sparse(x, w, layer.stride, block_m=16,
                                        block_n=16, block_k=16,
                                        use_kernel=True)
    expect_launches("stride-2 check", counters,
                    {kn: fn.launches for kn, fn in counters.items()},
                    {"K5": 1, "K7": 1, "K1": 1})
    [row] = tape_rows(tape, entries)
    err = (res.out - spconv.conv2d_ref(x, w, layer.stride)).abs().max().item()
    if row[2] != row[3] or not err <= 1e-4:
        raise AssertionError(f"stride-2 check: executed {row[3]} vs counted "
                             f"{row[2]}, max |y - conv2d_ref| {err:.3e}")
    # K7 at this launch's input, timed alone: held bit-equal to its plain
    # version again (conv_check), its device time and CUDA events beside
    # its byte bound and F.unfold's device time
    k7 = conv_check(torch, x, layer.k, layer.k, layer.stride,
                    "stride-2 check")
    log(f"paper: run_conv's stride-2 check through conv2d_dual_sparse "
        f"(2 x 10 x 10 x 8 -> 16, K5 -> K7 -> K1): executed == counted "
        f"{row[3]} of {row[1]}, max |y - conv2d_ref| {err:.2e}; K7 there "
        f"(float32, route {k7['routes'][1]}): device "
        f"{fmt_ms(device_ms(torch, k7['k67']))} (events "
        f"{cuda_ms(torch, k7['k67'], 20):.4f}), bound "
        f"{k7['k67_bytes'] / HBM_BYTES_PER_S * 1e3:.6f} ms by bytes, plain "
        f"{cuda_ms(torch, k7['k67_plain'], 3):.3f}, F.unfold device "
        f"{fmt_ms(device_ms(torch, k7['unfold']))}")
    return steps


def fig22_gemms(torch, gemms):
    """The Fig. 22 GEMM layers (BERT-base, RNN) through ``core.layers``:
    the masked weights cached with ``plan_sparse_linear``, dense, weight
    and dual (K1) in float32, agreeing within 1e-4 x max|dense|; dual
    launches K1 once and executes what it counts.  Logs each mode's time
    (CUDA events) beside ``torch.matmul``."""
    from repro_torch.core import layers as cl
    from repro_torch.sparse import tape
    counters = kernel_counters()
    for (model, name), (act, w) in gemms.items():
        ys, line = {}, []
        for mode in ("dense", "weight", "dual"):
            cfg = cl.SparseLinearConfig(
                in_features=w.shape[0], out_features=w.shape[1], mode=mode,
                use_kernel=mode == "dual", collect_stats=True)
            params = cl.plan_sparse_linear({"w": w, "mask": w != 0}, cfg)
            for fn in counters.values():
                fn.launches = 0
            with tape.collect() as entries:
                ys[mode], sc = cl.apply_sparse_linear(params, act, cfg)
            expect_launches(f"{model} {name} {mode}", counters,
                            {kn: fn.launches for kn, fn in counters.items()},
                            {"K1": 1} if mode == "dual" else {})
            [row] = tape_rows(tape, entries)
            if mode == "dual" and row[2] != row[3]:
                raise AssertionError(f"{model} {name}: executed != counted "
                                     f"{row}")
            ms = cuda_ms(torch, lambda: cl.apply_sparse_linear(params, act,
                                                               cfg), 5)
            line.append(f"{mode} {row[2]}/{row[1]} steps {ms:.3f} ms")
        scale = ys["dense"].abs().max().item()
        errs = [(ys[m] - ys["dense"]).abs().max().item()
                for m in ("weight", "dual")]
        if not max(errs) <= 1e-4 * scale:
            raise AssertionError(f"{model} {name}: weight / dual against "
                                 f"dense {errs} > 1e-4 x {scale:.3e}")
        mm = cuda_ms(torch, lambda: act @ w, 5)
        log(f"paper: Fig. 22 {model} {name} ({act.shape[0]} x {w.shape[0]} "
            f"@ {w.shape[0]} x {w.shape[1]}, float32) through core.layers: "
            + ", ".join(line) + f"; torch.matmul {mm:.3f} ms; max |y - "
            f"dense| {errs[0]:.2e} / {errs[1]:.2e}")


def phase_paper(torch):
    """Phase 13: the paper's evaluation at its published shapes (see the
    module docstring)."""
    t0 = time.perf_counter()
    got = fig21_step_models(torch, "cuda")
    check_ints("Fig. 21 step models", got, FIG21_REF)
    for sb in FIG21_B:
        log(f"paper: Fig. 21 models at B {sb:.0%}, A "
            + ", ".join(f"{sa:.1%}: OHMMA {oh[0] / max(oh[1], 1):.2f}x, "
                        f"block-skip {mx[0] / max(mx[1], 1):.2f}x"
                        for (sa, b_), (oh, mx) in got.items() if b_ == sb)
            + " (step counts equal to the JAX package's)")
    t1 = time.perf_counter()
    fig21_kernels(torch)
    t2 = time.perf_counter()
    steps, gemms = fig22_step_models(torch, "cuda", fig22_layers())
    check_ints("Fig. 22 step models", steps, FIG22_REF)
    means = {}
    for (model, name), (dual, single) in steps.items():
        means.setdefault(model, []).append((dual[0] / max(dual[1], 1),
                                            single[0] / max(single[1], 1)))
    for model, sp in means.items():
        log(f"paper: Fig. 22 {model}: dual / single "
            + ", ".join(f"{d:.2f}/{s:.2f}" for d, s in sp)
            + f"; mean {statistics.mean(d for d, _ in sp):.2f} / "
            f"{statistics.mean(s for _, s in sp):.2f} (step counts equal to "
            "the JAX package's)")
    t3 = time.perf_counter()
    conv_steps = fig22_convs(torch, fig22_layers(conv_only=True))
    check_ints("Fig. 22 conv schedules", conv_steps, CONV_REF)
    t4 = time.perf_counter()
    fig22_gemms(torch, gemms)
    del gemms
    torch.cuda.empty_cache()
    t5 = time.perf_counter()
    log("paper: launches on the phase's main-path runs: " + ", ".join(
        f"{kn} {n}" for kn, n in sorted(PAPER_LAUNCHES.items())))
    log(f"paper: phase {t5 - t0:.1f} s (Fig. 21 models {t1 - t0:.1f}, "
        f"kernels {t2 - t1:.1f}; Fig. 22 models {t3 - t2:.1f}, convs "
        f"{t4 - t3:.1f}, GEMM layers {t5 - t4:.1f})")


# ---------------------------------------------------------------------------
# phase 14: MoE serving, traffic E
# ---------------------------------------------------------------------------

# the MoE families and their full-width cuts: mixtral-8x7b (8 experts,
# top-2) serves traffic E in dense, dual and dual+kc through generate and
# on cached plans; qwen3-moe-235b-a22b (128 experts, top-8) in dense and
# dual on cached plans
MIXTRAL, QWEN3_MOE = "mixtral-8x7b", "qwen3-moe-235b-a22b"
MOE_LAYERS = 2
# the smoke reference: 12 prompt tokens and 8 new pass mixtral-smoke's
# 16-token sliding window
MOE_SMOKE_PROMPT, MOE_SMOKE_NEW = 12, 8
# a routing flip between two runs (a token whose set of picked experts
# differs) is put down to a near-tie when its k-th and (k+1)-th gates lie
# within GATE_MARGIN of each other in one of the runs: the two runs feed
# the router hidden states that differ by bf16 roundings (K1 against
# torch.matmul in attention), which move a gate by about 1e-3 of its
# value at most
GATE_MARGIN = 1e-2
MOE_SOURCES = {"K1": "bitmap_spgemm.cu", "K2": "bitmap_spgemm_kfused.cu",
               "K3": "grouped_spgemm.cu", "K4": "grouped_spgemm_kfused.cu"}


# the kernels a sparse-KV generate's launches are held and replayed for,
# by mode: (name, source)
HELD_KERNELS = {"dual+kv": (("K1", "bitmap_spgemm.cu"),
                            ("K3", "grouped_spgemm.cu")),
                "dual+kc+kv": (("K2", "bitmap_spgemm_kfused.cu"),
                               ("K4", "grouped_spgemm_kfused.cu"))}


def stack_launches(cfg):
    """(K1 or K2 launches a forward, K3 or K4 launches a forward, K3 or K4
    launches of a decode's attention) of a decoder stack: q/k/v/o at each
    attention layer, the projections of each dense MLP and the head; those
    of each MoE layer's experts; score and value at each attention layer.
    A Mamba block dispatches nothing (plain matmuls, as in the JAX
    package)."""
    ffn = 3 if cfg.mlp_type == "swiglu" else 2
    k1, k3, kv = 1, 0, 0
    for i in range(cfg.n_layers):
        pos = i % cfg.period
        attn = cfg.layer_kind(pos) == "attn"
        k1 += 4 * attn
        kv += 2 * attn
        if not attn and cfg.family == "ssm":
            continue
        if cfg.layer_is_moe(pos):
            k3 += ffn
        else:
            k1 += ffn
    return k1, k3, kv


def check_launches(what, counters, want):
    """Each kernel's count against ``want`` (0 where it names none);
    returns the counts that are not 0."""
    got = {kn: fn.launches for kn, fn in counters.items()}
    want = {kn: want.get(kn, 0) for kn in counters}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    return {k: v for k, v in got.items() if v}


def reset_launches(counters):
    for fn in counters.values():
        fn.launches = 0


def seed_biases(torch, model, g):
    """Random qkv biases from ``g`` (std 0.5) in every self-attention that
    has them: ``init_model`` starts them at zero, as the JAX package does,
    which would leave their path unexercised."""
    with torch.no_grad():
        for layer in model.layers:
            if getattr(layer, "attn", None) is not None and layer.attn.bias:
                for b in (layer.attn.bq, layer.attn.bk, layer.attn.bv):
                    b.copy_(0.5 * torch.randn(b.shape, generator=g,
                                              device=g.device))


def phase_reference_smoke(torch, archs, prompt_len, new, int8_kv=False,
                          depth=None):
    """The smoke models of ``archs`` in float32 (random qkv biases where
    they have them): the card (K1/K2 in every projection, K3/K4 over MoE
    experts and in the sparse-KV decode, ``torch.matmul`` / ``torch.bmm``
    in dense mode) against the CPU plain path, same weights and ``2 x
    prompt_len`` tokens: logits within 1e-4 x max, the auxiliary loss
    within 1e-5 and ``new`` greedy tokens equal in dense, dual and
    dual+kc; with ``int8_kv``, dual+kv on int8 caches (``rc.kv_quant``, a
    48-slot context in 8-slot blocks), 7 tokens equal.  ``depth`` maps an
    arch to the layers its smoke model is cut to.  A VLM's prompts come
    with an image each (:func:`memory_inputs`), its gates drawn non-zero
    (:func:`seed_gates`)."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    rc = RunConfig(act_dtype="float32")
    for arch in archs:
        cfg = smoke_config(arch)
        if depth and arch in depth:
            cfg = dataclasses.replace(cfg, n_layers=depth[arch])
        cpu = tfm.init_model(cfg, torch.Generator().manual_seed(0),
                             device="cpu", dtype=torch.float32)
        seed_biases(torch, cpu, torch.Generator().manual_seed(4))
        seed_gates(torch, cpu, torch.Generator().manual_seed(5))
        gpu = copy.deepcopy(cpu).to("cuda")
        tokens = torch.randint(0, cfg.vocab_size, (2, prompt_len),
                               generator=torch.Generator().manual_seed(1))
        batch = {"tokens": tokens, **memory_inputs(
            torch, cfg, 2, torch.Generator().manual_seed(2))}
        gbatch = {k: v.cuda() for k, v in batch.items()}
        errs = []
        for mode, knobs in MODES.items():
            c = dataclasses.replace(cfg, **knobs)
            want = cpu(batch, c, rc=rc)
            got = gpu(gbatch, c, rc=rc)
            err = (got.logits.cpu() - want.logits).abs().max().item()
            if not err <= 1e-4 * want.logits.abs().max().item():
                raise AssertionError(f"{arch}-smoke {mode}: card vs CPU "
                                     f"logits {err}")
            aux_err = abs(got.aux_loss.item() - want.aux_loss.item())
            if not aux_err <= 1e-5:
                raise AssertionError(f"{arch}-smoke {mode}: card vs CPU "
                                     f"aux loss {aux_err}")
            errs.append(f"{mode} {err:.2e}" + (f" (aux loss {aux_err:.1e})"
                                               if cfg.n_experts else ""))
            tc = serve_loop.generate(cpu, batch, c, max_new_tokens=new,
                                     rc=rc, device="cpu")
            tg = serve_loop.generate(gpu, batch, c, max_new_tokens=new,
                                     rc=rc)
            if not torch.equal(tc, tg.cpu()):
                raise AssertionError(f"{arch}-smoke {mode}: tokens differ")
        if int8_kv:
            c = dataclasses.replace(cfg, sparse_block_t=8,
                                    **KV_MODES["dual+kv"])
            rc8 = dataclasses.replace(rc, kv_quant=True)
            tc = serve_loop.generate(cpu, batch, c, max_new_tokens=7,
                                     capacity=48, rc=rc8, device="cpu")
            tg = serve_loop.generate(gpu, batch, c, max_new_tokens=7,
                                     capacity=48, rc=rc8)
            if not torch.equal(tc, tg.cpu()):
                raise AssertionError(f"{arch}-smoke dual+kv int8: tokens "
                                     "differ")
        log(f"reference: {arch}-smoke ({cfg.n_layers} layers, "
            f"{cfg.family}, G = {cfg.n_heads // cfg.n_kv_heads}"
            f", qkv bias {cfg.qkv_bias}, rope {cfg.rope_style}) on the card "
            f"== CPU plain path: logits max err " + ", ".join(errs)
            + f"; {new} greedy tokens equal in each, "
            f"{prompt_len + new} positions"
            + (f" past the {cfg.sliding_window}-token window"
               if cfg.sliding_window else "")
            + ("; dual+kv on int8 caches, 7 tokens equal" if int8_kv
               else ""))


def record_launches(torch, fn):
    """``fn()`` with every K1-K4 launch's inputs kept, the kernels still
    running: {source: [(plain, a, b, sched, counts, kfused, out_dtype,
    geom, kplan), ...]} in launch order, ``kplan`` the K2/K4 launch's
    :class:`~repro_torch.sparse.plan.KPlan` (its ``nnz`` is the bound's
    input) as the dispatch planned it.  Seen at ``bitmap_spgemm.run``,
    which all four wrappers call, and ``dispatch.schedule``."""
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.sparse import dispatch as dsp
    real_run, real_schedule = bsk.run, dsp.schedule
    seen, kplans = {}, {}

    def schedule(*args, **kwargs):
        sched, counts = real_schedule(*args, **kwargs)
        if hasattr(sched, "nnz"):
            kplans[sched.gk.data_ptr()] = sched
        return sched, counts

    def run(src, plain, a, b, sched, counts, *, kfused, out_dtype, **kw):
        geom = {k: kw[k] for k in ("block_m", "block_n", "slice_k")}
        kp = kplans.pop(sched.data_ptr()) if kfused else None
        seen.setdefault(src, []).append(
            (plain, a, b, sched, counts, kfused, out_dtype, geom, kp))
        return real_run(src, plain, a, b, sched, counts, kfused=kfused,
                        out_dtype=out_dtype, **kw)
    bsk.run, dsp.schedule = run, schedule
    try:
        fn()
    finally:
        bsk.run, dsp.schedule = real_run, real_schedule
    return seen


def replayed_numbers(torch, src, launches, plain=True):
    """One generate's launches of the kernel in ``csrc/<src>`` replayed on
    the inputs they had: CUDA events and the profiler's device time of
    all of them, their plain walks, the PyTorch yardstick over the same
    operands (``torch.bmm`` over every problem: every expert, for K3/K4)
    and the bound (:func:`needed_work` on each launch's schedule, a K2/K4
    launch's on its ``KPlan``).  Times in ms, for the whole generate;
    ``shapes`` counts the launches by (E, M, K, N, route, splits),
    ``sched_mb`` is the schedules' size.  ``plain=False`` leaves the plain
    walks out (``plain_ms`` None)."""
    from repro_torch.kernels import bitmap_spgemm as bsk
    nbytes = flops = b_bytes = sched_bytes = op_s = 0.0
    shapes, lib_ops = {}, []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for _, a, b, sched, counts, kfused, out_dtype, geom, kp in launches:
        dims = bsk.check_problem(a, b, sched, counts, kfused=kfused, **geom)
        kind = bsk.route(src, a.dtype, b.dtype, dims[2], dims[3])
        key = (dims[0], dims[1], dims[3], dims[2], kind, bsk.route_splits(
            kind, dims, geom["block_m"], geom["block_n"], sms))
        shapes[key] = shapes.get(key, 0) + 1
        sched_bytes += sched.numel() * sched.element_size()
        odt = out_dtype or torch.promote_types(a.dtype, b.dtype)
        if kfused:          # K2 launches the plan's gk with a problem axis
            lead = tuple(sched.shape[:sched.ndim - kp.gk.ndim])
            kp = type(kp)(*(t.reshape(lead + tuple(t.shape)) for t in kp))
        nb, fl, bb = needed_work(torch, a, b, odt, geom,
                                 kp if kfused else sched, counts, kfused)
        nbytes, flops, b_bytes = nbytes + nb, flops + fl, b_bytes + bb
        # each product's operations at its own type's peak
        op_s += fl / PEAK_FLOPS["bfloat16" if a.dtype == b.dtype ==
                                torch.bfloat16 else "float32"]
        # torch.bmm takes one type: a float32 copy of a bf16 B (the decode
        # value's V), made here, which the kernel does not need
        lib_ops.append((a, b if b.dtype == a.dtype else b.to(a.dtype)))

    def kernels():
        for plain, a, b, sched, counts, kfused, odt, geom, _ in launches:
            bsk.run(src, plain, a, b, sched, counts, kfused=kfused,
                    out_dtype=odt, device=None, **geom)

    def plains():
        for plain, a, b, sched, counts, kfused, odt, geom, _ in launches:
            plain(a, b, sched, counts, out_dtype=odt, **geom)

    def library():
        for a, b in lib_ops:
            torch.bmm(a, b)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, op_s
    return dict(n=len(launches), shapes=shapes, sched_mb=sched_bytes / 1e6,
                ms=cuda_ms(torch, kernels, 3),
                device_ms=device_ms(torch, kernels, 3),
                plain_ms=cuda_ms(torch, plains, 1) if plain else None,
                library_ms=cuda_ms(torch, library, 3),
                library_device_ms=device_ms(torch, library, 3),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                nbytes=nbytes, b_bytes=b_bytes, flops=flops)


def record_routing(fn):
    """``fn()`` with every MoE layer call's gates and picks kept on the
    host, in call order: [(gates (T, E) float32, top_i (T, k))].  Seen at
    ``models.moe._dispatch_local``, which ``moe_forward`` looks up at each
    call."""
    from repro_torch.models import moe as moem
    real, calls = moem._dispatch_local, []

    def dispatch(xt, gates, e, k, cap):
        out = real(xt, gates, e, k, cap)
        calls.append((gates.cpu(), out[5].cpu()))
        return out
    moem._dispatch_local = dispatch
    try:
        out = fn()
    finally:
        moem._dispatch_local = real
    return out, calls


def routing_flips(torch, cfg, b, s, base, other, parted):
    """Compare two runs' routings, call by call (one a MoE layer and
    forward, the prefill's B x S tokens first, then B a decode), token by
    token: the set of picked experts.  A row's decode calls are compared
    while its inputs are equal (forward f reads the token of forward f-1:
    up to ``parted[row]``, the first step where the rows' tokens differ).
    A flip that no earlier flip of its row reaches (an earlier forward's,
    through the caches; an earlier layer's at a position at or before it,
    through attention) must be a near-tie: its k-th and (k+1)-th gates
    within :data:`GATE_MARGIN` in one of the runs.  Returns (flips, {row:
    first forward with a flip}, {(row, pos): prefill tokens that flipped
    in some layer}); each flip a (forward, layer, row, pos, gap in base,
    gap in other, reached) tuple."""
    k = cfg.n_experts_active
    # MoE calls a forward: every layer of a MoE family, every other
    # layer of a hybrid
    n_layers = sum(cfg.layer_is_moe(i % cfg.period)
                   for i in range(cfg.n_layers))
    flips, first, prefill_flipped = [], {}, set()

    def gap(g, t):
        top = torch.topk(g[t], k + 1).values
        return float(top[k - 1] - top[k])
    for i, ((gb, ib), (go, io)) in enumerate(zip(base, other)):
        fwd, layer = divmod(i, n_layers)
        for t in range(ib.shape[0]):
            row, pos = (divmod(t, s) if fwd == 0 else (t, s + fwd - 1))
            if fwd > parted[row]:
                continue
            if set(ib[t].tolist()) == set(io[t].tolist()):
                continue
            reached = any(f[2] == row and (f[0] < fwd or (
                f[1] < layer and f[3] <= pos)) for f in flips)
            g_b, g_o = gap(gb, t), gap(go, t)
            if not reached and not min(g_b, g_o) <= GATE_MARGIN:
                raise AssertionError(
                    f"{cfg.name}: forward {fwd} layer {layer} row {row} "
                    f"position {pos} changes experts {sorted(ib[t].tolist())}"
                    f" -> {sorted(io[t].tolist())} with k-th/(k+1)-th gate "
                    f"gaps {g_b:.2e} / {g_o:.2e} > {GATE_MARGIN}")
            flips.append((fwd, layer, row, pos, g_b, g_o, reached))
            first.setdefault(row, fwd)
            if fwd == 0:
                prefill_flipped.add((row, pos))
    return flips, first, prefill_flipped


def moe_parting(torch, what, toks, base_toks, base_steps, tol, first_flip):
    """Greedy tokens may part from the baseline only where the baseline's
    top-2 logits are within ``tol``, or at or after a step whose routing
    flipped in that row (``first_flip[row]``, a forward index: forward f
    makes token f)."""
    agree = []
    for r in range(toks.shape[0]):
        diff = (toks[r] != base_toks[r]).nonzero()
        if len(diff) == 0:
            agree.append(f"row {r}: all {toks.shape[1]} equal")
            continue
        t = int(diff[0])
        top2 = torch.topk(base_steps[t][r], 2).values
        gap = float(top2[0] - top2[1])
        flip = first_flip.get(r)
        if not (gap <= tol or (flip is not None and flip <= t)):
            raise AssertionError(
                f"{what}: row {r} parts from the baseline at step {t} where "
                f"its top-2 gap {gap:.3f} > {tol:.3f} and no routing flip "
                "came before")
        agree.append(f"row {r}: parts at step {t} (baseline top-2 gap "
                     f"{gap:.3f}" + (f", routing flipped at forward {flip}"
                                     if flip is not None else "") + ")")
    return agree


def parted_at(toks, base_toks):
    """{row: first step where the rows' tokens differ, or their length}."""
    out = {}
    for r in range(toks.shape[0]):
        diff = (toks[r] != base_toks[r]).nonzero()
        out[r] = int(diff[0]) if len(diff) else toks.shape[1]
    return out


def moe_steps(tape, entries, per_forward):
    """moe.* (dense, executed) steps of the prefill and of the decode
    steps, from one run's tape (``per_forward`` entries a forward)."""
    out = {}
    for part, chunk in (("prefill", entries[:per_forward]),
                        ("decode", entries[per_forward:])):
        sites = site_steps(tape, chunk)
        moe = [v for name, v in sites.items() if name.startswith("moe.")]
        out[part] = (sum(v[0] for v in moe), sum(v[2] for v in moe),
                     {name: (v[0], v[2]) for name, v in sites.items()
                      if name.startswith("moe.")})
    return out


def hold_one_step(torch, model, c, batch, plans):
    """One prefill and one decode forward on cached ``plans``, every kernel
    launch held to its plain walk (:func:`held_to_plain`).  Returns
    {stage: {source: dict(n, err, shapes)}}."""
    from repro_torch.models import transformer as tfm
    b, s = batch["tokens"].shape
    caches = tfm.init_caches(c, b, s + 2)
    out = {}

    def prefill():
        out["p"] = model(batch, c, caches=caches,
                         positions=torch.arange(s, device="cuda"),
                         weight_plans=plans)
    held = {"prefill": held_to_plain(torch, None, prefill, "prefill")}
    nxt = out["p"].logits[:, -1:].argmax(-1)

    def decode():
        model({"tokens": nxt}, c, caches=out["p"].caches,
              positions=torch.tensor([s], device="cuda"), weight_plans=plans)
    held["decode"] = held_to_plain(torch, None, decode, "decode")
    return held


def serve_moe(torch, cfg, model, modes, smi, with_generate):
    """Traffic E on one MoE model: each mode through ``generate`` (per-call
    plans, when ``with_generate``) and through :func:`serve_with_plans` on
    cached plans, then the checks and numbers of phase 14.  Returns
    {mode: {K-name: replayed numbers}} of the cached runs' kernels."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    from repro_torch.sparse import tape
    counters = kernel_counters()
    batch = traffic_a_batch(torch, cfg)
    b, s = batch["tokens"].shape
    k1f, k3f, _ = stack_launches(cfg)
    per_forward = k1f + k3f
    n1, n3 = k1f * NEW_TOKENS, k3f * NEW_TOKENS
    runs, kernel_numbers = {}, {}

    def check_run(key, mode, entries):
        got = {kn: fn.launches for kn, fn in counters.items()}
        want = dict.fromkeys(counters, 0)
        if mode == "dual":
            want.update(K1=n1, K3=n3)
        elif mode == "dual+kc":
            want.update(K2=n1, K4=n3)
        if got != want:
            raise AssertionError(f"{key}: launches {got}, expected {want}")
        rows = tape_rows(tape, entries)
        bad = [row for row in rows if mode != "dense" and row[2] != row[3]]
        if bad:
            raise AssertionError(f"{key}: executed != counted at {bad[:3]}")
        if mode != "dense" and len(rows) != per_forward * NEW_TOKENS:
            raise AssertionError(f"{key}: {len(rows)} tape entries")
        return got, rows

    # untimed: each mode's first products at these shapes (library
    # handles, allocator growth) before any timed run
    for mode in modes:
        c = dataclasses.replace(cfg, **MODES[mode])
        serve_with_plans(torch, model, c, batch, 2,
                         tfm.plan_weight_activities(model, c))
    for mode in modes:
        c = dataclasses.replace(cfg, **MODES[mode])
        r = runs[mode] = {}
        if with_generate:
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with tape.collect() as entries:
                toks = serve_loop.generate(model, batch, c,
                                           max_new_tokens=NEW_TOKENS)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            got, rows = check_run(f"{cfg.name} {mode} generate", mode,
                                  entries)
            r.update(gen_wall=wall, gen_rows=rows, gen_tokens=toks.cpu())
            log(f"moe: {cfg.name} {mode} generate (per-call plans): "
                f"{b * NEW_TOKENS / wall * 1e3:.2f} tokens/s ({wall:.0f} ms,"
                f" stats tape on), launches "
                f"{ {k: v for k, v in got.items() if v} }; {smi}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plans = tfm.plan_weight_activities(model, c)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with tape.collect() as entries:
            out = serve_with_plans(torch, model, c, batch, NEW_TOKENS, plans)
        wall = (time.perf_counter() - t0) * 1e3
        got, rows = check_run(f"{cfg.name} {mode} cached plans", mode,
                              entries)
        if with_generate and mode != "dense" and rows != r["gen_rows"]:
            raise AssertionError(f"{cfg.name} {mode}: the cached plans' tape"
                                 " != generate's")
        if with_generate and not torch.equal(out["tokens"], r["gen_tokens"]):
            raise AssertionError(f"{cfg.name} {mode}: cached-plan tokens != "
                                 "generate's")
        if not all(torch.isfinite(st).all() for st in out["steps"]):
            raise AssertionError(f"{cfg.name} {mode}: non-finite logits")
        peak = torch.cuda.max_memory_allocated() / 1e9
        r.update(out, wall=wall, rows=rows, build_ms=build_ms, peak=peak)
        r["steps_split"] = (moe_steps(tape, entries, per_forward)
                            if mode != "dense" else None)
        # the dispatch's planning, per-call and cached (a second pass each)
        r["plan_ms"] = planning_ms(torch, lambda: serve_with_plans(
            torch, model, c, batch, NEW_TOKENS, plans))
        if with_generate:
            r["plan_ms_per_call"] = planning_ms(
                torch, lambda: serve_with_plans(torch, model, c, batch,
                                                NEW_TOKENS, None))
        # a third pass: the routing on the host, every kernel launch kept
        launches = {}

        def third():
            launches.update(record_launches(torch, lambda: serve_with_plans(
                torch, model, c, batch, NEW_TOKENS, plans)))
        _, r["routing"] = record_routing(third)
        if mode != "dense":
            # the counted run's launches, which the replayed pass repeats
            kernel_numbers[mode] = {}
            for kn, src in MOE_SOURCES.items():
                if not got[kn]:
                    continue
                if len(launches.get(src, ())) != got[kn]:
                    raise AssertionError(
                        f"{cfg.name} {mode}: {len(launches.get(src, ()))} "
                        f"{kn} launches replayed, {got[kn]} counted")
                kernel_numbers[mode][kn] = dict(
                    replayed_numbers(torch, src, launches[src]),
                    launches=got[kn])
        del launches
        t = out["times"]
        split = r["steps_split"]
        log(f"moe: {cfg.name} {mode} cached plans: "
            f"{b * NEW_TOKENS / wall * 1e3:.2f} tokens/s ({wall:.0f} ms, "
            f"stats tape on), one prefill {t[0]:.1f} ms, decode steps median "
            f"{statistics.median(t[1:]):.1f} ms, planning "
            f"{r['plan_ms'][0]:.1f} ms in {r['plan_ms'][1]} dispatches"
            + (f" ({r['plan_ms_per_call'][0]:.1f} ms on per-call plans)"
               if with_generate else "")
            + f", plans built once in {build_ms:.0f} ms, peak memory "
            f"{peak:.1f} GB; launches { {k: v for k, v in got.items() if v} }"
            + ("" if split is None else "; moe.* dense/executed steps: "
               + "; ".join(f"{part} {d}/{x} ({1 - x / d:.1%} skipped: "
                           + ", ".join(f"{n} {sd}/{sx}"
                                       for n, (sd, sx) in per.items()) + ")"
                           for part, (d, x, per) in split.items()))
            + f"; {smi}")
        if split is not None and not split["decode"][1] < split["decode"][0]:
            raise AssertionError(f"{cfg.name} {mode}: decode executes "
                                 f"{split['decode'][1]} of "
                                 f"{split['decode'][0]} moe.* steps")

    # against dense: prefill logits, routing flips, greedy tokens
    dense = runs["dense"]
    scale = dense["prefill"].abs().max().item()
    tol = SERVE_RTOL * scale
    for mode in modes[1:]:
        r = runs[mode]
        parted = parted_at(r["tokens"], dense["tokens"])
        flips, first, flipped = routing_flips(
            torch, cfg, b, s, dense["routing"], r["routing"], parted)
        keep = torch.ones(b, s, dtype=torch.bool)
        for row, pos in flipped:
            keep[row, pos] = False
        diff = (r["prefill"] - dense["prefill"]).abs().amax(-1).cpu()
        err = diff[keep].max().item()
        if not err <= tol:
            raise AssertionError(f"{cfg.name} {mode}: prefill logits differ "
                                 f"from dense by {err:.4f} > {tol:.4f} on "
                                 "tokens routed as dense")
        agree = moe_parting(torch, f"{cfg.name} {mode}", r["tokens"],
                            dense["tokens"], dense["steps"], tol, first)
        near = [f for f in flips if not f[6]]
        log(f"moe: {cfg.name} {mode} vs dense: {len(flips)} routing flips "
            f"({len(near)} near-ties, k-th/(k+1)-th gate gaps "
            + (", ".join(f"{min(f[4], f[5]):.1e}" for f in near) or "none")
            + f" <= {GATE_MARGIN}; {len(flips) - len(near)} reached by an "
            f"earlier flip), {len(flipped)} of {b * s} prefill tokens "
            f"flipped in some layer; prefill logits max |diff| on the others "
            f"{err:.4f} <= {tol:.4f} ({SERVE_RTOL} x max|dense| "
            f"{scale:.2f}), on the flipped "
            + (f"{diff[~keep].max().item():.4f}" if flipped else "none")
            + "; " + "; ".join(agree))
    return runs, kernel_numbers


def check_held(what, held, grouped_src, e_want, stages):
    """Every held stage ran the grouped kernel at ``e_want`` problems."""
    for stage in stages:
        got = held[stage].get(grouped_src)
        if got is None or not any(e == e_want for _, e, *_ in got["shapes"]):
            raise AssertionError(f"{what}: no {grouped_src} launch at E = "
                                 f"{e_want} in the {stage}")
    return "; ".join(
        f"{stage} " + ", ".join(
            f"{src} {v['n']} launches (max err {v['err']:.2e}, problems "
            + ", ".join(f"E={e} M={m} steps {lo}-{hi}"
                        for _, e, m, lo, hi in sorted(v["shapes"])) + ")"
            for src, v in sorted(held[stage].items()))
        for stage in stages)


def phase_moe(torch, smi):
    """Phase 14: MoE serving (see the module docstring).  Returns
    {K-name: numbers} of mixtral's kernels on the MoE path, dual's K1/K3
    and dual+kc's K2/K4."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MIXTRAL), n_layers=MOE_LAYERS)
    model = make_model(torch, cfg)
    runs, numbers = serve_moe(torch, cfg, model, list(MODES), smi, True)
    errs = {}
    for mode in ("dual", "dual+kc"):
        c = dataclasses.replace(cfg, **MODES[mode])
        held = hold_one_step(torch, model, c, traffic_a_batch(torch, cfg),
                             tfm.plan_weight_activities(model, c))
        src = MOE_SOURCES["K4" if mode == "dual+kc" else "K3"]
        for kn, sname in MOE_SOURCES.items():
            for stage in held.values():
                if sname in stage:
                    errs[kn] = max(errs.get(kn, 0.0), stage[sname]["err"])
        log(f"moe: {cfg.name} {mode}: every kernel launch of one prefill "
            f"and one decode held to its plain walk: "
            + check_held(f"{cfg.name} {mode}", held, src, cfg.n_experts,
                         ("prefill", "decode")))
    del model
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    qcfg = dataclasses.replace(get_config(QWEN3_MOE), n_layers=MOE_LAYERS)
    qmodel = make_model(torch, qcfg)
    qruns, qnumbers = serve_moe(torch, qcfg, qmodel, ["dense", "dual"], smi,
                                False)
    c = dataclasses.replace(qcfg, **MODES["dual"])
    held = hold_one_step(torch, qmodel, c, traffic_a_batch(torch, qcfg),
                         tfm.plan_weight_activities(qmodel, c))
    log(f"moe: {qcfg.name} dual: every kernel launch of one prefill and one "
        "decode held to its plain walk: "
        + check_held(f"{qcfg.name} dual", held, MOE_SOURCES["K3"],
                     qcfg.n_experts, ("prefill", "decode")))
    del qmodel
    torch.cuda.empty_cache()
    out = {}
    for arch, nums in ((cfg.name, numbers), (qcfg.name, qnumbers)):
        for mode, per in nums.items():
            for kn, t in per.items():
                log(f"moe: {arch} {mode} {kn}: {t['launches']} launches a "
                    f"generate (cached plans), {t['ms']:.3f} ms events, "
                    f"device "
                    f"{fmt_ms(t['device_ms'])}, bound {t['bound_ms']:.4f} ms "
                    f"by {t['bound_by']} ({t['nbytes'] / 1e9:.4f} GB, B "
                    f"{t['b_bytes'] / 1e9:.4f} GB), plain "
                    f"{t['plain_ms']:.1f} ms, torch.bmm over every "
                    f"{'expert' if kn in ('K3', 'K4') else 'problem'} "
                    f"{t['library_ms']:.3f} ms (device "
                    f"{fmt_ms(t['library_device_ms'])}); schedules "
                    f"{t['sched_mb']:.1f} MB; launches by (E, M, K, N, "
                    f"route, splits): " + ", ".join(
                        f"{k} x{n}" for k, n in sorted(t["shapes"].items()))
                    + f"; {smi}")
                if arch == cfg.name:
                    out[kn] = dict(t, max_abs_err=errs[kn])
    log(f"moe: phase {time.perf_counter() - t0:.0f} s (mixtral "
        f"{t1 - t0:.0f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 15: the dense GQA families, traffic F
# ---------------------------------------------------------------------------

def f_attention_share(tape, entries, cfg, s):
    """The scheduled share of cache-block steps of the decode's attention
    products on the tape, against the share reckoned from the positions:
    decode step t (1 .. F_NEW - 1) attends the s + t slots written, in
    ceil((s + t) / block_t) of the F_CAPACITY / block_t blocks.  Returns
    {site: (counted, dense)}; raises unless counted / dense equals it."""
    bt = cfg.sparse_block_t
    live = sum(-(-(s + t) // bt) for t in range(1, F_NEW))
    total = (F_NEW - 1) * (F_CAPACITY // bt)
    sites = site_steps(tape, entries)
    out = {}
    for name in ("attn.score", "attn.value"):
        dense, counted, executed = sites[name]
        if not (counted * total == dense * live and executed == counted):
            raise AssertionError(
                f"traffic F {name}: {counted} of {dense} steps scheduled "
                f"({executed} executed), the positions reckon {live} of "
                f"{total} blocks")
        out[name] = (counted, dense)
    return out, live / total


def phase_dense_gqa(torch, smi):
    """Phase 15, traffic F (see the module docstring).  Returns {K-name:
    numbers} of the cached-plan dual+kv run's K1 and K3 launches."""
    from repro_torch.configs import get_config, get_run_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.sparse import tape
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(QWEN15), n_layers=F_LAYERS)
    rc = get_run_config(QWEN15, "decode_32k")
    if not (rc.kv_quant and rc.attn_chunk == 2048):
        raise AssertionError(f"{QWEN15} decode_32k run config {rc}")
    model = make_model(torch, cfg)
    seed_biases(torch, model, torch.Generator(device="cuda").manual_seed(4))
    prompts = torch.randint(0, cfg.vocab_size, (F_PROMPTS, F_PROMPT_LEN),
                            generator=torch.Generator().manual_seed(6))
    batch = {"tokens": prompts.cuda()}
    b, s = prompts.shape
    counters = kernel_counters()
    per_forward, _, kvd = stack_launches(cfg)
    n1 = per_forward * F_NEW
    n3 = kvd * (F_NEW - 1)
    expect = {"dense": {}, "dual": {"K1": n1},
              "dual+kv": {"K1": n1, "K3": n3}}

    # untimed: each mode's first products at these shapes, a short prompt
    warm = {"tokens": batch["tokens"][:, :64]}
    plans = {}
    for mode, knobs in F_MODES.items():
        c = dataclasses.replace(cfg, **knobs)
        plans[mode] = tfm.plan_weight_activities(model, c)
        serve_with_plans(torch, model, c, warm, 2, plans[mode], rc=rc,
                         capacity=F_CAPACITY)
    runs = {}
    for mode, knobs in F_MODES.items():
        c = dataclasses.replace(cfg, **knobs)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with tape.collect() as entries:
            out = serve_with_plans(torch, model, c, batch, F_NEW,
                                   plans[mode], rc=rc, capacity=F_CAPACITY)
        wall = (time.perf_counter() - t0) * 1e3
        got = check_launches(f"traffic F {mode} run", counters,
                             expect[mode])
        rows = tape_rows(tape, entries)
        if mode != "dense":
            bad = [row for row in rows if row[2] != row[3]]
            if bad:
                raise AssertionError(f"traffic F {mode}: executed != counted"
                                     f" at {bad[:3]}")
        if not (torch.isfinite(out["prefill"]).all()
                and all(torch.isfinite(st).all() for st in out["steps"])):
            raise AssertionError(f"traffic F {mode}: non-finite logits")
        share = None
        if mode == "dual+kv":
            share = f_attention_share(tape, entries, c, s)
        r = runs[mode] = dict(out, wall=wall,
                              peak=torch.cuda.max_memory_allocated() / 1e9)
        t = out["times"]
        log(f"traffic F: {cfg.name} ({cfg.n_layers} layers) {mode} on int8 "
            f"{F_CAPACITY}-slot caches, cached plans: "
            f"{b * F_NEW / wall * 1e3:.2f} tokens/s ({wall:.0f} ms, stats "
            f"tape on), prefill {t[0]:.1f} ms, decode steps median "
            f"{statistics.median(t[1:]):.2f} ms, peak memory "
            f"{r['peak']:.1f} GB, launches {got}"
            + ("" if share is None else
               f"; scheduled share of cache-block steps {share[1]:.4f} "
               "(= the positions' occupancy): " + ", ".join(
                   f"{k} {v[0]}/{v[1]}" for k, v in share[0].items()))
            + f"; {smi}")
        if mode != "dense":
            # against dense on the same int8 caches: prefill logits, the
            # decode logits while the rows' tokens agree, the parting
            dense = runs["dense"]
            tol = SERVE_RTOL * dense["prefill"].abs().max().item()
            pre_err = max((r["prefill"][i] - dense["prefill"][i]).abs()
                          .max().item() for i in range(b))
            parted = parted_at(r["tokens"], dense["tokens"])
            dec_err = max([(r["steps"][t][i] - dense["steps"][t][i]).abs()
                           .max().item() for t in range(1, F_NEW)
                           for i in range(b) if t <= parted[i]] or [0.0])
            if not (pre_err <= tol and dec_err <= tol):
                raise AssertionError(
                    f"traffic F {mode}: logits differ from dense by "
                    f"{pre_err:.4f} (prefill) / {dec_err:.4f} (decode) > "
                    f"{tol:.4f}")
            agree = parting_report(torch, f"traffic F {mode}", r["tokens"],
                                   dense["tokens"], dense["steps"], tol)
            log(f"traffic F: {mode} vs dense: max |diff| {pre_err:.4f} "
                f"(prefill), {dec_err:.4f} (decodes while the tokens agree) "
                f"<= {tol:.4f} ({SERVE_RTOL} x max|dense|); "
                + "; ".join(agree))
            del r["prefill"]
    del runs["dense"]["prefill"]

    # the same dense run on a bf16 cache, reported against the int8 one
    c = dataclasses.replace(cfg, **F_MODES["dense"])
    rc16 = dataclasses.replace(rc, kv_quant=False)
    bf = serve_with_plans(torch, model, c, batch, F_NEW, None, rc=rc16,
                          capacity=F_CAPACITY)
    dense = runs["dense"]
    parted = parted_at(bf["tokens"], dense["tokens"])
    diff = max([(bf["steps"][t][i] - dense["steps"][t][i]).abs().max().item()
                for t in range(F_NEW) for i in range(b) if t <= parted[i]])
    same = (bf["tokens"] == dense["tokens"]).float().mean().item()
    log(f"traffic F: dense on a bf16 cache against the int8 one (not "
        f"gated): max |logit diff| {diff:.4f} over the steps while the "
        f"tokens agree (max|logit| "
        f"{max(st.abs().max().item() for st in dense['steps']):.2f}), "
        f"{same:.1%} of the {b * F_NEW} tokens equal, rows part at "
        f"{[parted[i] for i in range(b)]}; decode median "
        f"{statistics.median(bf['times'][1:]):.2f} ms against "
        f"{statistics.median(dense['times'][1:]):.2f}")
    del bf

    # serve_loop.generate (per-call plans) builds the int8 caches itself
    c = dataclasses.replace(cfg, **F_MODES["dual+kv"])
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = serve_loop.generate(model, batch, c, max_new_tokens=F_NEW,
                               capacity=F_CAPACITY, rc=rc)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    got = check_launches("traffic F dual+kv generate", counters,
                         expect["dual+kv"])
    if not torch.equal(toks.cpu(), runs["dual+kv"]["tokens"]):
        raise AssertionError("traffic F: generate's tokens != the cached-plan"
                             " run's")
    log(f"traffic F: dual+kv through serve_loop.generate (per-call plans, "
        f"rc {QWEN15} decode_32k): {b * F_NEW / wall * 1e3:.2f} tokens/s "
        f"({wall:.0f} ms), launches {got}, tokens == the cached-plan run's")

    # the paged engine on an int8 pool, 2 slots of F_CAPACITY
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(model, c, serve=ServeConfig(slots=F_PROMPTS,
                                             capacity=F_CAPACITY), rc=rc)
    if not all(cc.quantized for cc in eng.caches):
        raise AssertionError("traffic F: the engine's pool is not int8")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for uid in range(b):
        eng.submit(Request(uid=uid, prompt=prompts[uid].tolist(),
                           max_new_tokens=F_NEW))
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    st = eng.stats()
    got = check_launches("traffic F engine", counters, {
        "K1": per_forward * (st["prefill_calls"] + st["decode_calls"]),
        "K3": kvd * st["decode_calls"]})
    etoks = torch.tensor([r.output for r in sorted(done,
                                                   key=lambda r: r.uid)],
                         dtype=torch.int32)
    if tuple(etoks.shape) != (b, F_NEW) or st["pages_free"] != \
            st["pages_total"]:
        raise AssertionError(f"traffic F engine: tokens {etoks.shape}, "
                             f"stats {st}")
    tol = SERVE_RTOL * max(x.abs().max().item() for x in dense["steps"])
    agree = parting_report(torch, "traffic F engine", etoks, dense["tokens"],
                           dense["steps"], tol)
    log(f"traffic F: Engine, dual+kv on an int8 pool of {eng.n_pages} "
        f"pages x {eng.page} slots ({F_PROMPTS} slots x {F_CAPACITY}): "
        f"{b * F_NEW / wall * 1e3:.2f} tokens/s ({wall:.0f} ms, "
        f"{st['prefill_calls']} prefill and {st['decode_calls']} decode "
        f"calls), launches {got}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; against dense: "
        + "; ".join(agree))
    del eng, done
    torch.cuda.empty_cache()

    # the cached-plan dual+kv run again, every K1 and K3 launch held to its
    # plain walk as it runs and kept, then replayed for the device time
    numbers = held_generate(torch, "traffic F", model, c, batch,
                            plans["dual+kv"], rc, F_CAPACITY, F_NEW,
                            HELD_KERNELS["dual+kv"])
    for kn, t in numbers.items():
        if t["launches"] != expect["dual+kv"][kn]:
            raise AssertionError(f"traffic F: {t['launches']} {kn} launches "
                                 f"replayed, {expect['dual+kv'][kn]} counted")
        kernel_numbers_line("traffic F: dual+kv", kn, t, smi)
    del model, plans
    torch.cuda.empty_cache()
    log(f"traffic F: phase {time.perf_counter() - t_phase:.0f} s")
    return numbers


# ---------------------------------------------------------------------------
# phase 16: Mamba2 and the hybrid, traffics G and H
# ---------------------------------------------------------------------------

# traffic G, recurrent state beside an int8 long-context cache with MoE on
# alternate layers: full-width jamba-1.5-large-398b cut to its period's
# first two positions (attention + dense MLP, Mamba + MoE) under its
# decode_32k run config, in traffic F's shape (2 x 3000 prompt tokens into
# 32768-slot caches, 16 new)
JAMBA = "jamba-1.5-large-398b"
G_LAYERS = 2
G_MODES = {"dense": MODES["dense"], "dual": MODES["dual"],
           "dual+kv": KV_MODES["dual+kv"],
           "dual+kc+kv": KV_MODES["dual+kc+kv"]}
# traffic H, a whole attention-free model with a tied head: mamba2-370m
# at full width and depth, H_PROMPTS prompts of H_PROMPT_LEN tokens and
# H_NEW new through generate; the engine on H_SLOTS slots with requests
# of H_ENGINE_LENS prompt tokens (a ladder, not a measured mix), H_NEW new
MAMBA2 = "mamba2-370m"
H_PROMPTS, H_PROMPT_LEN, H_NEW = 4, 2048, 32
H_SLOTS = 4
H_ENGINE_LENS = (256, 512, 768, 1024, 1280, 1536, 1792, 2048)
H_MODES = {"dense": MODES["dense"], "dual": MODES["dual"]}
# the SSD's functions in repro_torch.models.ssm and the profiler range
# each runs in when its share of device time is measured
SSM_RANGES = {"ssd_chunked": "ssd.scan", "ssd_step": "ssd.scan",
              "_conv_silu": "ssd.conv"}


def ssd_shares(torch, model, c, batch, rc, capacity):
    """One prefill and one decode step of ``model`` under the profiler,
    the SSD scan (``ssd_chunked`` at prefill, ``ssd_step`` at decode) and
    the causal conv (``_conv_silu``) each in a named range: {stage:
    (device ms, scan ms, conv ms, scan events ms, conv events ms)}, the
    device times from the trace (a range's: its kernels'), the events
    CUDA events around each call; the device times None when the trace
    holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import ssm as ssmm
    from repro_torch.models import transformer as tfm
    real = {name: getattr(ssmm, name) for name in SSM_RANGES}
    events = {}

    def wrapped(name):
        fn, label = real[name], SSM_RANGES[name]

        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with record_function(label):
                start.record()
                out = fn(*args, **kwargs)
                end.record()
            events.setdefault(label, []).append((start, end))
            return out
        return call
    b, s = batch["tokens"].shape
    caches = tfm.init_caches(c, b, capacity,
                             quantized=bool(rc and rc.kv_quant))
    out, nxt = {}, None
    for name in SSM_RANGES:
        setattr(ssmm, name, wrapped(name))
    try:
        for stage in ("prefill", "decode"):
            events.clear()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                if stage == "prefill":
                    o = model(batch, c, caches=caches,
                              positions=torch.arange(s, device="cuda"),
                              rc=rc)
                else:
                    o = model({"tokens": nxt}, c, caches=caches,
                              positions=torch.tensor([s], device="cuda"),
                              rc=rc)
                torch.cuda.synchronize()
            caches, nxt = o.caches, o.logits[:, -1:].argmax(-1)
            labels = set(SSM_RANGES.values())
            total = sum(e.device_time_total for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and e.name not in labels)
            part = {lb: sum(e.device_time_total for e in prof.events()
                            if e.name == lb
                            and e.device_type == DeviceType.CPU)
                    for lb in ("ssd.scan", "ssd.conv")}
            ev = {lb: sum(a.elapsed_time(z) for a, z in events.get(lb, []))
                  for lb in ("ssd.scan", "ssd.conv")}
            out[stage] = ((total / 1e3, part["ssd.scan"] / 1e3,
                           part["ssd.conv"] / 1e3) if total > 0
                          else (None, None, None)) + (ev["ssd.scan"],
                                                      ev["ssd.conv"])
    finally:
        for name, fn in real.items():
            setattr(ssmm, name, fn)
    return out


def fmt_shares(shares):
    def one(stage, v):
        dev, scan, conv, ev_scan, ev_conv = v
        head = (f"{stage}: device {dev:.2f} ms, SSD scan {scan:.3f} ms "
                f"({scan / dev:.1%}), causal conv {conv:.3f} ms "
                f"({conv / dev:.1%})" if dev else
                f"{stage}: device time not measured")
        return head + (f" [CUDA events: scan {ev_scan:.3f} ms, conv "
                       f"{ev_conv:.3f} ms]")
    return "; ".join(one(stage, v) for stage, v in shares.items())


def kernel_numbers_line(what, kn, t, smi):
    log(f"{what} {kn}: all {t['launches']} launches of a generate held to "
        f"their plain walks (max err {t['max_abs_err']:.2e}); "
        f"{t['ms']:.3f} ms events, device {fmt_ms(t['device_ms'])}, bound "
        f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
        f"({t['nbytes'] / 1e9:.4f} GB, {t['flops'] / 1e12:.3f} TFLOP), "
        f"plain {t['plain_ms']:.1f} ms, torch.bmm over every problem "
        f"{t['library_ms']:.3f} ms (device "
        f"{fmt_ms(t['library_device_ms'])}); launches by (E, M, K, N, "
        "route, splits): " + ", ".join(
            f"{k} x{n}" for k, n in sorted(t["shapes"].items()))
        + f"; {smi}")


def held_generate(torch, what, model, c, batch, plans, rc, capacity, new,
                  pairs):
    """One cached-plan generate with every K1-K4 launch held to its plain
    walk as it runs and kept (:func:`held_to_plain` around
    :func:`record_launches`), then each kernel of ``pairs`` ((name,
    source)) replayed for its device time.  Returns {name: numbers}."""
    launches = {}

    def recorded():
        launches.update(record_launches(torch, lambda: serve_with_plans(
            torch, model, c, batch, new, plans, rc=rc, capacity=capacity)))
    held = held_to_plain(torch, None, recorded, what)
    numbers = {}
    for kn, src in pairs:
        got = launches.get(src, [])
        if not (got and len(got) == held[src]["n"]):
            raise AssertionError(f"{what}: {len(got)} {kn} launches "
                                 f"recorded, {held.get(src, {}).get('n')} "
                                 "held")
        t = replayed_numbers(torch, src, got, plain=False)
        numbers[kn] = dict(t, launches=len(got), max_abs_err=held[src]["err"],
                           plain_ms=held[src]["plain_ms"])
    return numbers


def serve_jamba(torch, smi):
    """Traffic G (see the module docstring).  Returns {K-name: numbers} of
    the cached-plan dual+kv generate's K1/K3 and dual+kc+kv's K2/K4."""
    from repro_torch.configs import get_config, get_run_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models import ssm as ssmm
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.sparse import tape
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(JAMBA), n_layers=G_LAYERS)
    rc = get_run_config(JAMBA, "decode_32k")
    if not (rc.kv_quant and rc.attn_chunk == 2048):
        raise AssertionError(f"{JAMBA} decode_32k run config {rc}")
    layers = [(cfg.layer_kind(i), cfg.layer_is_moe(i))
              for i in range(cfg.n_layers)]
    if layers != [("attn", False), ("mamba", True)]:
        raise AssertionError(f"traffic G layers {layers}")
    model = make_model(torch, cfg)
    prompts = torch.randint(0, cfg.vocab_size, (F_PROMPTS, F_PROMPT_LEN),
                            generator=torch.Generator().manual_seed(7))
    batch = {"tokens": prompts.cuda()}
    b, s = prompts.shape
    counters = kernel_counters()
    k1f, k3f, kvd = stack_launches(cfg)
    n1, n3, nkv = k1f * F_NEW, k3f * F_NEW, kvd * (F_NEW - 1)
    expect = {"dense": {}, "dual": {"K1": n1, "K3": n3},
              "dual+kv": {"K1": n1, "K3": n3 + nkv},
              "dual+kc+kv": {"K2": n1, "K4": n3 + nkv}}

    # untimed: each mode's first products at these shapes, a short prompt
    warm = {"tokens": batch["tokens"][:, :64]}
    plans = {}
    for mode, knobs in G_MODES.items():
        c = dataclasses.replace(cfg, **knobs)
        plans[mode] = tfm.plan_weight_activities(model, c)
        serve_with_plans(torch, model, c, warm, 2, plans[mode], rc=rc,
                         capacity=F_CAPACITY)
    runs = {}
    for mode, knobs in G_MODES.items():
        c = dataclasses.replace(cfg, **knobs)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(counters)
        t0 = time.perf_counter()
        with tape.collect() as entries:
            out, routing = record_routing(lambda: serve_with_plans(
                torch, model, c, batch, F_NEW, plans[mode], rc=rc,
                capacity=F_CAPACITY))
        wall = (time.perf_counter() - t0) * 1e3
        got = check_launches(f"traffic G {mode} run", counters, expect[mode])
        rows = tape_rows(tape, entries)
        if mode != "dense":
            bad = [row for row in rows if row[2] != row[3]]
            if bad:
                raise AssertionError(f"traffic G {mode}: executed != counted"
                                     f" at {bad[:3]}")
        if not (torch.isfinite(out["prefill"]).all()
                and all(torch.isfinite(st).all() for st in out["steps"])):
            raise AssertionError(f"traffic G {mode}: non-finite logits")
        share = (f_attention_share(tape, entries, c, s)
                 if c.sparse_kv else None)
        r = runs[mode] = dict(out, routing=routing, wall=wall,
                              peak=torch.cuda.max_memory_allocated() / 1e9)
        t = out["times"]
        log(f"traffic G: {cfg.name} ({cfg.n_layers} layers: attention + "
            f"MLP, Mamba + MoE) {mode} on int8 {F_CAPACITY}-slot caches, "
            f"cached plans: {b * F_NEW / wall * 1e3:.2f} tokens/s "
            f"({wall:.0f} ms, stats tape on, routing read to the host), "
            f"prefill {t[0]:.1f} ms, decode steps median "
            f"{statistics.median(t[1:]):.2f} ms, peak memory "
            f"{r['peak']:.1f} GB, launches {got}"
            + ("" if share is None else
               f"; scheduled share of cache-block steps {share[1]:.4f} "
               "(= the positions' occupancy): " + ", ".join(
                   f"{k} {v[0]}/{v[1]}" for k, v in share[0].items()))
            + f"; {smi}")
        if mode == "dense":
            continue
        # against dense: prefill logits on the tokens routed alike, routing
        # flips only at near-ties, greedy tokens parting only at top-2 ties
        # or after a flip in their row
        dense = runs["dense"]
        scale = dense["prefill"].abs().max().item()
        tol = SERVE_RTOL * scale
        parted = parted_at(r["tokens"], dense["tokens"])
        flips, first, flipped = routing_flips(
            torch, cfg, b, s, dense["routing"], r["routing"], parted)
        keep = torch.ones(b, s, dtype=torch.bool)
        for row, pos in flipped:
            keep[row, pos] = False
        diff = (r["prefill"] - dense["prefill"]).abs().amax(-1).cpu()
        err = diff[keep].max().item()
        if not err <= tol:
            raise AssertionError(f"traffic G {mode}: prefill logits differ "
                                 f"from dense by {err:.4f} > {tol:.4f} on "
                                 "tokens routed as dense")
        agree = moe_parting(torch, f"traffic G {mode}", r["tokens"],
                            dense["tokens"], dense["steps"], tol, first)
        log(f"traffic G: {mode} vs dense: {len(flips)} routing flips "
            f"({len([f for f in flips if not f[6]])} near-ties <= "
            f"{GATE_MARGIN}), {len(flipped)} of {b * s} prefill tokens "
            f"flipped; prefill logits max |diff| on the others {err:.4f} <= "
            f"{tol:.4f} ({SERVE_RTOL} x max|dense| {scale:.2f}); "
            + "; ".join(agree))
        del r["prefill"]
    del runs["dense"]["prefill"]

    for mode in ("dense", "dual+kv"):
        shares = ssd_shares(torch, model,
                            dataclasses.replace(cfg, **G_MODES[mode]),
                            batch, rc, F_CAPACITY)
        log(f"traffic G: {mode}, the Mamba layer's share of one prefill and "
            f"one decode step: {fmt_shares(shares)}; {smi}")

    # serve_loop.generate (per-call plans) builds the int8 caches itself
    c = dataclasses.replace(cfg, **G_MODES["dual+kv"])
    reset_launches(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = serve_loop.generate(model, batch, c, max_new_tokens=F_NEW,
                               capacity=F_CAPACITY, rc=rc)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    got = check_launches("traffic G dual+kv generate", counters,
                         expect["dual+kv"])
    if not torch.equal(toks.cpu(), runs["dual+kv"]["tokens"]):
        raise AssertionError("traffic G: generate's tokens != the "
                             "cached-plan run's")
    log(f"traffic G: dual+kv through serve_loop.generate (per-call plans, "
        f"rc {JAMBA} decode_32k): {b * F_NEW / wall * 1e3:.2f} tokens/s "
        f"({wall:.0f} ms), launches {got}, tokens == the cached-plan run's")

    # the paged engine on an int8 pool, 2 slots of F_CAPACITY
    reset_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(model, c, serve=ServeConfig(slots=F_PROMPTS,
                                             capacity=F_CAPACITY), rc=rc)
    kinds = [type(cc).__name__ for cc in eng.caches]
    if not (all(cc.quantized for cc in eng.caches
                if not isinstance(cc, ssmm.SSMState))
            and kinds == ["PagedSparseKVCache", "SSMState"]):
        raise AssertionError(f"traffic G: the engine's caches {kinds}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for uid in range(b):
        eng.submit(Request(uid=uid, prompt=prompts[uid].tolist(),
                           max_new_tokens=F_NEW))
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    st = eng.stats()
    calls = st["prefill_calls"] + st["decode_calls"]
    got = check_launches("traffic G engine", counters, {
        "K1": k1f * calls, "K3": k3f * calls + kvd * st["decode_calls"]})
    etoks = torch.tensor([r.output for r in sorted(done,
                                                   key=lambda r: r.uid)],
                         dtype=torch.int32)
    if tuple(etoks.shape) != (b, F_NEW) or st["pages_free"] != \
            st["pages_total"]:
        raise AssertionError(f"traffic G engine: tokens {etoks.shape}, "
                             f"stats {st}")
    base = runs["dual+kv"]
    tol = SERVE_RTOL * max(x.abs().max().item() for x in base["steps"])
    agree = parting_report(torch, "traffic G engine", etoks, base["tokens"],
                           base["steps"], tol)
    log(f"traffic G: Engine, dual+kv on an int8 pool of {eng.n_pages} pages "
        f"x {eng.page} slots ({F_PROMPTS} slots x {F_CAPACITY}) and per-slot"
        f" SSM state: {b * F_NEW / wall * 1e3:.2f} tokens/s ({wall:.0f} ms, "
        f"{st['prefill_calls']} prefill and {st['decode_calls']} decode "
        f"calls), launches {got}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; against generate"
        f" (its batched prefill): " + "; ".join(agree))
    del eng, done
    torch.cuda.empty_cache()

    numbers = {}
    for mode, pairs in HELD_KERNELS.items():
        c = dataclasses.replace(cfg, **G_MODES[mode])
        got = held_generate(torch, f"traffic G {mode}", model, c, batch,
                            plans[mode], rc, F_CAPACITY, F_NEW, pairs)
        for kn, t in got.items():
            if t["launches"] != expect[mode][kn]:
                raise AssertionError(f"traffic G {mode}: {t['launches']} "
                                     f"{kn} launches replayed, "
                                     f"{expect[mode][kn]} counted")
            kernel_numbers_line(f"traffic G: {mode}", kn, t, smi)
        numbers.update(got)
        torch.cuda.empty_cache()
    del model, plans, runs
    torch.cuda.empty_cache()
    log(f"traffic G: {time.perf_counter() - t_phase:.0f} s")
    return numbers


def serve_mamba2(torch, smi):
    """Traffic H (see the module docstring).  Returns {"K1": numbers} of
    the dual generate's tied-head launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving import serve_loop
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.sparse import tape
    t_phase = time.perf_counter()
    cfg = get_config(MAMBA2)
    model = make_model(torch, cfg)
    if model.lm_head is not None or not cfg.tie_embeddings:
        raise AssertionError(f"{MAMBA2}: the head is not tied")
    prompts = torch.randint(0, cfg.vocab_size, (H_PROMPTS, H_PROMPT_LEN),
                            generator=torch.Generator().manual_seed(8))
    batch = {"tokens": prompts.cuda()}
    b, s = prompts.shape
    counters = kernel_counters()
    k1f = stack_launches(cfg)[0]
    expect = {"dense": {}, "dual": {"K1": k1f * H_NEW}}
    warm = {"tokens": batch["tokens"][:, :64]}
    for knobs in H_MODES.values():
        serve_with_plans(torch, model, dataclasses.replace(cfg, **knobs),
                         warm, 2, None)
    runs = {}
    for mode, knobs in H_MODES.items():
        c = dataclasses.replace(cfg, **knobs)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(counters)
        t0 = time.perf_counter()
        with tape.collect() as entries:
            out = serve_with_plans(torch, model, c, batch, H_NEW, None)
        wall = (time.perf_counter() - t0) * 1e3
        got = check_launches(f"traffic H {mode} run", counters,
                             expect[mode])
        rows = tape_rows(tape, entries)
        if mode != "dense" and (len(rows) != k1f * H_NEW
                                or any(row[2] != row[3] for row in rows)):
            raise AssertionError(f"traffic H {mode}: tape {rows[:3]}")
        if not (torch.isfinite(out["prefill"]).all()
                and all(torch.isfinite(st).all() for st in out["steps"])):
            raise AssertionError(f"traffic H {mode}: non-finite logits")
        peak = torch.cuda.max_memory_allocated() / 1e9
        # serve_loop.generate: the same tokens
        reset_launches(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = serve_loop.generate(model, batch, c, max_new_tokens=H_NEW)
        torch.cuda.synchronize()
        gen_wall = (time.perf_counter() - t0) * 1e3
        check_launches(f"traffic H {mode} generate", counters, expect[mode])
        if not torch.equal(toks.cpu(), out["tokens"]):
            raise AssertionError(f"traffic H {mode}: generate's tokens != "
                                 "the loop's")
        runs[mode] = dict(out, wall=wall)
        t = out["times"]
        log(f"traffic H: {cfg.name} (all {cfg.n_layers} layers, tied head) "
            f"{mode}: {b * H_NEW / wall * 1e3:.2f} tokens/s ({wall:.0f} ms, "
            f"stats tape on; generate {b * H_NEW / gen_wall * 1e3:.2f} "
            f"tokens/s, {gen_wall:.0f} ms, the same tokens), prefill "
            f"{t[0]:.1f} ms, decode steps median "
            f"{statistics.median(t[1:]):.2f} ms, peak memory {peak:.1f} GB, "
            f"launches {got}; {smi}")
    dense, dual = runs["dense"], runs["dual"]
    tol = SERVE_RTOL * dense["prefill"].abs().max().item()
    pre_err = (dual["prefill"] - dense["prefill"]).abs().max().item()
    parted = parted_at(dual["tokens"], dense["tokens"])
    dec_err = max([(dual["steps"][t][i] - dense["steps"][t][i]).abs()
                   .max().item() for t in range(1, H_NEW) for i in range(b)
                   if t <= parted[i]] or [0.0])
    if not (pre_err <= tol and dec_err <= tol):
        raise AssertionError(f"traffic H dual: logits differ from dense by "
                             f"{pre_err:.4f} (prefill) / {dec_err:.4f} "
                             f"(decode) > {tol:.4f}")
    agree = parting_report(torch, "traffic H dual", dual["tokens"],
                           dense["tokens"], dense["steps"], tol)
    log(f"traffic H: dual vs dense: max |diff| {pre_err:.4f} (prefill), "
        f"{dec_err:.4f} (decodes while the tokens agree) <= {tol:.4f} "
        f"({SERVE_RTOL} x max|dense|); " + "; ".join(agree))

    # continuity: one forward over the prompt and the first H_NEW - 1
    # tokens against the prefill and the decode steps that fed them, in
    # bf16 after one step (the JAX package's continuity test, at the served
    # width) and in float32 (the model cast up) after every step; bf16's
    # later steps are reported: their bf16 roundings differ from the
    # prefill's and pass through the state and 48 layers
    from repro_torch.configs.base import RunConfig
    c = dataclasses.replace(cfg, **H_MODES["dense"])

    def continuity(m, rc, run):
        seq = torch.cat([batch["tokens"], run["tokens"][:, :H_NEW - 1].to(
            device="cuda", dtype=batch["tokens"].dtype)], 1)
        with torch.inference_mode():
            full = m({"tokens": seq}, c, rc=rc).logits[:, s - 1:].float()
        stepped = torch.stack(run["steps"], 1)
        return ((full - stepped).abs().amax((0, 2)).tolist(),
                stepped.abs().max().item())
    bf_t, bf_scale = continuity(model, None, dense)
    m32 = copy.deepcopy(model).float()
    rc32 = RunConfig(act_dtype="float32")
    f32_t, f32_scale = continuity(m32, rc32, serve_with_plans(
        torch, m32, c, batch, H_NEW, None, rc=rc32))
    del m32
    if not (bf_t[1] <= SERVE_RTOL * bf_scale
            and max(f32_t) <= RTOL["float32"] * f32_scale):
        raise AssertionError(
            f"traffic H: prefill + steps vs one forward: bf16 {bf_t[1]:.4f} "
            f"after one step (> {SERVE_RTOL * bf_scale:.4f}?), float32 "
            f"{max(f32_t):.2e} (> {RTOL['float32'] * f32_scale:.2e}?)")
    log(f"traffic H: continuity, prefill({s}) + t decode steps against one "
        f"forward over {s} + t tokens (dense): bf16 after one step "
        f"{bf_t[1]:.4f} <= {SERVE_RTOL * bf_scale:.4f} ({SERVE_RTOL} x "
        f"max|logit| {bf_scale:.2f}); float32 over t = 1..{H_NEW - 1} "
        f"{max(f32_t):.2e} <= {RTOL['float32'] * f32_scale:.2e} "
        f"({RTOL['float32']} x {f32_scale:.2f}); bf16 by t (not gated): "
        + ", ".join(f"{x:.4f}" for x in bf_t[1:]))
    del dense["prefill"], dual["prefill"]

    # the tied head: its per-call plan and its contiguous copy
    c = dataclasses.replace(cfg, **H_MODES["dual"])
    plan_ms, plan_calls = planning_ms(torch, lambda: serve_with_plans(
        torch, model, c, batch, H_NEW, None))
    copy_ms = cuda_ms(torch, lambda: model.embed.t().contiguous(), 20)
    log(f"traffic H: the tied head (K = {cfg.d_model}, N = {cfg.vocab_size}"
        f", a {cfg.vocab_size % 128}-column last tile) planned per call: "
        f"{plan_ms:.1f} ms in {plan_calls} dispatches a generate "
        f"({plan_ms / plan_calls:.3f} ms each); its contiguous copy "
        f"{copy_ms:.4f} ms a call (CUDA events); {smi}")
    for mode in H_MODES:
        shares = ssd_shares(torch, model,
                            dataclasses.replace(cfg, **H_MODES[mode]),
                            batch, None, s + 2)
        log(f"traffic H: {mode}, the {cfg.n_layers} Mamba layers' share of "
            f"one prefill and one decode step: {fmt_shares(shares)}; {smi}")

    # the engine: H_SLOTS slots, exact prefills, every request against its
    # own batch-1 generate
    rng = torch.Generator().manual_seed(9)
    reqs = [torch.randint(0, cfg.vocab_size, (n,), generator=rng)
            for n in H_ENGINE_LENS]
    refs = [serve_with_plans(torch, model, c, {"tokens": p[None].cuda()},
                             H_NEW, None) for p in reqs]
    reset_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    cap = -(-(max(H_ENGINE_LENS) + H_NEW + 1) // 32) * 32
    eng = Engine(model, c, serve=ServeConfig(slots=H_SLOTS, capacity=cap))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for uid, p in enumerate(reqs):
        eng.submit(Request(uid=uid, prompt=p.tolist(),
                           max_new_tokens=H_NEW))
    done = sorted(eng.run_to_completion(), key=lambda r: r.uid)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    st = eng.stats()
    got = check_launches("traffic H engine", counters, {
        "K1": k1f * (st["prefill_calls"] + st["decode_calls"])})
    if [len(r.output) for r in done] != [H_NEW] * len(reqs):
        raise AssertionError(f"traffic H engine: {st}")
    agree = []
    for r, ref in zip(done, refs):
        tol = SERVE_RTOL * max(x.abs().max().item() for x in ref["steps"])
        agree += parting_report(
            torch, f"traffic H engine request {r.uid}",
            torch.tensor([r.output], dtype=torch.int32), ref["tokens"],
            ref["steps"], tol)
    log(f"traffic H: Engine, dual, {H_SLOTS} slots, {len(reqs)} requests of "
        f"{H_ENGINE_LENS[0]}-{H_ENGINE_LENS[-1]} prompt tokens, {H_NEW} new "
        f"each: {len(reqs) * H_NEW / wall * 1e3:.2f} tokens/s ({wall:.0f} "
        f"ms, {st['prefill_calls']} prefill and {st['decode_calls']} decode "
        f"calls, {st['ticks']} ticks), launches {got}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; against each "
        "request's batch-1 generate: " + "; ".join(
            f"request {i}: {a.split(': ', 1)[1]}"
            for i, a in enumerate(agree)))
    del eng, done, refs
    torch.cuda.empty_cache()

    numbers = held_generate(torch, "traffic H dual", model, c, batch, None,
                            None, None, H_NEW,
                            (("K1", "bitmap_spgemm.cu"),))
    if numbers["K1"]["launches"] != expect["dual"]["K1"]:
        raise AssertionError(f"traffic H: {numbers['K1']['launches']} K1 "
                             "launches replayed")
    kernel_numbers_line("traffic H: dual", "K1", numbers["K1"], smi)
    del model
    torch.cuda.empty_cache()
    log(f"traffic H: {time.perf_counter() - t_phase:.0f} s")
    return numbers


def phase_hybrid(torch, smi):
    """Phase 16: traffics G and H.  Returns {"traffic_g": {K-name:
    numbers}, "traffic_h": {"K1": numbers}}."""
    t0 = time.perf_counter()
    out = {"traffic_g": serve_jamba(torch, smi),
           "traffic_h": serve_mamba2(torch, smi)}
    log(f"hybrid: phase {time.perf_counter() - t0:.0f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: the VLM, traffic I
# ---------------------------------------------------------------------------

# traffic I, a served VLM with a real image: full-width llama-3.2-vision-90b
# cut to one period of I_LAYERS layers (a tanh-gated cross layer, then 4
# self layers) under its decode_32k run config, in traffic F's shape (2 x
# 3000 prompt tokens into 32768-slot caches, 16 new), each request with
# one 560 x 560 x 3 image through the patch-conv frontend (K5 -> K7 -> K1)
VLM = "llama-3.2-vision-90b"
I_LAYERS = 5
I_MODES = G_MODES
# the cross layers' gates: drawn from the seeded generator in [0.5, 1), so
# that tanh(gate) does not multiply the image away (it is 0 at init)
I_GATE_LOW = 0.5


def memory_inputs(torch, cfg, b, g):
    """The frontend's input of ``b`` requests on ``g``'s device, drawn as
    the JAX package's ``frontend_inputs`` draws it: ReLU-clipped normal
    images for the vision frontend; nothing for a model without one."""
    if cfg.frontend != "vision":
        return {}
    shape = (b, cfg.image_size, cfg.image_size, cfg.image_channels)
    return {"images": torch.randn(shape, generator=g,
                                  device=g.device).clamp(min=0)}


def seed_gates(torch, model, g):
    """Every cross layer's ``gate_attn`` drawn from ``g`` in [I_GATE_LOW,
    1): ``init_model`` starts it at zero, as the JAX package does, and
    tanh(0) would leave the image out of the logits."""
    with torch.no_grad():
        for layer in model.layers:
            if hasattr(layer, "gate_attn"):
                u = torch.rand((), generator=g, device=g.device)
                layer.gate_attn.copy_(I_GATE_LOW + (1 - I_GATE_LOW) * u)


def vlm_launches(cfg):
    """(K1 or K2 launches of a prefill, of a decode step, K3 or K4
    launches of a decode step's attention) of a VLM stack: at prefill
    q/k/v/o at every layer (a cross layer's k/v over the image memory), the
    SwiGLU MLP's three a layer, the head and the patch conv's GEMM; at a
    decode step a cross layer's q/o only (its K/V are cached) and no
    patch conv; score and value at each self layer's sparse-KV decode (a
    cross layer attends over its plain cache)."""
    kinds = [cfg.layer_kind(i % cfg.period) for i in range(cfg.n_layers)]
    n_self, n_cross = kinds.count("attn"), kinds.count("cross")
    ffn = 3 * cfg.n_layers
    return (4 * cfg.n_layers + ffn + 1 + 1,
            4 * n_self + 2 * n_cross + ffn + 1, 2 * n_self)


def held_conv(torch, fn):
    """``fn()`` with every K5 and K7 launch of ``kernels.ops`` held bit-equal
    to its plain walk on the same inputs, run right after the launch, and
    kept: {"K5": [x], "K7": [(cond, bits, kh, kw, stride)]}.  Seen at
    ``ops._k5`` / ``ops._k7``, which ``ops.sparse_im2col`` looks up at each
    call; the plain walks are not launches and are not counted."""
    from repro_torch.kernels import bitmap_encode as k5
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparse_im2col as k67
    real5, real7, seen = kops._k5, kops._k7, {"K5": [], "K7": []}

    def enc(x, **kw):
        bits, cond = real5(x, **kw)
        pb, pc = k5.bitmap_encode_plain(x)
        if not (torch.equal(bits, pb)
                and torch.equal(raw_bits(cond), raw_bits(pc))):
            raise AssertionError(f"K5 != plain at {tuple(x.shape)}")
        seen["K5"].append(x)
        return bits, cond

    def strided(cond, bits, *, kh, kw, stride, **kw_):
        ob, ov = real7(cond, bits, kh=kh, kw=kw, stride=stride, **kw_)
        qb, qv = k67.sparse_im2col_strided_plain(cond, bits, kh=kh, kw=kw,
                                                 stride=stride)
        if not (torch.equal(ob, qb)
                and torch.equal(raw_bits(ov), raw_bits(qv))):
            raise AssertionError(f"K7 != plain at {tuple(cond.shape)}")
        seen["K7"].append((cond, bits, kh, kw, stride))
        return ob, ov
    kops._k5, kops._k7 = enc, strided
    try:
        fn()
    finally:
        kops._k5, kops._k7 = real5, real7
    return seen


def conv_numbers(torch, seen):
    """K5's and K7's launches of one generate (:func:`held_conv`) replayed
    on their inputs: device time, CUDA events, the plain walks, the bound
    from the bytes each must move (:func:`conv_kernel_bytes`) and, for K7,
    ``F.unfold`` over the images (its dense lowering).  {name: numbers}."""
    import torch.nn.functional as F
    from repro_torch.kernels import bitmap_encode as k5
    from repro_torch.kernels import sparse_im2col as k67
    (x,), ((cond7, bits7, kh, kw, stride),) = seen["K5"], seen["K7"]
    bits, cond = k5.bitmap_encode(x)
    ob, ov = k67.sparse_im2col_strided(cond7, bits7, kh=kh, kw=kw,
                                       stride=stride)
    b5, b7 = conv_kernel_bytes(torch, x, bits, cond, ob, ov)
    xn = x.contiguous()
    out = {}
    for kn, fn, plain, nb, lib in (
            ("K5", lambda: k5.bitmap_encode(x),
             lambda: k5.bitmap_encode_plain(x), b5, None),
            ("K7", functools.partial(k67.sparse_im2col_strided, cond7, bits7,
                                     kh=kh, kw=kw, stride=stride),
             functools.partial(k67.sparse_im2col_strided_plain, cond7, bits7,
                               kh=kh, kw=kw, stride=stride), b7,
             lambda: F.unfold(xn, (kh, kw), stride=stride))):
        out[kn] = dict(
            launches=1, max_abs_err=0.0, ms=cuda_ms(torch, fn, 5),
            device_ms=device_ms(torch, fn), plain_ms=cuda_ms(torch, plain, 1),
            nbytes=nb, bound_ms=nb / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None if lib is None else device_ms(torch, lib),
            zero_share=1.0 - int(torch.count_nonzero(ov)) / ov.numel(),
            routes=conv_routes(x.permute(0, 2, 3, 1), kh, kw, stride))
    return out


def range_shares(torch, fn, wraps):
    """``fn()`` once under the profiler with each of ``wraps`` ({(object,
    attribute): label}) run in a named range: (the device time of all the
    kernels ``fn`` launched, {label: the device time of its range's
    kernels}) in ms, (None, {}) when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    real = {key: getattr(*key) for key in wraps}
    own = {key: key[1] in vars(key[0]) for key in wraps}

    def wrapped(key):
        fn_, label = real[key], wraps[key]

        def call(*args, **kwargs):
            with record_function(label):
                return fn_(*args, **kwargs)
        return call
    for key in wraps:
        setattr(*key, wrapped(key))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for key, f in real.items():
            if own[key]:
                setattr(*key, f)
            else:
                delattr(*key)
    labels = set(wraps.values())
    total = sum(e.device_time_total for e in prof.events()
                if e.device_type == DeviceType.CUDA and e.name not in labels)
    if not total > 0:
        return None, {}
    part = {lb: sum(e.device_time_total for e in prof.events()
                    if e.name == lb and e.device_type == DeviceType.CPU) / 1e3
            for lb in labels}
    return total / 1e3, part


def serve_vlm(torch, smi):
    """Phase 17, traffic I (see the module docstring).  Returns {K-name:
    numbers} of the cached-plan dual+kv generate's K1/K3/K5/K7 and
    dual+kc+kv's K2/K4."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config, get_run_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models import cache as kvc
    from repro_torch.models import frontend as fem
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    from repro_torch.serving.engine import Engine
    from repro_torch.sparse import tape
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(VLM), n_layers=I_LAYERS)
    rc = get_run_config(VLM, "decode_32k")
    if not (rc.kv_quant and rc.attn_chunk == 2048):
        raise AssertionError(f"{VLM} decode_32k run config {rc}")
    kinds = [cfg.layer_kind(i % cfg.period) for i in range(cfg.n_layers)]
    if kinds != ["cross"] + ["attn"] * 4 or cfg.n_periods != 1:
        raise AssertionError(f"traffic I layers {kinds}")
    model = make_model(torch, cfg)
    seed_gates(torch, model, torch.Generator(device="cuda").manual_seed(5))
    prompts = torch.randint(0, cfg.vocab_size, (F_PROMPTS, F_PROMPT_LEN),
                            generator=torch.Generator().manual_seed(9))
    images = memory_inputs(torch, cfg, F_PROMPTS, torch.Generator(
        device="cuda").manual_seed(8))["images"].to(torch.bfloat16)
    batch = {"tokens": prompts.cuda(), "images": images}
    b, s = prompts.shape
    counters = kernel_counters()
    k1p, k1d, kvd = vlm_launches(cfg)
    n1, nkv = k1p + (F_NEW - 1) * k1d, kvd * (F_NEW - 1)
    conv = {"K5": 1, "K7": 1}
    expect = {"dense": {}, "dual": {"K1": n1, **conv},
              "dual+kv": {"K1": n1, "K3": nkv, **conv},
              "dual+kc+kv": {"K2": n1, "K4": nkv, **conv}}
    gates = [round(layer.gate_attn.item(), 4) for layer in model.layers
             if hasattr(layer, "gate_attn")]
    log(f"traffic I: {cfg.name} ({cfg.n_layers} layers: {kinds}; gates "
        f"{gates}), {cfg.num_image_tokens} image tokens an image "
        f"({cfg.image_size}^2 x {cfg.image_channels}, patch "
        f"{cfg.patch_size}); launches a prefill: K1/K2 {k1p}, K5 1, K7 1; "
        f"a decode step: K1/K2 {k1d}, K3/K4 {kvd}")

    # untimed: each mode's first products at these shapes, a short prompt
    warm = {"tokens": batch["tokens"][:, :64], "images": images}
    plans = {}
    for mode, knobs in I_MODES.items():
        c = dataclasses.replace(cfg, **knobs)
        plans[mode] = tfm.plan_weight_activities(model, c)
        serve_with_plans(torch, model, c, warm, 2, plans[mode], rc=rc,
                         capacity=F_CAPACITY)
    runs = {}
    for mode, knobs in I_MODES.items():
        c = dataclasses.replace(cfg, **knobs)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(counters)
        t0 = time.perf_counter()
        with tape.collect() as entries:
            out = serve_with_plans(torch, model, c, batch, F_NEW,
                                   plans[mode], rc=rc, capacity=F_CAPACITY)
        wall = (time.perf_counter() - t0) * 1e3
        got = check_launches(f"traffic I {mode} run", counters, expect[mode])
        rows = tape_rows(tape, entries)
        if mode != "dense":
            bad = [row for row in rows if row[2] != row[3]]
            if bad:
                raise AssertionError(f"traffic I {mode}: executed != counted"
                                     f" at {bad[:3]}")
        if not (torch.isfinite(out["prefill"]).all()
                and all(torch.isfinite(st).all() for st in out["steps"])):
            raise AssertionError(f"traffic I {mode}: non-finite logits")
        share = (f_attention_share(tape, entries, c, s)
                 if c.sparse_kv else None)
        patch = [row for row in rows if row[0] == "conv.patch"]
        r = runs[mode] = dict(out, wall=wall,
                              peak=torch.cuda.max_memory_allocated() / 1e9)
        t = out["times"]
        log(f"traffic I: {cfg.name} ({cfg.n_layers} layers) {mode} on int8 "
            f"{F_CAPACITY}-slot self caches and bf16 {cfg.num_image_tokens}"
            f"-slot cross caches, cached plans: "
            f"{b * F_NEW / wall * 1e3:.2f} tokens/s ({wall:.0f} ms, stats "
            f"tape on), prefill {t[0]:.1f} ms, decode steps median "
            f"{statistics.median(t[1:]):.2f} ms, peak memory "
            f"{r['peak']:.1f} GB, launches {got}; conv.patch steps (dense, "
            f"counted, executed) {[row[1:4] for row in patch]}"
            + ("" if share is None else
               f"; scheduled share of cache-block steps {share[1]:.4f} "
               "(= the positions' occupancy): " + ", ".join(
                   f"{k} {v[0]}/{v[1]}" for k, v in share[0].items()))
            + f"; {smi}")
        if mode == "dense":
            continue
        dense = runs["dense"]
        tol = SERVE_RTOL * dense["prefill"].abs().max().item()
        pre_err = max((r["prefill"][i] - dense["prefill"][i]).abs()
                      .max().item() for i in range(b))
        parted = parted_at(r["tokens"], dense["tokens"])
        dec_err = max([(r["steps"][t][i] - dense["steps"][t][i]).abs()
                       .max().item() for t in range(1, F_NEW)
                       for i in range(b) if t <= parted[i]] or [0.0])
        if not (pre_err <= tol and dec_err <= tol):
            raise AssertionError(
                f"traffic I {mode}: logits differ from dense by "
                f"{pre_err:.4f} (prefill) / {dec_err:.4f} (decode) > "
                f"{tol:.4f}")
        r["first_err"] = (r["steps"][0] - dense["steps"][0]).abs().max().item()
        agree = parting_report(torch, f"traffic I {mode}", r["tokens"],
                               dense["tokens"], dense["steps"], tol)
        log(f"traffic I: {mode} vs dense: max |diff| {pre_err:.4f} "
            f"(prefill), {dec_err:.4f} (decodes while the tokens agree) "
            f"<= {tol:.4f} ({SERVE_RTOL} x max|dense|); " + "; ".join(agree))
        del r["prefill"]
    dense = runs["dense"]
    tol = SERVE_RTOL * dense["prefill"].abs().max().item()
    del dense["prefill"]

    # the image matters: the two requests' images swapped, one dense prefill
    # into fresh int8 caches as in the runs; each row's first-token logits
    # against those of its own image
    c = dataclasses.replace(cfg, **I_MODES["dense"])
    caches = tfm.init_caches(c, b, F_CAPACITY, quantized=True)
    with torch.inference_mode():
        swapped = model({"tokens": batch["tokens"],
                         "images": images.flip(0)}, c, caches=caches,
                        positions=torch.arange(s, device="cuda"), rc=rc
                        ).logits[:, -1].float()
    del caches
    moved = (swapped - dense["steps"][0]).abs().amax(-1).tolist()
    noise = max(r["first_err"] for r in runs.values() if "first_err" in r)
    if not min(moved) > max(tol, 10 * noise):
        raise AssertionError(
            f"traffic I: swapping the images moves the first token's logits "
            f"by {moved} (rows), not more than the tolerance {tol:.4f} and 10 "
            f"x the sparse modes' largest first-token difference {noise:.4f}")
    log(f"traffic I: the images swapped between the requests move each row's "
        f"first-token logits by max |diff| {[round(x, 4) for x in moved]} "
        f"(dense): {min(moved) / tol:.2f}x the tolerance {tol:.4f} "
        f"({SERVE_RTOL} x max|dense|), {min(moved) / max(noise, 1e-30):.1f}x "
        f"the sparse modes' largest first-token difference from dense "
        f"{noise:.4f}")
    del swapped

    # the frontend's and the cross layer's shares of one prefill's device
    # time, by profiler range, dense and dual+kv; the patch conv alone as
    # F.conv2d and F.unfold on the same images
    cross = model.layers[0]
    for mode in ("dense", "dual+kv"):
        c = dataclasses.replace(cfg, **I_MODES[mode])
        caches = tfm.init_caches(c, b, F_CAPACITY, quantized=True)
        with torch.inference_mode():
            total, part = range_shares(torch, lambda: model(
                batch, c, caches=caches,
                positions=torch.arange(s, device="cuda"), rc=rc,
                weight_plans=plans[mode]),
                {(fem, "vision_frontend"): "vlm.frontend",
                 (cross, "forward"): "vlm.cross"})
        del caches
        shares = {lb: f"{ms:.3f} ms ({ms / total:.2%})" if ms else
                  "not measured (no device time in its range)"
                  for lb, ms in part.items()}
        log(f"traffic I: {mode}, one prefill's device time "
            + (f"{total:.2f} ms: the vision frontend "
               f"{shares['vlm.frontend']}, the cross layer "
               f"{shares['vlm.cross']}" if total
               else "not measured (empty trace)") + f"; {smi}")
    w4 = model.frontend.patch.permute(3, 2, 0, 1).contiguous()
    xn = images.permute(0, 3, 1, 2).contiguous()
    ps = cfg.patch_size
    conv_dev = device_ms(torch, lambda: F.conv2d(xn, w4, stride=ps), 5)
    unfold_dev = device_ms(torch, lambda: F.unfold(xn, (ps, ps), stride=ps),
                           5)
    c = dataclasses.replace(cfg, **I_MODES["dual+kv"])
    with torch.inference_mode():
        gemm = record_launches(torch, lambda: fem.vision_frontend(
            model.frontend, images, c, plans=plans["dual+kv"]["frontend"]))
    (src, launches), = gemm.items()
    t = replayed_numbers(torch, src, launches)
    log(f"traffic I: the patch conv alone on the served images: F.conv2d "
        f"(bf16) device {fmt_ms(conv_dev)}, F.unfold device "
        f"{fmt_ms(unfold_dev)}; its GEMM on K1 (dual+kv, cached plan; "
        f"{', '.join(f'{k} x{n}' for k, n in t['shapes'].items())}): device "
        f"{fmt_ms(t['device_ms'])} ({t['ms']:.4f} ms events), bound "
        f"{t['bound_ms']:.4f} ms by {t['bound_by']}, plain "
        f"{t['plain_ms']:.1f} ms, torch.matmul device "
        f"{fmt_ms(t['library_device_ms'])}; {smi}")

    # serve_loop.generate (per-call plans) builds the caches itself and
    # passes the images to the prefill only
    c = dataclasses.replace(cfg, **I_MODES["dual+kv"])
    reset_launches(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = serve_loop.generate(model, batch, c, max_new_tokens=F_NEW,
                               capacity=F_CAPACITY, rc=rc)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    got = check_launches("traffic I dual+kv generate", counters,
                         expect["dual+kv"])
    if not torch.equal(toks.cpu(), runs["dual+kv"]["tokens"]):
        raise AssertionError("traffic I: generate's tokens != the "
                             "cached-plan run's")
    caches = tfm.init_caches(c, b, F_CAPACITY, quantized=True)
    cross_caches = [cc for cc, kind in zip(caches, kinds) if kind == "cross"]
    if not all(type(cc) is kvc.KVCache and not cc.quantized
               and cc.k.dtype == torch.bfloat16
               and cc.capacity == cfg.num_image_tokens
               for cc in cross_caches):
        raise AssertionError("traffic I: a cross cache is not a plain bf16 "
                             f"cache of {cfg.num_image_tokens} slots")
    del caches, cross_caches
    log(f"traffic I: dual+kv through serve_loop.generate (per-call plans, "
        f"rc {VLM} decode_32k): {b * F_NEW / wall * 1e3:.2f} tokens/s "
        f"({wall:.0f} ms), launches {got}, tokens == the cached-plan run's")

    # the engine refuses a cross-attention stack
    try:
        Engine(model, c, serve=ServeConfig(slots=F_PROMPTS,
                                           capacity=F_CAPACITY), rc=rc)
    except ValueError as e:
        log(f"traffic I: Engine refuses the VLM: ValueError({e})")
    else:
        raise AssertionError("traffic I: the Engine took a cross stack")
    torch.cuda.empty_cache()

    # every K1-K4 launch of a cached-plan generate held to its plain walk
    # and replayed (:func:`held_generate`), its K5 and K7 launches held too
    numbers = {}
    for mode, pairs in HELD_KERNELS.items():
        c = dataclasses.replace(cfg, **I_MODES[mode])
        conv_seen = {}

        def run():
            got = held_generate(torch, f"traffic I {mode}", model, c, batch,
                                plans[mode], rc, F_CAPACITY, F_NEW, pairs)
            numbers.update(got)
        conv_seen.update(held_conv(torch, run))
        for kn, src in pairs:
            t = numbers[kn]
            if t["launches"] != expect[mode][kn]:
                raise AssertionError(f"traffic I {mode}: {t['launches']} "
                                     f"{kn} launches replayed, "
                                     f"{expect[mode][kn]} counted")
            kernel_numbers_line(f"traffic I: {mode}", kn, t, smi)
        if [len(v) for v in conv_seen.values()] != [1, 1]:
            raise AssertionError(f"traffic I {mode}: K5/K7 launches held "
                                 f"{ {k: len(v) for k, v in conv_seen.items()} }")
        if mode == "dual+kv":
            for kn, t in conv_numbers(torch, conv_seen).items():
                numbers[kn] = t
                log(f"traffic I: {mode} {kn}: the generate's 1 launch held "
                    f"bit-equal to its plain walk; device "
                    f"{fmt_ms(t['device_ms'])} ({t['ms']:.4f} ms events), "
                    f"bound {t['bound_ms']:.5f} ms by bytes "
                    f"({t['nbytes'] / 1e6:.2f} MB), plain {t['plain_ms']:.2f}"
                    f" ms, " + ("no PyTorch call encodes a bitmap"
                                if kn == "K5" else
                                f"F.unfold device {fmt_ms(t['library_ms'])}")
                    + f"; zero share of the lowered values "
                    f"{t['zero_share']:.3f}; routes (K5; K7) {t['routes']}; "
                    f"{smi}")
        torch.cuda.empty_cache()
    del model, plans, runs
    torch.cuda.empty_cache()
    log(f"traffic I: phase {time.perf_counter() - t_phase:.0f} s")
    return numbers


# ---------------------------------------------------------------------------
# phase 18: tuning and guards — the tuner swept on K1-K4, traffics A and D
# served on its cache, the cost-model tier, fault injection, validators
# ---------------------------------------------------------------------------

T_MAX_CANDIDATES = 4        # cost-model survivors timed per key
T_FAULT_SEED = 0
T_POISONED = 3              # the uid whose decode logits are poisoned


def no_quarantine(what):
    """Raise unless no site is quarantined: on the card only an injected
    fault quarantines a site (a kernel's own error propagates), so outside
    the fault phase a quarantine is a fault that leaked out of it."""
    from repro_torch.sparse import site
    rep = site.quarantine_report()
    if rep:
        raise AssertionError(f"{what}: quarantined sites (a fault raised; "
                             f"its site ran the plain arm): {rep}")


def reset_telemetry():
    """The tuner's hit/miss/stale counters and observed keys to zero,
    its cache kept."""
    from repro_torch.sparse import autotune as atn
    atn.HITS = atn.MISSES = atn.STALE = 0
    atn.OBSERVED.clear()


def telemetry():
    from repro_torch.sparse import autotune as atn
    return dict(hits=atn.HITS, misses=atn.MISSES, stale=atn.STALE)


def capture_lookups(fn):
    """Run ``fn()`` with every tuning-cache lookup logged, in order, and
    the operands of the dispatch call each lookup resolves (the first
    call of each key kept): wraps ``autotune.lookup`` and the dispatch's
    ``matmul``/``grouped_matmul``, which the sites call right after they
    resolve (the decode attention resolves both its products, then runs
    them in the same order).  Returns (lookups, {key: (x, w,
    out_dtype)})."""
    from repro_torch.sparse import autotune as atn
    from repro_torch.sparse import dispatch as dsp
    calls, pending, operands = [], [], {}
    real = (atn.lookup, dsp.matmul, dsp.grouped_matmul)

    def lookup(op, m, n, k, *, dtype, sparsity=None, interpret=False,
               extra=""):
        args = dict(op=op, m=m, n=n, k=k, dtype=atn.dtype_name(dtype),
                    sparsity=sparsity, interpret=interpret, extra=extra)
        key = atn.make_key(op, m, n, k, dtype=dtype, sparsity=sparsity,
                           platform=atn.platform_of(interpret), extra=extra)
        calls.append(dict(args, key=key))
        pending.append(key)
        return real[0](**args)

    def wrap(fn_real):
        def call(x, w, **kw):
            if pending:
                operands.setdefault(pending.pop(0),
                                    (x, w, kw.get("out_dtype")))
            return fn_real(x, w, **kw)
        return call
    atn.lookup = lookup
    dsp.matmul, dsp.grouped_matmul = wrap(real[1]), wrap(real[2])
    try:
        with dsp.warnings_suppressed():
            fn()
    finally:
        atn.lookup, dsp.matmul, dsp.grouped_matmul = real
    return calls, operands


def replayed_telemetry(calls):
    """The hits, misses and stale entries the logged lookups meet on the
    current cache: what the same run must count on it."""
    from repro_torch.sparse import autotune as atn
    reset_telemetry()
    for c in calls:
        args = {k: v for k, v in c.items() if k != "key"}
        atn.lookup(**args)
    got = telemetry()
    reset_telemetry()
    return got


def knob_str(kn):
    return f"{kn['backend']} ({kn['block_m']}, {kn['block_n']}, " \
           f"{kn['slice_k']})"


def sweep_line(row, smi):
    b, t = row["baseline"], row["tuned"]
    note = ("the dense arm (torch.matmul) wins" if t["backend"] == "xla"
            else f"{'K2/K4' if t['backend'] == 'kfused' else 'K1/K3'} wins")
    return (f"tuning: {row['key']} (M={row['m']} N={row['n']} K={row['k']}"
            + (f" E={row['e']}" if "e" in row else "") + f"): baseline "
            f"{knob_str(b)} {b['us']:.1f} us -> {knob_str(t)} "
            f"{t['us']:.1f} us (x{row['speedup']:.2f}; {len(row['sweep'])} "
            f"vectors timed: " + ", ".join(
                f"{knob_str(s)} {s['us']:.0f}" for s in row["sweep"])
            + f"); {note}; {smi}")


def engine_parting(torch, what, model, c, prompts, done, base, tol):
    """Each request of ``done`` against the baseline engine's ``base``
    ({uid: request}): equal tokens, or parting where the baseline's top-2
    logits (its stream fed back at batch 1) are within ``tol``."""
    notes = []
    for uid, req in sorted(done.items()):
        got = torch.tensor([req.output], dtype=torch.int32)
        ref = torch.tensor([base[uid].output], dtype=torch.int32)
        if torch.equal(got, ref):
            notes.append(f"{uid} equal")
            continue
        steps = batch1_stream(torch, model, c, prompts[uid],
                              force=base[uid].output)[1]
        (note,) = parting_report(torch, f"{what} request {uid}", got, ref,
                                 steps, tol)
        notes.append(f"{uid} " + note.split(": ", 1)[1])
    return "; ".join(notes)


def phase_tuning(torch, smi):
    """Phase 18; see the module docstring.  Returns the sweep's rows."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ServeConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    from repro_torch.serving.engine import Engine
    from repro_torch.sparse import autotune as atn
    from repro_torch.sparse import dispatch as dsp
    from repro_torch.sparse import site, tape
    from repro_torch.sparse import validate as val
    from repro_torch.sparse import weights as wts
    from repro_torch.testing import faults
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(ARCH), n_layers=N_LAYERS)
    model = make_model(torch, cfg)
    kept = prune_mlps(torch, model, cfg)
    log(f"tuning: MLPs block-pruned, {statistics.mean(kept):.3f} of their "
        f"tiles kept")
    ca = dataclasses.replace(cfg, **MODES["dual"])            # traffic A
    cd = dataclasses.replace(cfg, **ENGINE_MODES["dual"])     # traffic D
    batch = traffic_a_batch(torch, cfg)
    prompts = traffic_d_prompts(torch, cfg)
    counters = {kn: fn for kn, fn in kernel_counters().items()
                if kn in ("K1", "K2", "K3", "K4")}
    serve = dict(slots=D_SLOTS, capacity=D_CAPACITY)
    atn.reset()

    def gen(c):
        return serve_loop.generate(model, batch, c,
                                   max_new_tokens=NEW_TOKENS).cpu()

    def engine(c, rc=None):
        eng = Engine(model, c, serve=ServeConfig(**serve), rc=rc)
        done, wall, _ = serve_traffic_d(torch, eng, prompts)
        return eng, done, wall

    def timed(fn):
        """(fn(), ms of a second call): the first call warms the path."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {kn: fn.launches for kn, fn in counters.items()}

    # the untuned references: dense and dual generate (dual's logits per
    # step from the script's own loop, which generate's tokens equal),
    # the untuned dual engine with its tape (the sites K1 and K3 run)
    dense_ms = timed(lambda: gen(cfg))[1]
    dual_toks, dual_ms = timed(lambda: gen(ca))
    ref = serve_with_plans(torch, model, ca, batch, NEW_TOKENS, None)
    if not torch.equal(ref["tokens"], dual_toks):
        raise AssertionError("tuning: generate != its own loop (untuned)")
    tol = SERVE_RTOL * ref["prefill"].abs().max().item()
    zero()
    with tape.collect() as entries:
        eng_u, done_u, wall_u = engine(cd)
    st = check_engine_run("tuning: untuned engine", "dual", eng_u, done_u,
                          read(), False)
    kernel_sites = {("attn.score:" if e["name"] == "attn.score" else
                     "attn.value:" if e["name"] == "attn.value" else
                     "matmul:") + e["name"] for e in tape.summarize(entries)}
    del eng_u
    n_tok_a, n_tok_d = PROMPTS * NEW_TOKENS, D_NEW * len(prompts)

    # 1. discover the keys: the engine's own discovery pass, then one
    # served pass of each traffic on an empty cache, capturing the
    # operands of every key it consults
    t0 = time.perf_counter()
    eng = Engine(model, cd, serve=ServeConfig(**serve))
    found = eng.autotune_keys(prompt_len=PROMPT_LEN, decode_steps=1)
    del eng
    atn.reset()
    calls_a, ops_a = capture_lookups(
        lambda: gen(dataclasses.replace(ca, sparse_autotune=True)))
    calls_d, ops_d = capture_lookups(
        lambda: engine(dataclasses.replace(cd, sparse_autotune=True)))
    operands = {**ops_a, **ops_d}
    consulted = list(dict.fromkeys(c["key"] for c in calls_a + calls_d))
    if set(consulted) != set(operands):
        raise AssertionError(f"tuning: keys without operands: "
                             f"{sorted(set(consulted) - set(operands))}")
    log(f"tuning: Engine.autotune_keys ({D_SLOTS} slots x {D_CAPACITY}, a "
        f"{PROMPT_LEN}-token prompt, 1 decode step) finds {len(found)} "
        f"keys ({sum('|m1|' in k for k in found)} decode at M = 1, "
        f"{sum('|attn.' in k for k in found)} attention); the served passes "
        f"(traffic A through generate, traffic D through the engine) consult "
        f"{len(consulted)} keys in {len(calls_a)} + {len(calls_d)} lookups, "
        f"{len(set(found) & set(consulted))} of them among autotune_keys'; "
        f"{(time.perf_counter() - t0):.1f} s")

    # 2. sweep every consulted key on the card (K1/K2 for the matmuls at
    # the cost model's best vectors and the kfused twin of its pick,
    # K3/K4 for the decode attention over the block_t lattice)
    atn.reset()
    zero()
    base = atn.knobs_from_config(cd)
    rows = []
    t0 = time.perf_counter()
    for key in consulted:
        op = key.split("|")[2]
        if op.startswith("attn."):
            continue
        x, w, out_dtype = operands[key]
        xv, wv = dsp._values(x), dsp._weight_array(w)
        m, k, n = xv.shape[:-1].numel(), xv.shape[-1], wv.shape[-1]
        top = atn.candidates(m, n, k, dtype_bytes=2, max_candidates=1)[0]
        rows.append(atn.tune_matmul(
            x, w, mode="dual", baseline=base, out_dtype=out_dtype,
            max_candidates=T_MAX_CANDIDATES,
            include=(top._replace(backend="kfused"),)))
        if rows[-1]["key"] != key:
            raise AssertionError(f"tuning: swept {rows[-1]['key']} for "
                                 f"{key}")
    attn_keys = [k for k in consulted if "|attn." in k]
    fill = int(statistics.mean(D_PROMPT_LENS)) + D_NEW // 2
    attn_rows = atn.tune_attn(cd, batch=D_SLOTS, capacity=D_CAPACITY,
                              fill=fill, dtype=torch.bfloat16,
                              max_candidates=T_MAX_CANDIDATES,
                              also=("kfused",))
    # tune_attn files its winners under the sweep's sparsity bucket and
    # mirrors them into 'any', which the engine's lookups (no hint) read
    if not all(atn.get_cache().get(k) for k in attn_keys):
        raise AssertionError(f"tuning: tune_attn ({[r['key'] for r in
                             attn_rows]}) left the engine's {attn_keys} "
                             f"unfilled")
    rows.extend(attn_rows)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    swept = read()
    if not all(swept.values()):
        raise AssertionError(f"tuning: the sweep launched {swept}")
    for r in rows:
        log(sweep_line(r, smi))
    path = atn.save_cache(atn.default_cache_path(str(ROOT)))
    wins = {b: sum(r["tuned"]["backend"] == b for r in rows)
            for b in atn.BACKENDS}
    log(f"tuning: {len(rows)} keys swept in {sweep_s:.1f} s (card timer: "
        f"the whole dispatch call, planning included, median of 3 after a "
        f"warm-up); launches in the sweep {swept}; winners {wins}; cache "
        f"saved to {Path(path).relative_to(ROOT)}; {smi}")

    # 3. the saved cache, checked against the card's knobs_valid
    checked = val.check_tuning_cache(atn.TuningCache().load(path))
    log(f"tuning: check_tuning_cache: {len(checked)} entries valid on the "
        f"card's rules")

    # 4. serve on the tuned cache, then on its kernel arm: each key's
    # fastest K1/K2 (K3/K4) vector of the sweep, so that the served runs
    # launch the kernels at the swept knobs
    karm = atn.TuningCache()
    for r in rows:
        best = min((v for v in r["sweep"] if v["backend"] != "xla"),
                   key=lambda v: v["us"])
        atn.record(r["op"], r["m"], r["n"], r["k"], dtype=r["dtype"],
                   sparsity=r["sparsity"], knobs=atn.Knobs(
                       best["backend"], best["block_m"], best["block_n"],
                       best["slice_k"]), us=best["us"],
                   baseline_us=r["baseline"]["us"],
                   extra=f"e{atn.bucket_dim(r['e'])}" if "e" in r else "",
                   cache=karm, platform="cuda")
    kpath = karm.save(str(Path(path).with_name("autotune_cache_kernels.json")))
    val.check_tuning_cache(karm)
    served = {}
    for label, cache_path in (("tuned", path), ("kernel arm", kpath)):
        ta = dataclasses.replace(ca, sparse_autotune=True,
                                 sparse_tune_cache=cache_path)
        td = dataclasses.replace(cd, sparse_autotune=True,
                                 sparse_tune_cache=cache_path)
        atn.reset()
        atn.load_cache(cache_path)
        want_a = replayed_telemetry(calls_a)
        zero()
        with tape.collect() as entries:
            toks = gen(ta)
        got_a, launches_a = telemetry(), read()
        if got_a != want_a:
            raise AssertionError(f"tuning: {label}: traffic A lookups "
                                 f"{got_a}, the cache predicts {want_a}")
        rows_a = tape.summarize(entries)
        kern = sum(launches_a.values())
        on_kernel = sum(e["executed_steps"] == e["sparse_steps"]
                        < e["dense_steps"] for e in rows_a)
        bad = [e for e in rows_a
               if e["executed_steps"] not in (e["sparse_steps"],
                                              e["dense_steps"])]
        if bad or (label == "kernel arm" and (
                kern != PROJ_PER_FORWARD * NEW_TOKENS or any(
                    e["executed_steps"] != e["sparse_steps"]
                    for e in rows_a))):
            raise AssertionError(f"tuning: {label}: launches {launches_a}, "
                                 f"executed != counted at {bad[:3]}")
        note = "; ".join(parting_report(torch, label, toks, ref["tokens"],
                                        ref["steps"], tol))
        ms = timed(lambda: gen(ta))[1]
        held = held_to_plain(torch, None, lambda: gen(ta))
        n_held = sum(h["n"] for h in held.values())
        if n_held != kern:
            raise AssertionError(f"tuning: {label}: {n_held} launches held, "
                                 f"{launches_a} counted")
        log(f"tuning: {label}: traffic A through generate: lookups {got_a} "
            f"as the cache predicts; launches {launches_a}; {len(rows_a)} "
            f"tape entries, each executing what it counts ({on_kernel} "
            f"skipping on a kernel, the rest dense); tokens against untuned "
            f"dual: {note} (tol {tol:.4f}); every launch of a second "
            f"generate held to its plain walk: " + (", ".join(
                f"{src} {h['n']} max |kernel - plain| {h['err']:.3e}"
                for src, h in sorted(held.items())) or "none launched (the "
                "dense arm won every key traffic A consults)") + f"; {smi}")
        want_d = replayed_telemetry(calls_d)
        zero()
        with tape.collect() as entries:
            eng_t, done_t, wall_t = engine(td)
        got_d, launches_d = telemetry(), read()
        if got_d != want_d:
            raise AssertionError(f"tuning: {label}: traffic D lookups "
                                 f"{got_d}, the cache predicts {want_d}")
        bad = [e for e in tape.summarize(entries)
               if e["executed_steps"] not in (e["sparse_steps"],
                                              e["dense_steps"])]
        st_t = eng_t.stats()
        short = [u for u, r in done_t.items()
                 if len(r.output) != D_NEW or r.status != "done"]
        if bad or short or st_t["pages_free"] != st_t["pages_total"]:
            raise AssertionError(f"tuning: {label} engine: {short} short, "
                                 f"{st_t}, executed != counted at "
                                 f"{bad[:3]}")
        if label == "kernel arm":
            proj = PROJ_PER_FORWARD * (st_t["prefill_calls"]
                                       + st_t["decode_calls"])
            grouped = 2 * N_LAYERS * st_t["decode_calls"]
            if (launches_d["K1"] + launches_d["K2"] != proj
                    or launches_d["K3"] + launches_d["K4"] != grouped):
                raise AssertionError(f"tuning: kernel arm engine launches "
                                     f"{launches_d}, expected {proj} K1/K2 "
                                     f"and {grouped} K3/K4")
        del eng_t
        note_d = engine_parting(torch, f"{label} engine", model, cd, prompts,
                                done_t, done_u, tol)
        log(f"tuning: {label}: traffic D through the engine: lookups {got_d} "
            f"as the cache predicts; launches {launches_d}; tokens against "
            f"the untuned engine: {note_d}; {smi}")
        served[label] = (ms, wall_t)
    log(f"time: tuning: traffic A generate, {n_tok_a} tokens: dense "
        f"{n_tok_a / dense_ms * 1e3:.2f} tokens/s, untuned dual "
        f"{n_tok_a / dual_ms * 1e3:.2f}, " + ", ".join(
            f"{label} {n_tok_a / ms * 1e3:.2f}"
            for label, (ms, _) in served.items())
        + f" (the second of two calls each, stats tape off); traffic D "
        f"engine, {n_tok_d} tokens: untuned dual "
        f"{n_tok_d / wall_u * 1e3:.2f} tokens/s, " + ", ".join(
            f"{label} {n_tok_d / w * 1e3:.2f}"
            for label, (_, w) in served.items())
        + f" (one run each on a warm path, stats tape on); a record, no "
        f"claim; sweep {sweep_s:.1f} s; {smi}")

    # 5. the cost-model tier on an empty cache
    atn.reset()
    cm = dataclasses.replace(ca, sparse_costmodel=True)
    picked, real_resolve = {}, site.resolve

    def resolve(st, c, **geo):
        kw = real_resolve(st, c, **geo)
        picked.setdefault(st.name, (geo["m"], geo["n"], geo["k"],
                                    kw["use_kernel"], kw.get("condense"),
                                    kw["block_m"], kw["block_n"],
                                    kw["slice_k"]))
        return kw
    site.resolve = resolve
    try:
        cm_toks = gen(cm)
    finally:
        site.resolve = real_resolve
    note = "; ".join(parting_report(torch, "cost model", cm_toks,
                                    ref["tokens"], ref["steps"], tol))
    log("tuning: cost-model tier (sparse_costmodel, empty cache), traffic "
        "A: " + "; ".join(
            f"{name} at (M={m}, N={n}, K={k}) -> "
            f"{'K2' if cond else 'K1' if uk else 'dense arm'} "
            f"({bm}, {bn}, {sk})"
            for name, (m, n, k, uk, cond, bm, bn, sk) in picked.items())
        + f"; tokens against untuned dual: {note}")
    no_quarantine("tuning: tuned and cost-model runs")

    # 6. faults: traffic D under the whole seeded fault matrix
    with faults.chaos(T_FAULT_SEED, poisoned_uids={T_POISONED}) as inst:
        eng_f, done_f, _ = engine(cd)
    quarantined = set(site.quarantine_report())
    if quarantined != kernel_sites:
        raise AssertionError(f"faults: quarantined {sorted(quarantined)}, "
                             f"the sites that ran K1 and K3 "
                             f"{sorted(kernel_sites)}")
    bad_req = done_f[T_POISONED]
    if (bad_req.status, bad_req.error) != ("error", "nonfinite_logits"):
        raise AssertionError(f"faults: poisoned request {bad_req.status} "
                             f"{bad_req.error}")
    others = {u: r for u, r in done_f.items() if u != T_POISONED}
    short = [u for u, r in others.items()
             if len(r.output) != D_NEW or r.status != "done"]
    if short:
        raise AssertionError(f"faults: requests {short} did not finish")
    note_f = engine_parting(torch, "faults", model, cd, prompts, others,
                            done_u, tol)
    fired = {k: f.fired for k, f in inst.items()}
    st_f = eng_f.stats()
    del eng_f
    site.clear_quarantine()
    log(f"faults: traffic D under faults.chaos({T_FAULT_SEED}) (kernel "
        f"faults at rate 1.0, page_alloc 0.25, preemption_storm 0.2, uid "
        f"{T_POISONED} poisoned): fired {fired}; quarantined exactly the "
        f"{len(kernel_sites)} sites that ran K1 and K3 "
        f"({', '.join(sorted(kernel_sites))}); uid {T_POISONED} retired "
        f"error/nonfinite_logits; the others against the fault-free "
        f"engine: {note_f}; evictions {st_f['evictions']}, ticks "
        f"{st_f['ticks']}; quarantine cleared; {smi}")

    # 7. validators: every tick of traffic D validated, then broken copies
    ticks = []
    real_validate = Engine.validate_state

    def validate_state(self):
        ticks.append(self.ticks)
        real_validate(self)
    Engine.validate_state = validate_state
    try:
        with val.enabled_within(True):
            eng_v, done_v, _ = engine(cd, rc=RunConfig(validate=True))
    finally:
        Engine.validate_state = real_validate
    if ticks != list(range(1, eng_v.ticks + 1)):
        raise AssertionError(f"validate: {len(ticks)} checks over "
                             f"{eng_v.ticks} ticks")
    pw = wts.plan_weight(model.layers[0].mlp.w_up, slice_k=cfg.sparse_slice_k)
    val.check_planned_weight(pw, values=True)
    broken = dataclasses.replace(pw, slice_act=torch.zeros_like(pw.slice_act))
    raised = []
    try:
        val.check_planned_weight(broken, values=True)
    except val.ValidationError as e:
        raised.append(str(e))
    pool = next(c for c in eng_v.caches if hasattr(c, "table"))
    val.check_paged_kv(pool, table=eng_v.table_host)
    table = eng_v.table_host.copy()
    table[0, 0] = table[1, 0] = 1
    try:
        val.check_paged_kv(pool, table=table)
    except val.ValidationError as e:
        raised.append(str(e))
    if len(raised) != 2:
        raise AssertionError(f"validate: broken copies raised {raised}")
    del eng_v, pw, broken
    log(f"validate: traffic D with RunConfig(validate=True) and the "
        f"dispatch boundary checks on: {len(ticks)} ticks validated, no "
        f"ValidationError; a PlannedWeight with its slice activity zeroed "
        f"raises ({raised[0]}); a block table mapping page 1 twice raises "
        f"({raised[1]})")
    no_quarantine("tuning: validators")
    atn.reset()
    del model, operands, ops_a, ops_d
    torch.cuda.empty_cache()
    log(f"tuning: phase {time.perf_counter() - t_phase:.0f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 19: training on one device, traffic J
# ---------------------------------------------------------------------------

# every family the port serves: one float32 train step of its smoke model
# on the card against the CPU
TRAIN_ARCHS = ("chatglm3-6b", "nemotron-4-340b", "qwen1.5-110b", "yi-34b",
               "mixtral-8x7b", "qwen3-moe-235b-a22b", "mamba2-370m",
               "jamba-1.5-large-398b", "whisper-base", "llama-3.2-vision-90b")
# traffic J, a pretraining step: full-width chatglm3-6b cut to J_LAYERS of
# its 28 layers (the whole model's float32 masters, two Adam moments and
# the accumulator, 16 bytes a parameter, would not fit 80 GB) under its
# train_4k run config (8 microbatches, adamw, a float32 accumulator, bf16
# compute copies, remat "full"), J_BATCH sequences of J_SEQ tokens (the
# run config's global batch of 256 cut to one sequence a microbatch); one
# warm-up step, then J_STEPS timed ones
J_ARCH = "chatglm3-6b"
J_LAYERS, J_BATCH, J_SEQ, J_STEPS = 4, 8, 4096, 5
# the trained model served: J_PROMPTS prompts of J_PROMPT_LEN tokens from
# a batch of the training stream it never trained on, J_NEW new tokens
J_PROMPTS, J_PROMPT_LEN, J_NEW, J_SERVE_STEP = 2, 32, 4, 1000
# the crash-restart run: tests/test_system.py's setup on the card
R_STEPS, R_CRASH = 6, 3


def train_smoke(torch):
    """Phase 19 (a): one float32 train step of every family's smoke model
    on the card against the CPU (random qkv biases and VLM gates)."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import model_zoo
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl
    rc = RunConfig(microbatches=2, learning_rate=1e-3, warmup_steps=2,
                   act_dtype="float32")
    counters = kernel_counters()
    reset_launches(counters)
    rows = []
    for arch in TRAIN_ARCHS:
        t0 = time.perf_counter()
        cfg = smoke_config(arch)
        cpu = model_zoo.build_model(cfg, 0, device="cpu")
        seed_biases(torch, cpu, torch.Generator().manual_seed(4))
        seed_gates(torch, cpu, torch.Generator().manual_seed(5))
        gpu = copy.deepcopy(cpu).to("cuda")
        batch = {k: torch.from_numpy(v) for k, v in SyntheticTokens(
            cfg.vocab_size, 4, 16, seed=0).batch_at(0).items()}
        batch.update(model_zoo.frontend_inputs(cfg, 4, dtype=torch.float32,
                                               device="cpu"))
        gbatch = {k: v.cuda() for k, v in batch.items()}
        grad_fn = tl.make_grad_fn(cfg, rc)
        g_cpu, _ = grad_fn(cpu.requires_grad_(True), batch)
        g_gpu, _ = grad_fn(gpu.requires_grad_(True), gbatch)
        gmax = max(g.abs().max().item() for g in g_cpu.values())
        err = max((g_gpu[n].cpu() - g).abs().max().item()
                  for n, g in g_cpu.items())
        if not err <= 1e-4 * gmax:
            raise AssertionError(f"training: {arch}-smoke gradients on the "
                                 f"card vs the CPU: {err} > 1e-4 x {gmax}")
        step = tl.make_train_step(cfg, rc)
        m_cpu = step(cpu, opt.init_opt_state(dict(cpu.named_parameters()),
                                             rc), None, batch)[3]
        m_gpu = step(gpu, opt.init_opt_state(dict(gpu.named_parameters()),
                                             rc), None, gbatch)[3]
        loss, gn = m_gpu["loss"].item(), m_gpu["grad_norm"].item()
        if not (torch.isfinite(m_gpu["loss"]).item() and gn > 0):
            raise AssertionError(f"training: {arch}-smoke step loss {loss}, "
                                 f"grad_norm {gn}")
        rows.append(f"{arch} loss {loss:.4f} (CPU {m_cpu['loss'].item():.4f}"
                    f"), grad_norm {gn:.4f} (CPU "
                    f"{m_cpu['grad_norm'].item():.4f}), max |grad diff| "
                    f"{err / gmax:.1e} x max|g| in "
                    f"{time.perf_counter() - t0:.1f} s")
    check_launches("training, smoke steps", counters, {})
    log(f"training (a): one float32 train step (2 microbatches of 2 x 16 "
        f"tokens, adamw, remat full, TF32 off) of each family's smoke model "
        f"on the card == the CPU's, gradients within 1e-4 x max|g|, no "
        f"kernel launched: " + "; ".join(rows))


def train_traffic_j(torch, smi):
    """Phase 19 (b) and (c): traffic J's steps under the three remat
    modes, the eval step, then the trained weights served in bf16 through
    ``generate`` and the cached-plan loop (K1, K2).  Returns {K-name:
    numbers} of the held cached-plan runs."""
    from repro_torch.configs import get_config, get_run_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import roofline
    from repro_torch.models import model_zoo
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(J_ARCH), n_layers=J_LAYERS)
    rc = get_run_config(J_ARCH, "train_4k")
    if (rc.microbatches, rc.optimizer, rc.accum_dtype, rc.act_dtype,
            rc.remat) != (8, "adamw", "float32", "bfloat16", "full"):
        raise AssertionError(f"{J_ARCH} train_4k run config {rc}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = model_zoo.build_model(cfg, 0)
    ostate = opt.init_opt_state(dict(model.named_parameters()), rc)
    torch.cuda.synchronize()
    n_params = tfm.count_params(model)
    log(f"traffic J: {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, d_ff "
        f"{cfg.d_ff} {cfg.mlp_type}, vocab {cfg.vocab_size}, qkv bias, "
        f"rope {cfg.rope_style}), {J_LAYERS} of 28 layers: "
        f"{n_params / 1e9:.3f} B parameters, float32 masters and moments "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    data = SyntheticTokens(cfg.vocab_size, J_BATCH, J_SEQ, seed=0)
    tokens = J_BATCH * J_SEQ
    flops = roofline.model_flops(tfm.active_params(cfg, model), tokens,
                                 "train")
    # the input embedding is a gather and does no matmul work; a tied head
    # does
    embed = 0 if cfg.tie_embeddings else model.embed.numel()
    flops_mm = roofline.model_flops(tfm.active_params(cfg, model) - embed,
                                    tokens, "train")
    counters = kernel_counters()
    reset_launches(counters)

    def batch_at(i):
        return {k: torch.from_numpy(v).cuda()
                for k, v in data.batch_at(i).items()}

    def timed(step, i):
        batch = batch_at(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        _, _, _, m = step(model, ostate, None, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        m = {k: v.item() for k, v in m.items()}
        if not (m["loss"] == m["loss"] and abs(m["loss"]) < float("inf")):
            raise AssertionError(f"traffic J step {i}: loss {m['loss']}")
        return m, dt, torch.cuda.max_memory_allocated() / 1e9

    step = tl.make_train_step(cfg, rc)
    runs = [timed(step, 0)]
    for i in range(1, J_STEPS + 1):
        if i == J_STEPS:
            # the eval step on the last batch, at the parameters the last
            # step starts from, outside its timing and peak memory
            eval_loss = tl.make_eval_step(cfg, rc)(model,
                                                   batch_at(i))["loss"]
            eval_loss = eval_loss.item()
        runs.append(timed(step, i))
    times = [dt for _, dt, _ in runs[1:]]
    med = statistics.median(times)
    peak = max(p for _, _, p in runs[1:])
    last = runs[-1][0]["loss"]
    if not abs(eval_loss - last) <= 1e-4 * abs(last):
        raise AssertionError(f"traffic J: eval loss {eval_loss} != the last "
                             f"step's {last}")
    share = flops / med / roofline.PEAK_FLOPS
    log(f"traffic J: remat full, {J_BATCH} x {J_SEQ} tokens a step in "
        f"{rc.microbatches} microbatches: step median {med * 1e3:.1f} ms "
        f"over {J_STEPS} (" + ", ".join(f"{t * 1e3:.1f}" for t in times)
        + f"; warm-up {runs[0][1] * 1e3:.0f} ms), {tokens / med:.0f} "
        f"tokens/s, 6 N D = {flops / 1e12:.1f} TFLOP a step, "
        f"{flops / med / 1e12:.1f} TFLOP/s = {share:.1%} of 989 TFLOP/s "
        f"(N {tfm.active_params(cfg, model) / 1e9:.3f} B counts the input "
        f"embedding; without its {embed / 1e9:.3f} B, "
        f"{flops_mm / 1e12:.1f} TFLOP a step, "
        f"{flops_mm / med / roofline.PEAK_FLOPS:.1%}); peak memory {peak:.1f} GB; losses "
        + ", ".join(f"{m['loss']:.4f}" for m, _, _ in runs)
        + f", grad_norm {runs[-1][0]['grad_norm']:.3f}, lr "
        f"{runs[-1][0]['lr']:.3g}; eval step on the last batch {eval_loss:.4f}"
        f" (the step's {last:.4f}, |diff| {abs(eval_loss - last):.2e}); "
        f"{smi}")
    j = dict(step_ms=med * 1e3, tokens_per_s=tokens / med, peak_share=share,
             peak_share_no_embed=flops_mm / med / roofline.PEAK_FLOPS,
             peak_gb=peak, flops=flops)
    for remat in ("none", "dots"):
        m, dt, p = timed(tl.make_train_step(
            cfg, dataclasses.replace(rc, remat=remat)), J_STEPS + 1)
        j[remat] = dict(step_ms=dt * 1e3, peak_gb=p)
        log(f"traffic J: remat {remat}, one step {dt * 1e3:.1f} ms "
            f"({tokens / dt:.0f} tokens/s, {flops / dt / 1e12:.1f} TFLOP/s)"
            f", peak memory {p:.1f} GB, loss {m['loss']:.4f}; {smi}")
    check_launches("traffic J training", counters, {})

    # (c) the trained masters cast to bf16 and served
    del ostate
    model.requires_grad_(False).to(torch.bfloat16)
    torch.cuda.empty_cache()
    prompts = batch_at(J_SERVE_STEP)["tokens"][:J_PROMPTS, :J_PROMPT_LEN]
    batch = {"tokens": prompts}
    per_forward = stack_launches(cfg)[0]
    expect = {"dense": {}, "dual": {"K1": per_forward * J_NEW},
              "dual+kc": {"K2": per_forward * J_NEW}}
    served, plans = {}, {}
    for mode, knobs in MODES.items():
        c = dataclasses.replace(cfg, **knobs)
        plans[mode] = tfm.plan_weight_activities(model, c)
        reset_launches(counters)
        t0 = time.perf_counter()
        toks = serve_loop.generate(model, batch, c, max_new_tokens=J_NEW)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = check_launches(f"traffic J {mode} generate", counters,
                             expect[mode])
        reset_launches(counters)
        r = served[mode] = serve_with_plans(torch, model, c, batch, J_NEW,
                                            plans[mode])
        check_launches(f"traffic J {mode} cached plans", counters,
                       expect[mode])
        if not torch.equal(toks.cpu(), r["tokens"]):
            raise AssertionError(f"traffic J {mode}: generate's tokens != "
                                 "the cached-plan run's")
        line = (f"traffic J: the trained weights in bf16, {mode} through "
                f"generate ({wall:.0f} ms, launches {got}) and on cached "
                "plans, the same tokens")
        if mode != "dense":
            dense = served["dense"]
            tol = SERVE_RTOL * dense["prefill"].abs().max().item()
            err = (r["prefill"] - dense["prefill"]).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"traffic J {mode}: prefill logits "
                                     f"differ from dense by {err} > {tol}")
            line += (f"; prefill logits within {err:.4f} of dense (<= "
                     f"{tol:.4f}); " + "; ".join(parting_report(
                         torch, f"traffic J {mode}", r["tokens"],
                         dense["tokens"], dense["steps"], tol)))
        log(line)
    numbers = {}
    for mode, kn, src in (("dual", "K1", "bitmap_spgemm.cu"),
                          ("dual+kc", "K2", "bitmap_spgemm_kfused.cu")):
        c = dataclasses.replace(cfg, **MODES[mode])
        got = held_generate(torch, f"traffic J {mode}", model, c, batch,
                            plans[mode], None, None, J_NEW, ((kn, src),))
        t = numbers[kn] = got[kn]
        if t["launches"] != expect[mode][kn]:
            raise AssertionError(f"traffic J: {t['launches']} {kn} launches "
                                 f"held, {expect[mode][kn]} counted")
        kernel_numbers_line(f"traffic J: {mode}", kn, t, smi)
    del model, plans, served
    torch.cuda.empty_cache()
    log(f"traffic J: phase {time.perf_counter() - t_phase:.0f} s")
    return numbers, j


def train_restart_child(workdir):
    """The crash-restart run of phase 19 (d), in a process of its own whose
    CUDA is deterministic (``torch.use_deterministic_algorithms`` here,
    ``CUBLAS_WORKSPACE_CONFIG`` from the parent, before cuBLAS first runs):
    tests/test_system.py's chatglm3-6b-smoke setup with a checkpoint after
    every step, uninterrupted and crashed before step ``R_CRASH`` then
    resumed.  Prints one JSON line."""
    import torch
    torch.use_deterministic_algorithms(True)
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import model_zoo
    from repro_torch.training import optimizer as opt
    from repro_torch.training.fault_tolerance import CheckpointManager
    from repro_torch.training.train_loop import (load_state,
                                                 make_train_step, state_tree)
    cfg = smoke_config("chatglm3-6b")
    rc = RunConfig(microbatches=2, learning_rate=1e-3, warmup_steps=2)

    def run(name, crash_at=None):
        model = model_zoo.build_model(cfg, 0)
        ostate = opt.init_opt_state(dict(model.named_parameters()), rc)
        step = make_train_step(cfg, rc)
        data = SyntheticTokens(cfg.vocab_size, 8, 16, seed=0)
        mgr = CheckpointManager(str(Path(workdir) / name), keep=2,
                                async_save=False)
        restored = mgr.restore_latest(state_tree(model, ostate))
        start = 0
        if restored is not None:
            ostate, start = load_state(model, restored[0]), \
                restored[1]["step"]
        losses = {}
        for i in range(start, R_STEPS):
            if i == crash_at:
                raise RuntimeError("injected node failure")
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in data.batch_at(i).items()}
            model, ostate, _, m = step(model, ostate, None, batch)
            losses[i] = m["loss"].item()
            mgr.save(i + 1, state_tree(model, ostate))
        mgr.wait()
        return model, losses, start

    ref, ref_losses, _ = run("ref")
    try:
        run("ft", crash_at=R_CRASH)
        raise AssertionError("the injected crash did not happen")
    except RuntimeError:
        pass
    ft, ft_losses, start = run("ft")
    pairs = list(zip(ref.parameters(), ft.parameters()))
    print(json.dumps(dict(
        start=start, steps=sorted(ft_losses),
        losses=[ref_losses[s] for s in sorted(ft_losses)],
        loss_rel_err=max(abs(ft_losses[s] - ref_losses[s])
                         / abs(ref_losses[s]) for s in ft_losses),
        param_err=max((a - b).abs().max().item() for a, b in pairs),
        bitwise=all(ft_losses[s] == ref_losses[s] for s in ft_losses)
        and all(torch.equal(a, b) for a, b in pairs))), flush=True)
    return 0


def train_launcher_runs(ckpt_dir):
    """Phase 19 (e): the training launcher twice on the smoke config; the
    second run resumes at its last step and trains nothing.  Returns the
    two runs' output lines."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "chatglm3-6b", "--smoke", "--steps", "20", "--ckpt-every", "10",
           "--ckpt-dir", str(ckpt_dir)]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    outs = []
    for _ in range(2):
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                           env=env)
        if r.returncode:
            raise AssertionError(f"launcher failed:\n{r.stderr[-3000:]}")
        outs.append(r.stdout.strip().splitlines())
    first, second = outs
    if not (first[0].startswith("step    0  loss")
            and first[1].startswith("step   10  loss")
            and first[-1] == "training complete"
            and second == ["resumed from step 20", "training complete"]
            and sorted(os.listdir(ckpt_dir)) == ["step_00000010",
                                                 "step_00000020"]):
        raise AssertionError(f"launcher: {first} / {second}")
    return first, second


def train_restart_and_launcher(torch):
    """Phase 19 (d) and (e): the deterministic crash-restart in a child
    process, the training launcher twice (the second run resumes at its
    last step and trains nothing), and a train step through K1 refused."""
    import os
    import shutil
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model_zoo
    from repro_torch.sparse import site
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl
    work = ROOT / "build" / "repro_torch" / "training"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    # the restart child runs beside the launcher's runs (its own process,
    # its own deterministic CUDA context)
    child = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--train-restart",
         str(work / "restart")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    try:
        launched = train_launcher_runs(work / "launch")
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    if child.returncode:
        raise AssertionError(f"training restart: child failed:\n"
                             f"{stderr[-3000:]}")
    res = json.loads(stdout.strip().splitlines()[-1])
    if not (res["start"] == R_CRASH and res["steps"] == list(
            range(R_CRASH, R_STEPS)) and res["loss_rel_err"] <= 1e-5
            and res["param_err"] <= 1e-6):
        raise AssertionError(f"training restart: {res}")
    log(f"training (d): chatglm3-6b-smoke, 2 microbatches of 4 x 16 tokens, "
        f"lr 1e-3, warmup 2, a checkpoint a step, crashed before step "
        f"{R_CRASH} and resumed there: losses of steps {res['steps']} "
        + ", ".join(f"{x:.6f}" for x in res["losses"])
        + f", relative difference {res['loss_rel_err']:.1e} (<= 1e-5), "
        f"parameters within {res['param_err']:.1e} (<= 1e-6) of the "
        f"uninterrupted run; bitwise equal: {res['bitwise']} (deterministic "
        f"CUDA, CUBLAS_WORKSPACE_CONFIG=:4096:8)")
    first, second = launched
    log(f"training (e): python -m repro_torch.launch.train --arch "
        f"chatglm3-6b --smoke --steps 20 --ckpt-every 10 on the card: "
        f"{first[0].strip()} | {first[1].strip()} | {first[-1]}; run again: "
        f"{' | '.join(second)}; (d) and (e) "
        f"{time.perf_counter() - t0:.0f} s")

    cfg = dataclasses.replace(smoke_config("nemotron-4-340b"), **MODES["dual"])
    rc = RunConfig(act_dtype="float32")
    model = model_zoo.build_model(cfg, 0)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), device="cuda")
    counters = kernel_counters()
    reset_launches(counters)
    try:
        tl.make_train_step(cfg, rc)(
            model, opt.init_opt_state(dict(model.named_parameters()), rc),
            None, {"tokens": toks, "labels": toks})
        raise AssertionError("a train step through K1 did not raise")
    except NotImplementedError as e:
        refused = str(e)
    check_launches("training guard", counters, {})
    no_quarantine("training guard")
    log(f"training (e): a train step in dual mode with the kernel raises "
        f"NotImplementedError ({refused}); no launch, no site quarantined")


def phase_training(torch, smi):
    """Phase 19 (see the module docstring).  Returns ({K-name: numbers} of
    the trained model's held cached-plan runs, traffic J's numbers)."""
    t_phase = time.perf_counter()
    train_smoke(torch)
    no_quarantine("training, smoke")
    numbers, j = train_traffic_j(torch, smi)
    no_quarantine("traffic J")
    train_restart_and_launcher(torch)
    log(f"training: phase {time.perf_counter() - t_phase:.0f} s")
    return numbers, j


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    if sys.argv[1:2] == ["--train-restart"]:
        return train_restart_child(sys.argv[2])
    from repro_torch.configs import get_config

    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build()
    cfg = dataclasses.replace(get_config(ARCH), n_layers=N_LAYERS)
    err, totals = phase_kernels(torch, cfg)
    no_quarantine("kernels")
    g_err, g_totals = phase_grouped(torch, cfg)
    no_quarantine("grouped kernels")
    err.update(g_err)
    totals.update(g_totals)
    c_totals = phase_conv_kernels(torch)
    no_quarantine("conv kernels")
    totals.update(c_totals)
    phase_reference(torch)
    phase_reference_whisper(torch)
    no_quarantine("reference")
    model = make_model(torch, cfg)
    launches, walls = phase_serving(torch, cfg, model)
    no_quarantine("serving")
    kv_launches, kv_walls, _ = phase_serving_kv(torch, cfg, model)
    no_quarantine("serving, sparse KV")
    proj = 13 * NEW_TOKENS
    phase_pruned(torch, "traffic A", cfg, model, traffic_a_batch(torch, cfg),
                 NEW_TOKENS, {"dense": {}, "dual": {"K1": proj},
                              "dual+kc": {"K2": proj}})
    no_quarantine("pruned serving, traffic A")
    phase_engine(torch, cfg, model, smi)
    no_quarantine("engine, traffic D")
    del model
    torch.cuda.empty_cache()
    phase_attention_split(torch, cfg)
    wcfg = get_config(WHISPER)
    wmodel, w_launches, w_walls, w_times = phase_serving_whisper(torch, wcfg)
    phase_conv_split(torch, wcfg, wmodel)
    no_quarantine("serving, whisper")
    n1, conv = whisper_k1_launches(wcfg), {"K5": 2, "K6": 1, "K7": 1}
    phase_pruned(torch, "traffic C", wcfg, wmodel, whisper_batch(torch, wcfg),
                 W_NEW, {"dense": {}, "dual": {"K1": n1, **conv},
                         "dual+kc": {"K2": n1, **conv}})
    no_quarantine("pruned serving, traffic C")
    del wmodel
    torch.cuda.empty_cache()
    phase_paper(torch)
    no_quarantine("paper evaluation")
    phase_reference_smoke(torch, (MIXTRAL, QWEN3_MOE), MOE_SMOKE_PROMPT,
                          MOE_SMOKE_NEW)
    moe = phase_moe(torch, smi)
    no_quarantine("MoE serving, traffic E")
    phase_reference_smoke(torch, DENSE_GQA, 9, 6, int8_kv=True)
    dense_gqa = phase_dense_gqa(torch, smi)
    no_quarantine("dense GQA, traffic F")
    torch.cuda.empty_cache()
    phase_reference_smoke(torch, (MAMBA2, JAMBA), 9, 6, int8_kv=True,
                          depth={JAMBA: 8})
    hybrid = phase_hybrid(torch, smi)
    no_quarantine("Mamba2 and the hybrid, traffics G and H")
    torch.cuda.empty_cache()
    phase_reference_smoke(torch, (VLM,), 9, 6, int8_kv=True)
    vlm = serve_vlm(torch, smi)
    no_quarantine("the VLM, traffic I")
    torch.cuda.empty_cache()
    phase_tuning(torch, smi)
    trained, _ = phase_training(torch, smi)
    no_quarantine("training, traffic J")
    for mode, kn in (("dual", "K1"), ("dual+kc", "K2")):
        t = totals[kn]
        log(f"time: {mode} generate {walls[mode]:.0f} ms; timed alone at "
            f"its shapes, its {kn} launches take {t['ms']:.1f} ms (device "
            f"{fmt_ms(t['device_ms'])}) and its per-call planning "
            f"{t['plan_ms']:.0f} ms (dense generate {walls['dense']:.0f} ms, "
            f"its projections {t['library_ms']:.1f} ms as torch.matmul, "
            f"device {fmt_ms(t['library_device_ms'])}; bound "
            f"{t['nbytes'] / HBM_BYTES_PER_S * 1e3:.1f} ms by bytes)")
    for mode, kn in (("dual+kv", "K3"), ("dual+kc+kv", "K4")):
        t = totals[kn]
        log(f"time: {mode} generate {kv_walls[mode]:.0f} ms against "
            f"{kv_walls['dual']:.0f} ms with plain caches; timed alone, its "
            f"{kn} launches take {t['ms']:.2f} ms (device "
            f"{fmt_ms(t['device_ms'])}) and their planning "
            f"{t['plan_ms']:.1f} ms (torch.bmm over every slot "
            f"{t['library_ms']:.2f} ms, device "
            f"{fmt_ms(t['library_device_ms'])}; bound "
            f"{max(t['nbytes'] / HBM_BYTES_PER_S, t['op_s']) * 1e3:.3f} ms)")
    conv_ms = sum(totals[kn]["ms"] for kn in ("K5", "K6", "K7"))
    for mode in MODES:
        log(f"time: whisper {mode} generate {w_walls[mode]:.0f} ms (prefill "
            f"{w_times[mode][0]:.1f} ms, decode median "
            f"{statistics.median(w_times[mode][1:]):.1f} ms)"
            + (f"; its K5-K7 launches take {conv_ms:.3f} ms timed alone"
               if mode != "dense" else ""))

    meta = {
        "K1": ("bitmap_spgemm_planned",
               "src/repro_torch/kernels/csrc/bitmap_spgemm.cu",
               "src/repro/kernels/bitmap_spgemm.py:106",
               launches["dual"][0]),
        "K2": ("bitmap_spgemm_kfused_planned",
               "src/repro_torch/kernels/csrc/bitmap_spgemm_kfused.cu",
               "src/repro/kernels/bitmap_spgemm.py:266",
               launches["dual+kc"][1]),
        "K3": ("grouped_spgemm_planned",
               "src/repro_torch/kernels/csrc/grouped_spgemm.cu",
               "src/repro/kernels/grouped_spgemm.py:94",
               kv_launches["dual+kv"]["K3"]),
        "K4": ("grouped_spgemm_kfused_planned",
               "src/repro_torch/kernels/csrc/grouped_spgemm_kfused.cu",
               "src/repro/kernels/grouped_spgemm.py:209",
               kv_launches["dual+kc+kv"]["K4"]),
        "K5": ("bitmap_encode",
               "src/repro_torch/kernels/csrc/bitmap_encode.cu",
               "src/repro/kernels/bitmap_encode.py:54",
               w_launches["dual"]["K5"]),
        "K6": ("sparse_im2col",
               "src/repro_torch/kernels/csrc/sparse_im2col.cu",
               "src/repro/kernels/sparse_im2col.py:218",
               w_launches["dual"]["K6"]),
        "K7": ("sparse_im2col_strided",
               "src/repro_torch/kernels/csrc/sparse_im2col_strided.cu",
               "src/repro/kernels/sparse_im2col.py:172",
               w_launches["dual"]["K7"]),
    }
    rows = []
    for kn, (name, source, replaces, n_launch) in meta.items():
        t = totals[kn]
        t_bytes = t["nbytes"] / HBM_BYTES_PER_S
        t_ops = t.get("op_s", 0.0)      # K5-K7 do no arithmetic
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launch,
            # K5-K7 are held bit-equal (a mismatch raised above)
            "max_abs_err": err.get(kn, 0.0), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            # no PyTorch call encodes a bitmap (K5); F.unfold lowers
            # densely, the same values without the bitmap (K6/K7)
            "library_ms": None if kn == "K5" else t["library_ms"]})
        if kn in moe:
            # the same numbers on the MoE path (phase 14): traffic E on
            # mixtral-8x7b, one cached-plan generate's launches
            m = moe[kn]
            rows[-1]["moe"] = {
                "launches": m["launches"], "max_abs_err": m["max_abs_err"],
                "ms": m["ms"], "device_ms": m["device_ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"]}
        # traffic F (phase 15): qwen1.5-110b's cached-plan dual+kv
        # generate on int8 32768-slot caches, its launches replayed; traffic
        # G (phase 16) likewise on jamba-1.5-large (dual+kv: K1, K3;
        # dual+kc+kv: K2, K4), traffic H on mamba2-370m (dual: K1 on the
        # tied head) and traffic I (phase 17) on llama-3.2-vision-90b
        # (dual+kv: K1, K3, K5, K7; dual+kc+kv: K2, K4)
        for group, nums in (("traffic_f", dense_gqa),
                            ("traffic_g", hybrid["traffic_g"]),
                            ("traffic_h", hybrid["traffic_h"]),
                            ("traffic_i", vlm),
                            ("traffic_j", trained)):
            if kn in nums:
                m = nums[kn]
                rows[-1][group] = {
                    "launches": m["launches"],
                    "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                    "device_ms": m["device_ms"], "plain_ms": m["plain_ms"],
                    "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                    "library_ms": m["library_ms"]}
    log(f"kernels line: ms, plain_ms, bound_ms and library_ms are summed "
        f"over one generate's launches at the served types: K1/K2 bf16 over "
        f"{13 * NEW_TOKENS} dispatches (1 prefill of {PROMPTS * PROMPT_LEN} "
        f"rows, {NEW_TOKENS - 1} decodes of {PROMPTS}), ms and library_ms "
        f"(torch.matmul) CUDA events around one call; K3/K4 over "
        f"{KV_CALLS} score (bf16 in) and {KV_CALLS} value (float32 p, "
        f"bf16 V) products of the sparse-KV generate, "
        f"library_ms torch.bmm over all {CAPACITY} slots; K5-K7 bf16 over "
        f"one whisper generate's stem ({W_SEGMENTS} segments: K5 on both "
        f"stem convs, K6 on conv1, K7 on conv2), ms and library_ms "
        f"(F.unfold) the profiler's device time, bound_ms from the bytes "
        f"each must move; under \"moe\", K1-K4 over one cached-plan "
        f"generate of traffic E on {MIXTRAL} (dual: K1 + K3, dual+kc: K2 + "
        f"K4), replayed on the launches' inputs, ms CUDA events, library_ms "
        f"torch.bmm over every expert (K3/K4) or the product (K1/K2); under "
        f"\"traffic_f\", K1 and K3 over one cached-plan dual+kv generate of "
        f"traffic F on {QWEN15} ({F_PROMPTS} x {F_PROMPT_LEN} tokens, "
        f"{F_NEW} new, int8 {F_CAPACITY}-slot caches), replayed alike, "
        f"plain_ms the plain walks of the held replay, library_ms torch.bmm "
        f"over every slot (K3) or the product (K1); under \"traffic_g\" "
        f"the same for {JAMBA} ({G_LAYERS} layers) in dual+kv (K1, K3: "
        f"experts and cache) and dual+kc+kv (K2, K4), library_ms torch.bmm "
        f"over every expert or slot; under \"traffic_h\", K1 on the tied "
        f"head of one dual generate of {MAMBA2} ({H_PROMPTS} x "
        f"{H_PROMPT_LEN} tokens, {H_NEW} new); under \"traffic_i\", K1-K4 "
        f"the same for {VLM} ({I_LAYERS} layers, {F_PROMPTS} x "
        f"{F_PROMPT_LEN} tokens and a 560 x 560 image each) in dual+kv (K1, "
        f"K3) and dual+kc+kv (K2, K4), and K5 and K7 over the generate's one "
        f"launch each (the patch conv), ms CUDA events, device_ms the "
        f"profiler's, library_ms F.unfold (K7); under \"traffic_j\", K1 "
        f"and K2 over one cached-plan dual and dual+kc generate of {J_ARCH} "
        f"({J_LAYERS} layers) on the weights phase 19 trained, cast to bf16 "
        f"({J_PROMPTS} x {J_PROMPT_LEN} tokens, {J_NEW} new), replayed "
        f"alike, library_ms torch.bmm over the product; total "
        f"{time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
