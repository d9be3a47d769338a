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
   host time at the served shapes, by part;
5. conv kernels — K5, K6 and K7 bit-equal to their plain versions in bf16
   and float32 at whisper-base's stem shapes (4 segments, conv1 k=1x3 s=1
   over 80 mel bins, conv2 s=2 over 512 channels), the vision patch shape
   (560 x 560 x 3, k = s = 14) and ragged shapes; bf16 device times at the
   stem shapes beside the byte bound, the plain version and ``F.unfold``;
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
   the lowering glue, planning, K1/K2 and the rest, beside ``F.conv2d``.

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

# the whisper traffic: 4 segments of 30 s audio (3000 mel frames x 80
# bins each), whisper's start-of-transcript prefix as the prompt, 32 greedy
# tokens; whisper-base at full width and depth
WHISPER = "whisper-base"
W_SEGMENTS, W_NEW = 4, 32
# <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>
W_PROMPT = (50258, 50259, 50359, 50363)
# the vision patch conv's shape (k = s = 14 over a 560 x 560 x 3 image):
# K7's other caller, checked here, served by a later slice
PATCH = (1, 560, 560, 3, 14, 14, 14)
# ragged conv shapes (N, H, W, C, kh, kw, stride): 3x3 at strides 1 and
# 2, windows that cross or end on a word boundary, W multiple of 32
CONV_RAGGED = [(1, 7, 9, 3, 3, 3, 1), (2, 9, 10, 2, 3, 3, 2),
               (1, 1, 66, 2, 1, 34, 1), (1, 1, 65, 2, 1, 2, 1),
               (1, 1, 100, 2, 1, 33, 2), (1, 2, 96, 3, 2, 1, 1)]


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


def device_ms(torch, fn, reps=20):
    """Device time per call of the kernels ``fn`` launches, from a
    ``torch.profiler`` (CUPTI) trace of ``reps`` calls: the card's own
    time, without the host's time in the wrapper, which CUDA events around
    a call of a microsecond-scale kernel mostly measure.  None when two
    traces hold no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    return None


def served_geometry(a, b):
    """The clamped (block_m, block_n, slice_k) of ``a @ b`` at the
    config's 128/128/128 knobs, as the dispatch resolves them."""
    from repro_torch.sparse import plan as pln
    bm, bn, sk = pln.clamp_geometry(a.shape[0], b.shape[1], a.shape[1],
                                    128, 128, 128)
    return dict(block_m=bm, block_n=bn, slice_k=sk)


def plan_slices(a, b, geom):
    """K1's schedule (ks, counts) of ``a @ b`` as the dispatch builds it
    per call, from ``a != 0`` and ``w != 0``."""
    from repro_torch.sparse import plan as pln
    sk = geom["slice_k"]
    col = pln.block_reduce_lhs(pln.slice_activity_lhs(a, sk), geom["block_m"])
    row = pln.block_reduce_rhs(pln.slice_activity_rhs(b, sk), geom["block_n"])
    return pln.plan_from_activity(col, row)


def plan_gathers(a, b, geom):
    """K2's element-condensed schedule (a KPlan), built the same way."""
    from repro_torch.sparse import plan as pln
    return pln.plan_kcondensed(
        pln.element_activity_lhs(a, geom["block_m"]),
        pln.element_activity_rhs(b, geom["block_n"]), geom["slice_k"])


def plan_k1(a, b):
    geom = served_geometry(a, b)
    return (geom, *plan_slices(a, b, geom))


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
            ks, counts = plan_slices(a, b, geom)
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
    kw = site.resolve(site.make(op, op, out_dtype="float32"), cfg)
    if op == "attn.value":
        kw["slice_k"] = pln.effective_slice_k(k, kw["slice_k"])
    bm, bn, sk = pln.clamp_geometry(c, n, k, kw["block_m"], kw["block_n"],
                                    kw["slice_k"])
    return dict(block_m=bm, block_n=bn, slice_k=sk)


def attention_products(torch, cfg, written, g):
    """The decode attention's two grouped products over a CAPACITY-slot
    cache whose first ``written`` slots hold tokens, as
    ``attend_sparse`` builds them: E = prompts x KV heads problems, the
    schedule = the written slots.  Returns {site: (x, w)} in float32,
    x a SparseActivation, w a tensor or PlannedWeight."""
    from repro_torch.sparse import kvcache as skvc
    from repro_torch.sparse import plan as pln
    dev = torch.device("cuda")
    e, grp, hd = KV_PROMPTS * cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.hd
    sched = torch.arange(CAPACITY, device=dev) < written
    k_e = torch.randn(e, CAPACITY, hd, device=dev, generator=g) \
        * sched[:, None]
    q_e = torch.randn(e, hd, grp, device=dev, generator=g)
    p = torch.rand(e, grp, CAPACITY, device=dev, generator=g) * sched
    v_e = torch.randn(e, CAPACITY, hd, device=dev, generator=g) \
        * sched[:, None]
    x_k = skvc.score_operand(
        k_e, sched, pln.effective_slice_k(hd, cfg.sparse_slice_k))
    x_p, w_v = skvc.value_operands(
        sched, p, v_e, sched,
        pln.effective_slice_k(CAPACITY, cfg.sparse_block_t))
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


def phase_serving(torch, cfg, model):
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    from repro_torch.sparse import tape
    prompts = torch.randint(0, cfg.vocab_size, (PROMPTS, PROMPT_LEN),
                            generator=torch.Generator().manual_seed(2))
    batch = {"tokens": prompts.cuda()}
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
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.kernels import grouped_spgemm as gsk
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    from repro_torch.sparse import tape
    prompts = torch.randint(0, cfg.vocab_size, (KV_PROMPTS, KV_PROMPT_LEN),
                            generator=torch.Generator().manual_seed(3))
    batch = {"tokens": prompts.cuda()}
    counters = {"K1": bsk.bitmap_spgemm_planned,
                "K2": bsk.bitmap_spgemm_kfused_planned,
                "K3": gsk.grouped_spgemm_planned,
                "K4": gsk.grouped_spgemm_kfused_planned}
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
    e = x.element_size()
    # K5 tests every element: x read whole, bits and cond written whole;
    # K6/K7 read only the condensed rows' non-zeros, and the bitmaps, and
    # write their whole outputs (the zero tails included)
    k5_bytes = x.numel() * e * 2 + bits.numel() * 4
    k67_bytes = (int(torch.count_nonzero(cond)) * e + bits.numel() * 4
                 + ob.numel() * 4 + ov.numel() * e)
    xn = xv.contiguous()
    return dict(
        k5=lambda: k5.bitmap_encode(xv),
        k5_plain=lambda: k5.bitmap_encode_plain(xv),
        k67=kern, k67_plain=plain,
        unfold=lambda: torch.nn.functional.unfold(xn, (kh, kw),
                                                  stride=stride),
        k5_bytes=k5_bytes, k67_bytes=k67_bytes,
        zero_share=1.0 - int(torch.count_nonzero(ov)) / ov.numel())


def phase_conv_kernels(torch):
    """K5, K6 and K7 bit-equal to their plain versions in bf16 and float32
    at the whisper stem's shapes, the vision patch shape and ragged ones;
    bf16 timings at the stem's shapes beside the byte bound, the plain
    version and ``F.unfold`` (a dense im2col without bitmaps, a yardstick
    only).  Returns {kernel: totals over one generate's launches}."""
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
            # the kernels' and F.unfold's own device time; CUDA events
            # around one call also hold the wrapper's host time
            dev = {k: device_ms(torch, res[k]) for k in ("k5", "k67",
                                                          "unfold")}
            if None in dev.values():
                log("conv kernels: the profiler traced no device time; "
                    "the kernel times below are CUDA-event times")
                dev = {k: t[k] for k in dev}
            b5 = res["k5_bytes"] / HBM_BYTES_PER_S * 1e3
            b67 = res["k67_bytes"] / HBM_BYTES_PER_S * 1e3
            for k, ms, pms, nb in (("K5", dev["k5"], t["k5_plain"],
                                    res["k5_bytes"]),
                                   (kn, dev["k67"], t["k67_plain"],
                                    res["k67_bytes"])):
                totals[k]["ms"] += ms
                totals[k]["plain_ms"] += pms
                totals[k]["nbytes"] += nb
            totals[kn]["library_ms"] += dev["unfold"]
            log(f"conv kernels: {what}: bit-equal to plain; device time "
                f"(events around one call, wrapper included): K5 "
                f"{dev['k5']:.4f} ({t['k5']:.4f}) ms, bound {b5:.4f}, plain "
                f"{t['k5_plain']:.3f}; {kn} {dev['k67']:.4f} "
                f"({t['k67']:.4f}) ms, bound {b67:.4f}, plain "
                f"{t['k67_plain']:.3f}, F.unfold {dev['unfold']:.4f} "
                f"({t['unfold']:.4f}); {res['zero_share']:.4f} of the "
                "lowered elements are zero")
        del x1, x2
        torch.cuda.empty_cache()
        for shape in [PATCH] + CONV_RAGGED:
            n, h, w, c, kh, kw, s = shape
            x = torch.randn(n, h, w, c, device="cuda", generator=g)
            x[torch.rand(x.shape, device="cuda", generator=g) < 0.5] = 0
            x[0, 0, :, 0] = 0                          # an all-zero row
            x[..., 1::7, :] = -0.0
            x[-1, -1, :, -1] = 1.0                     # all non-zero
            if w >= 32:
                x[:, :, 31::32, ::2] = 1.5             # bit 31 set
            conv_check(torch, x.to(getattr(torch, dtype)), kh, kw, s,
                       f"{shape} {dtype}")
        log(f"conv kernels: {dtype}: the patch shape {PATCH} and "
            f"{len(CONV_RAGGED)} ragged shapes bit-equal to plain")
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
    from repro_torch.kernels import bitmap_encode as k5
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.kernels import grouped_spgemm as gsk
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparse_im2col as k67
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
    counters = {"K1": bsk.bitmap_spgemm_planned,
                "K2": bsk.bitmap_spgemm_kfused_planned,
                "K3": gsk.grouped_spgemm_planned,
                "K4": gsk.grouped_spgemm_kfused_planned,
                "K5": k5.bitmap_encode, "K6": k67.sparse_im2col,
                "K7": k67.sparse_im2col_strided}
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
            st = fem.conv_site(key)
            kw_ = site.resolve(st, c)
            w4 = getattr(fp, key)
            kh, kwid, _, f = w4.shape
            w2 = w4.reshape(-1, f)
            ow = i2c.out_size(x.shape[2], kwid, stride)
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
    from repro_torch.configs import get_config

    t_start = time.perf_counter()
    phase_device(torch)
    phase_build()
    cfg = dataclasses.replace(get_config(ARCH), n_layers=N_LAYERS)
    err, totals = phase_kernels(torch, cfg)
    g_err, g_totals = phase_grouped(torch, cfg)
    err.update(g_err)
    totals.update(g_totals)
    c_totals = phase_conv_kernels(torch)
    totals.update(c_totals)
    phase_reference(torch)
    phase_reference_whisper(torch)
    model = make_model(torch, cfg)
    launches, walls = phase_serving(torch, cfg, model)
    kv_launches, kv_walls, _ = phase_serving_kv(torch, cfg, model)
    del model
    torch.cuda.empty_cache()
    phase_attention_split(torch, cfg)
    wcfg = get_config(WHISPER)
    wmodel, w_launches, w_walls, w_times = phase_serving_whisper(torch, wcfg)
    phase_conv_split(torch, wcfg, wmodel)
    del wmodel
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
        f"each must move; total "
        f"{time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
