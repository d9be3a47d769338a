#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a card and ``nvcc``.
Phases, each printed as it ends; any failure raises and exits non-zero:

1. device — the card's name and power limit, as ``nvidia-smi`` gives them;
2. build — K1/K2 compiled from ``src/repro_torch/kernels/csrc`` (sm_90a);
3. kernels — K1 and K2 against their plain PyTorch versions, in bf16 and
   float32, at every projection shape of the served model (decode M=2,
   prefill M=64) and at ragged shapes with ``counts == 0`` blocks and
   partial last slices; bf16 timings at the served shapes beside the
   bound, the plain version and ``torch.matmul`` (a yardstick only);
4. reference — the smoke model on the card against the CPU plain path;
5. serving — full-width ``nemotron-4-340b`` cut to 2 layers (random bf16
   weights from a seed) through ``generate``: dense, dual (K1) and
   dual+kcondense (K2), 2 prompts of 32 tokens, 8 new tokens each; each
   kernel must launch exactly 13 dispatches x 8 forwards = 104 times in
   its run, prefill logits must match dense, and greedy tokens may part
   from dense only where dense's top-2 logits are within the tolerance.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without a card, or
outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import dataclasses
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


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build()
    regs, spills = [], []
    for path in libs.values():
        text = path.with_name(path.stem[3:] + ".log").read_text()
        regs += [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills += [int(s) for s in
                   re.findall(r"(\d+) bytes spill stores", text)]
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(libs)} libraries "
        f"(nvcc {' '.join(build.NVCC_FLAGS)}); {len(regs)} kernels, max "
        f"{max(regs, default=0)} registers, {max(spills, default=0)} bytes "
        "of spill stores at most")


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


def plan_k1(a, b):
    """K1's schedule of ``a @ b`` as the dispatch builds it per call, from
    ``a != 0`` and ``w != 0`` at the config's 128/128/128 knobs."""
    from repro_torch.sparse import plan as pln
    bm, bn, sk = pln.clamp_geometry(a.shape[0], b.shape[1], a.shape[1],
                                    128, 128, 128)
    col = pln.block_reduce_lhs(pln.slice_activity_lhs(a, sk), bm)
    row = pln.block_reduce_rhs(pln.slice_activity_rhs(b, sk), bn)
    return (dict(block_m=bm, block_n=bn, slice_k=sk),
            *pln.plan_from_activity(col, row))


def plan_k2(a, b):
    """K2's element-condensed schedule, built the same way."""
    from repro_torch.sparse import plan as pln
    bm, bn, sk = pln.clamp_geometry(a.shape[0], b.shape[1], a.shape[1],
                                    128, 128, 128)
    return pln.plan_kcondensed(pln.element_activity_lhs(a, bm),
                               pln.element_activity_rhs(b, bn), sk)


def schedules(a, b):
    geom, ks, counts = plan_k1(a, b)
    return geom, ks, counts, plan_k2(a, b)


def needed_work(torch, a, b, geom, ks, counts, kp, kfused):
    """(bytes, flops) this data needs: A read once, the B rows of the
    scheduled work once per block column, the executed schedule, the
    output written once; 2 flops per needed multiply-add."""
    m, k = a.shape
    n = b.shape[1]
    bm, bn, sk = geom["block_m"], geom["block_n"], geom["slice_k"]
    eb = a.element_size()
    mt, nt = counts.shape
    rows = torch.clamp(m - torch.arange(mt, device=a.device) * bm, max=bm)
    cols = torch.clamp(n - torch.arange(nt, device=a.device) * bn, max=bn)
    if kfused:
        depth = kp.nnz.to(torch.float64)                  # (Mt, Nt)
        sched_bytes = 4 * (int(counts.sum()) * sk + counts.numel())
    else:
        width = torch.clamp(k - torch.arange(ks.shape[-1], device=a.device)
                            * sk, max=sk).to(torch.float64)
        live = (torch.arange(ks.shape[-1], device=a.device)
                < counts[..., None])
        depth = (width[ks.long()] * live).sum(-1)          # (Mt, Nt)
        sched_bytes = 4 * (int(counts.sum()) + counts.numel())
    # distinct B rows a block column needs, over its block rows
    b_rows = depth.amax(0) if mt > 1 else depth[0]
    nbytes = (m * k * eb + float((b_rows * cols).sum()) * eb + sched_bytes
              + m * n * eb)
    flops = 2.0 * float((depth * rows[:, None] * cols[None, :]).sum())
    return nbytes, flops


def check_pair(torch, name, y, p, dtype, what):
    scale = p.float().abs().max().item()
    err = (y.float() - p.float()).abs().max().item()
    tol = RTOL[dtype] * max(scale, 1e-30)
    if not err <= tol:
        raise AssertionError(f"{name} {what}: max |kernel - plain| {err:.3e}"
                             f" > {tol:.3e} ({RTOL[dtype]} x max|plain| "
                             f"{scale:.3e})")
    return err


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
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    kernels = {
        "K1": (bsk.bitmap_spgemm_planned, bsk.bitmap_spgemm_planned_plain),
        "K2": (bsk.bitmap_spgemm_kfused_planned,
               bsk.bitmap_spgemm_kfused_planned_plain),
    }
    err = {"K1": 0.0, "K2": 0.0}
    totals = {kn: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, plan_ms=0.0,
                       nbytes=0.0, flops=0.0) for kn in kernels}
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
                    pms = cuda_ms(torch, pfn, 2)
                    lms = cuda_ms(torch, lambda: torch.matmul(a, b), 10)
                    plan_ms = cuda_ms(torch, lambda: planners[kn](a, b), 3)
                    nb, fl = needed_work(torch, a, b, geom, ks, counts, kp,
                                         kn == "K2")
                    t = totals[kn]
                    t["ms"] += mult * ms
                    t["plain_ms"] += mult * pms
                    t["library_ms"] += mult * lms
                    t["plan_ms"] += mult * plan_ms
                    t["nbytes"] += mult * nb
                    t["flops"] += mult * fl
                    bound = max(nb / HBM_BYTES_PER_S,
                                fl / PEAK_FLOPS[dtype]) * 1e3
                    line.append(f"{ms:.3f} ms (bound {bound:.3f}, plain "
                                f"{pms:.1f}, torch.matmul {lms:.3f}, "
                                f"planning {plan_ms:.3f})")
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
    return err, totals


# ---------------------------------------------------------------------------
# phase 4: a small reference
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


# ---------------------------------------------------------------------------
# phase 5: serving at full width
# ---------------------------------------------------------------------------

def phase_serving(torch, cfg):
    from repro_torch.kernels import bitmap_spgemm as bsk
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import serve_loop
    from repro_torch.sparse import tape
    t0 = time.perf_counter()
    model = tfm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serving: {cfg.name} at full width, {cfg.n_layers} layers, "
        f"{n_params / 1e9:.2f} B bf16 parameters "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB), made in "
        f"{time.perf_counter() - t0:.1f} s")
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
        sites = {}
        for e in tape.summarize(entries):
            s = sites.setdefault(e["name"], [0, 0])
            s[0] += e["dense_steps"]
            s[1] += e["executed_steps"]
        log(f"serving: {mode}: {PROMPTS * NEW_TOKENS / dt:.2f} tokens/s "
            f"({dt:.2f} s for generate, stats tape on), launches K1/K2 "
            f"{counts}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; "
            "dense/executed steps " + ", ".join(
                f"{k} {v[0]}/{v[1]}" for k, v in sites.items()))

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
        agree = []
        for r in range(PROMPTS):
            diff = (tokens[mode][r] != tokens["dense"][r]).nonzero()
            if len(diff) == 0:
                agree.append(f"row {r}: all {NEW_TOKENS} equal")
                continue
            t = int(diff[0])
            top2 = torch.topk(steps[t][r], 2).values
            gap = float(top2[0] - top2[1])
            if not gap <= tol:
                raise AssertionError(
                    f"{mode}: row {r} parts from dense at step {t} where "
                    f"dense's top-2 gap {gap:.3f} > {tol:.3f}")
            agree.append(f"row {r}: parts at step {t}, dense top-2 gap "
                         f"{gap:.3f}")
        log(f"serving: {mode}: prefill logits max |diff| {err:.4f} <= "
            f"{tol:.4f} ({SERVE_RTOL} x max|dense| {scale:.2f}); "
            + "; ".join(agree))
    return launches, walls


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
    phase_reference(torch)
    launches, walls = phase_serving(torch, cfg)
    for mode, kn in (("dual", "K1"), ("dual+kc", "K2")):
        t = totals[kn]
        log(f"time: {mode} generate {walls[mode]:.0f} ms; timed alone at "
            f"its shapes, its {kn} launches take {t['ms']:.0f} ms and its "
            f"per-call planning {t['plan_ms']:.0f} ms (dense generate "
            f"{walls['dense']:.0f} ms, its projections "
            f"{t['library_ms']:.0f} ms as torch.matmul)")

    meta = {
        "K1": ("bitmap_spgemm_planned",
               "src/repro_torch/kernels/csrc/bitmap_spgemm.cu",
               "src/repro/kernels/bitmap_spgemm.py:106", launches["dual"][0]),
        "K2": ("bitmap_spgemm_kfused_planned",
               "src/repro_torch/kernels/csrc/bitmap_spgemm_kfused.cu",
               "src/repro/kernels/bitmap_spgemm.py:266",
               launches["dual+kc"][1]),
    }
    rows = []
    for kn, (name, source, replaces, n_launch) in meta.items():
        t = totals[kn]
        t_bytes = t["nbytes"] / HBM_BYTES_PER_S
        t_ops = t["flops"] / PEAK_FLOPS["bfloat16"]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": err[kn], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": t["library_ms"]})
    log(f"kernels line: ms, plain_ms, bound_ms and library_ms are bf16 "
        f"times summed over one generate's {13 * NEW_TOKENS} dispatches "
        f"(1 prefill of {PROMPTS * PROMPT_LEN} rows, {NEW_TOKENS - 1} "
        f"decodes of {PROMPTS}); library_ms is torch.matmul; total "
        f"{time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
