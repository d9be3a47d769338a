"""K1-K7, the sparse-KV decode, the whisper path, block pruning, the
MoE expert products, a full-width Mamba block, a tied head, the VLM's
vision frontend and every knob vector the tuner admits on the card
against their plain versions and the CPU, the tuner's card timer, a
smoke train step against the CPU's, the refusal of a gradient through a
kernel, a bitwise restart of the launcher and a one-rank NCCL group's
sharded MoE against the whole one (needs an NVIDIA GPU with
nvcc; skipped elsewhere).  Run there with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed.  Tolerance, relative to the largest plain output: 1e-5 for a
float32 output (the same float32 products summed in another order), 1e-2
for bf16 (one bf16 rounding of sums that may differ in their last float32
bits).  The conv kernels K5-K7 only move data: their outputs equal the
plain versions' bit for bit.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import pruning
from repro_torch.kernels import bitmap_spgemm as bsk
from repro_torch.kernels import bitmap_encode as k5
from repro_torch.kernels import grouped_spgemm as gsk
from repro_torch.kernels import sparse_im2col as k67
from repro_torch.models import transformer as tfm
from repro_torch.serving import serve_loop
from repro_torch.sparse import plan as pln

pytestmark = pytest.mark.cuda

SHAPES = [  # (M, K, N, block_m, block_n, slice_k)
    (37, 200, 50, 16, 16, 32),
    (2, 130, 24, 8, 8, 64),
    (200, 300, 520, 256, 256, 40),
    (64, 1000, 300, 128, 128, 128),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _case(dev, m, k, n, bm, bn, sk, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(m, k, device=dev, generator=g).clamp(min=0).square()
    b = torch.randn(k, n, device=dev, generator=g)
    b[:, :bn] = 0                                     # counts == 0 blocks
    b[torch.rand(k, n, device=dev, generator=g) < 0.5] = 0
    a, b = a.to(dtype), b.to(dtype)
    bm, bn, sk = pln.clamp_geometry(m, n, k, bm, bn, sk)
    col = pln.block_reduce_lhs(pln.slice_activity_lhs(a, sk), bm)
    row = pln.block_reduce_rhs(pln.slice_activity_rhs(b, sk), bn)
    ks, counts = pln.plan_from_activity(col, row)
    kp = pln.plan_kcondensed(pln.element_activity_lhs(a, bm),
                             pln.element_activity_rhs(b, bn), sk)
    return a, b, ks, counts, kp, dict(block_m=bm, block_n=bn, slice_k=sk)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda, shape, dtype, out_dtype):
    a, b, ks, counts, kp, geom = _case(cuda, *shape, dtype)
    assert (counts == 0).any() and (kp.counts == 0).any()
    n1 = bsk.bitmap_spgemm_planned.launches
    n2 = bsk.bitmap_spgemm_kfused_planned.launches
    pairs = [
        (bsk.bitmap_spgemm_planned(a, b, ks, counts, out_dtype=out_dtype,
                                   **geom),
         bsk.bitmap_spgemm_planned_plain(a, b, ks, counts,
                                         out_dtype=out_dtype, **geom)),
        (bsk.bitmap_spgemm_kfused_planned(a, b, kp.gk, kp.counts,
                                          out_dtype=out_dtype, **geom),
         bsk.bitmap_spgemm_kfused_planned_plain(a, b, kp.gk, kp.counts,
                                                out_dtype=out_dtype, **geom)),
    ]
    torch.cuda.synchronize()
    assert bsk.bitmap_spgemm_planned.launches == n1 + 1
    assert bsk.bitmap_spgemm_kfused_planned.launches == n2 + 1
    want = out_dtype or dtype
    rtol = 1e-5 if want == torch.float32 else 1e-2
    for y, p in pairs:
        assert y.dtype == p.dtype == want
        scale = p.float().abs().max().item()
        err = (y.float() - p.float()).abs().max().item()
        assert err <= rtol * scale, (err, scale)


# split-heavy K1/K2 shapes: so few tiles that each tile's schedule is cut
# over many CUDA blocks (N <= block_n with K = 16384; slice_k 40 and 96;
# block_m 37; N = 300, whose first column tile has counts == 0 beside
# split ones)
SPLIT_SHAPES = [  # (M, K, N, block_m, block_n, slice_k)
    (2, 16384, 96, 8, 128, 128),
    (2, 16384, 300, 8, 128, 40),
    (37, 16384, 300, 37, 128, 96),
    (64, 16384, 256, 64, 128, 128),
]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_split_kernels_match_plain(cuda, shape, dtype, out_dtype):
    m, k, n, bm, bn, sk = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn(m, k, device=cuda, generator=g).clamp(min=0).square()
    b = torch.randn(k, n, device=cuda, generator=g)
    if n > bn:
        b[:, :bn] = 0                                 # counts == 0 tiles
    b[torch.rand(k, n, device=cuda, generator=g) < 0.5] = 0
    a, b = a.to(dtype), b.to(dtype)
    bm, bn, sk = pln.clamp_geometry(m, n, k, bm, bn, sk)
    ks, counts = pln.plan_from_activity(
        pln.block_reduce_lhs(pln.slice_activity_lhs(a, sk), bm),
        pln.block_reduce_rhs(pln.slice_activity_rhs(b, sk), bn))
    kp = pln.plan_kcondensed(pln.element_activity_lhs(a, bm),
                             pln.element_activity_rhs(b, bn), sk)
    assert (n <= bn) or ((counts == 0).any() and (kp.counts == 0).any())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    blocks = bsk.mma_blocks(1, *counts.shape, bm, bn)
    assert bsk.split_count(blocks, ks.shape[-1], sms, m=m, k=k) > 1
    geom = dict(block_m=bm, block_n=bn, slice_k=sk, out_dtype=out_dtype)
    pairs = [
        (bsk.bitmap_spgemm_planned(a, b, ks, counts, **geom),
         bsk.bitmap_spgemm_planned_plain(a, b, ks, counts, **geom)),
        (bsk.bitmap_spgemm_kfused_planned(a, b, kp.gk, kp.counts, **geom),
         bsk.bitmap_spgemm_kfused_planned_plain(a, b, kp.gk, kp.counts,
                                                **geom)),
    ]
    torch.cuda.synchronize()
    want = out_dtype or dtype
    rtol = 1e-5 if want == torch.float32 else 1e-2
    for y, p in pairs:
        assert y.dtype == p.dtype == want
        scale = p.float().abs().max().item()
        err = (y.float() - p.float()).abs().max().item()
        assert err <= rtol * scale, (err, scale)
        if n > bn:                                    # the dead tile
            assert not y[:, :bn].any()


GROUPED = [  # (E, C, K, N, block_m, block_n, slice_k)
    (16, 4096, 192, 12, 32, 12, 128),   # attn.score of nemotron's decode
    (16, 12, 4096, 192, 12, 128, 32),   # attn.value
    (5, 37, 200, 50, 16, 16, 32),       # ragged, partial slices
]
OCC = (1.0, 0.6, 0.0, 0.07, 0.9)        # occupied share of each problem


def _grouped_case(dev, e, c, k, n, bm, bn, sk, dtype):
    """Problems whose rows (or, for the value shape, contraction) are
    occupied to different depths; problem 2 is empty (counts == 0)."""
    g = torch.Generator(device=dev).manual_seed(1)
    a = torch.randn(e, c, k, device=dev, generator=g)
    b = torch.randn(e, k, n, device=dev, generator=g)
    b[torch.rand(e, k, n, device=dev, generator=g) < 0.3] = 0
    for i in range(e):
        frac = OCC[i % len(OCC)]
        if c >= k:
            a[i, int(c * frac):] = 0
        else:
            a[i, :, int(k * frac):] = 0
            b[i, int(k * frac):] = 0
    a, b = a.to(dtype), b.to(dtype)
    bm, bn, sk = pln.clamp_geometry(c, n, k, bm, bn, sk)
    ks, counts = pln.plan_grouped_activity(
        pln.block_reduce_lhs(pln.slice_activity_lhs(a, sk), bm),
        pln.block_reduce_rhs(pln.slice_activity_rhs(b, sk), bn))
    kp = pln.plan_grouped_kcondensed(pln.element_activity_lhs(a, bm),
                                     pln.element_activity_rhs(b, bn), sk)
    return a, b, ks, counts, kp, dict(block_m=bm, block_n=bn, slice_k=sk)


@pytest.mark.parametrize("shape", GROUPED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_grouped_kernels_match_plain(cuda, shape, dtype, out_dtype):
    a, b, ks, counts, kp, geom = _grouped_case(cuda, *shape, dtype)
    assert (counts[2] == 0).all() and (kp.counts[2] == 0).all()
    n3 = gsk.grouped_spgemm_planned.launches
    n4 = gsk.grouped_spgemm_kfused_planned.launches
    pairs = [
        (gsk.grouped_spgemm_planned(a, b, ks, counts, out_dtype=out_dtype,
                                    **geom),
         gsk.grouped_spgemm_planned_plain(a, b, ks, counts,
                                          out_dtype=out_dtype, **geom)),
        (gsk.grouped_spgemm_kfused_planned(a, b, kp.gk, kp.counts,
                                           out_dtype=out_dtype, **geom),
         gsk.grouped_spgemm_kfused_planned_plain(
             a, b, kp.gk, kp.counts, out_dtype=out_dtype, **geom)),
    ]
    torch.cuda.synchronize()
    assert gsk.grouped_spgemm_planned.launches == n3 + 1
    assert gsk.grouped_spgemm_kfused_planned.launches == n4 + 1
    want = out_dtype or dtype
    rtol = 1e-5 if want == torch.float32 else 1e-2
    for y, p in pairs:
        assert y.dtype == p.dtype == want
        assert not y[2].any()                 # the empty problem
        scale = p.float().abs().max().item()
        err = (y.float() - p.float()).abs().max().item()
        assert err <= rtol * scale, (err, scale)


def _grouped_pairs(a, b, ks, counts, kp, geom, out_dtype):
    """(K3, K3 plain) and (K4, K4 plain) outputs, launches checked."""
    n3 = gsk.grouped_spgemm_planned.launches
    n4 = gsk.grouped_spgemm_kfused_planned.launches
    kw = dict(out_dtype=out_dtype, **geom)
    pairs = [
        (gsk.grouped_spgemm_planned(a, b, ks, counts, **kw),
         gsk.grouped_spgemm_planned_plain(a, b, ks, counts, **kw)),
        (gsk.grouped_spgemm_kfused_planned(a, b, kp.gk, kp.counts, **kw),
         gsk.grouped_spgemm_kfused_planned_plain(a, b, kp.gk, kp.counts,
                                                 **kw)),
    ]
    torch.cuda.synchronize()
    assert gsk.grouped_spgemm_planned.launches == n3 + 1
    assert gsk.grouped_spgemm_kfused_planned.launches == n4 + 1
    return pairs


def _assert_close(pairs, want):
    rtol = 1e-5 if want == torch.float32 else 1e-2
    for y, p in pairs:
        assert y.dtype == p.dtype == want
        scale = p.float().abs().max().item()
        err = (y.float() - p.float()).abs().max().item()
        assert err <= rtol * scale, (err, scale)


def _route(a, b, geom):
    src = bsk.GROUPED_SOURCES[0]
    e, m, k = a.shape
    n = b.shape[2]
    kind = bsk.route(src, a.dtype, b.dtype, n, k)
    g = (e, m, n, k, pln._cdiv(m, geom["block_m"]),
         pln._cdiv(n, geom["block_n"]), pln._cdiv(k, geom["slice_k"]))
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    return kind, bsk.route_splits(kind, g, geom["block_m"],
                                  geom["block_n"], sms)


NARROW = [  # (E, C, K, N, block_m, block_n, slice_k)
    (16, 4096, 192, 12, 32, 12, 128),   # the served score
    (3, 100, 192, 1, 32, 1, 128),
    (3, 100, 192, 8, 16, 8, 64),
    (3, 100, 90, 12, 64, 12, 40),       # K and slice_k off the 8-grid
    (5, 37, 200, 16, 16, 16, 32),
    (3, 300, 256, 12, 100, 6, 128),     # 2 column tiles, 2 warps a tile
    # the dense GQA families' scores over 32768 slots: yi-34b's odd G = 7,
    # qwen1.5-110b's 8 and chatglm3-6b's 16 (= NARROW_N)
    (16, 32768, 128, 7, 32, 7, 128),
    (16, 32768, 128, 8, 32, 8, 128),
    (4, 32768, 128, 16, 32, 16, 128),
]


@pytest.mark.parametrize("shape", NARROW)
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_grouped_narrow_route_matches_plain(cuda, shape, out_dtype):
    """bf16 products of at most 16 columns: the narrow-N tensor-core
    kernel, N in {1, 7, 8, 12, 16}."""
    a, b, ks, counts, kp, geom = _grouped_case(cuda, *shape, torch.bfloat16)
    assert _route(a, b, geom) == ("narrow", 1)
    pairs = _grouped_pairs(a, b, ks, counts, kp, geom, out_dtype)
    for y, _ in pairs:
        assert not y[2].any()
    _assert_close(pairs, out_dtype or torch.bfloat16)


def test_int8_attend_sparse_long_cache_matches_cpu(cuda):
    """One decode step of qwen1.5-110b's attention (8 KV heads, G = 8,
    head 128) over an int8 SparseKVCache of 32768 slots holding 3001
    tokens: the card's codes equal the CPU's, and the output (K3 on the
    narrow and mixed routes) agrees with the CPU plain walk."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import cache as kvc
    from repro_torch.sparse import kvcache as skvc
    cfg = dataclasses.replace(get_config("qwen1.5-110b"), sparse_mode="dual",
                              sparse_use_kernel=True, sparse_kv=True)
    b, t, kvh, hd, s = 2, 32768, cfg.n_kv_heads, cfg.hd, 3000
    g = torch.Generator().manual_seed(2)
    writes = [(torch.randn(b, n, kvh, hd, generator=g).to(torch.bfloat16),
               torch.randn(b, n, kvh, hd, generator=g).to(torch.bfloat16))
              for n in (s, 1)]
    q = torch.randn(b, 1, cfg.n_heads, hd, generator=g).to(torch.bfloat16)
    got = {}
    for dev in ("cpu", cuda):
        c = skvc.init_sparse_cache(b, t, kvh, hd, quantized=True,
                                   block_t=cfg.sparse_block_t, device=dev)
        for k_new, v_new in writes:
            c = skvc.update(c, k_new.to(dev), v_new.to(dev))
        n3 = gsk.grouped_spgemm_planned.launches
        out = attn.attend_sparse(q.to(dev), c, cfg,
                                 qpos=torch.tensor([s], device=dev),
                                 kpos=kvc.key_positions(c))
        got[str(dev)] = (c, out.cpu(), gsk.grouped_spgemm_planned.launches
                         - n3)
    (cc, want, n_cpu), (gc, out, n_gpu) = got["cpu"], got[str(cuda)]
    assert (n_cpu, n_gpu) == (0, 2)
    assert torch.equal(gc.k.cpu(), cc.k) and torch.equal(gc.v.cpu(), cc.v)
    torch.testing.assert_close(gc.k_scale.cpu(), cc.k_scale, rtol=1e-7,
                               atol=0)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


MIXED = [
    (16, 12, 4096, 192, 12, 128, 32),   # the served value
    (5, 37, 200, 50, 16, 16, 32),       # ragged, partial slices
    (3, 20, 300, 70, 20, 40, 24),       # N off the 8-grid: scalar loads
]


@pytest.mark.parametrize("shape", MIXED)
@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16])
def test_grouped_mixed_route_matches_plain(cuda, shape, out_dtype):
    """float32 A against bf16 B (the decode value, V as stored): the mixed
    kernel, equal to the float32 walk up to the order of the sums."""
    a, b, ks, counts, kp, geom = _grouped_case(cuda, *shape, torch.float32)
    b = b.to(torch.bfloat16)
    assert _route(a, b, geom) == ("mixed", 1)
    pairs = _grouped_pairs(a, b, ks, counts, kp, geom, out_dtype)
    for y, _ in pairs:
        assert not y[2].any()
    _assert_close(pairs, out_dtype or torch.float32)


@pytest.mark.parametrize("shape", [
    (16, 12, 4096, 192, 12, 128, 32),   # the value's shape in bf16
    (4, 8, 8192, 256, 8, 128, 64),
])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_grouped_split_route_matches_plain(cuda, shape, out_dtype):
    """bf16 products wider than 16 columns: the 128-column tensor-core
    kernel, each tile's schedule split over several CUDA blocks."""
    a, b, ks, counts, kp, geom = _grouped_case(cuda, *shape, torch.bfloat16)
    kind, splits = _route(a, b, geom)
    assert kind == "mma" and splits > 1
    _assert_close(_grouped_pairs(a, b, ks, counts, kp, geom, out_dtype),
                  out_dtype or torch.bfloat16)


@pytest.mark.parametrize("dtypes", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16])
def test_grouped_ragged_routes_match_plain(cuda, dtypes, out_dtype):
    """The ragged shape with an empty problem on every route's types."""
    a, b, ks, counts, kp, geom = _grouped_case(
        cuda, 5, 37, 200, 50, 16, 16, 32, torch.float32)
    a, b = a.to(dtypes[0]), b.to(dtypes[1])
    pairs = _grouped_pairs(a, b, ks, counts, kp, geom, out_dtype)
    for y, _ in pairs:
        assert not y[2].any()
    _assert_close(pairs, out_dtype or dtypes[0])


def test_grouped_kernels_empty_grids(cuda):
    """No problems, and problems with no rows: clean launches, right
    shapes."""
    for e, c in ((0, 8), (3, 0)):
        a = torch.zeros(e, c, 16, device=cuda)
        b = torch.zeros(e, 16, 8, device=cuda)
        mt = pln._cdiv(c, 8)
        ks = torch.zeros(e, mt, 1, 2, dtype=torch.int32, device=cuda)
        cn = torch.zeros(e, mt, 1, dtype=torch.int32, device=cuda)
        y = gsk.grouped_spgemm_planned(a, b, ks, cn, block_m=8, block_n=8,
                                       slice_k=8)
        torch.cuda.synchronize()
        assert tuple(y.shape) == (e, c, 8)


# the MoE path's expert products (bf16, unpruned weights): E experts'
# capacity buffers (C rows) against their stacked (K, N) weights, every
# other expert given no token (all its blocks counts == 0)
MOE_EXPERTS = [  # (E, C, K, N)
    (8, 24, 14336, 4096),     # mixtral-8x7b down, prefill capacity
    (8, 8, 4096, 14336),      # mixtral-8x7b up / gate, decode
    (128, 8, 4096, 1536),     # qwen3-moe-235b-a22b up / gate, decode
]


def _moe_case(dev, e, c, k, n):
    g = torch.Generator(device=dev).manual_seed(7)
    a = torch.randn(e, c, k, device=dev, generator=g)
    fill = torch.randint(1, c + 1, (e,), device=dev, generator=g)
    fill[::2] = 0
    a[torch.arange(c, device=dev)[None, :] >= fill[:, None]] = 0
    b = torch.randn(e, k, n, device=dev, generator=g) * k ** -0.5
    return a.to(torch.bfloat16), b.to(torch.bfloat16)


@pytest.mark.parametrize("shape", MOE_EXPERTS)
def test_grouped_moe_shapes_match_plain(cuda, shape):
    """K3 and K4 at the served expert shapes, on the tensor-core route:
    the empty experts write zeros, the rest agree with the plain walks."""
    a, b = _moe_case(cuda, *shape)
    e, c, k = a.shape
    geom = dict(zip(("block_m", "block_n", "slice_k"),
                    pln.clamp_geometry(c, b.shape[2], k, 128, 128, 128)))
    ks, counts = gsk.plan_grouped(a, b, **geom)
    kp = pln.plan_grouped_kcondensed(
        pln.element_activity_lhs(a, geom["block_m"]),
        pln.element_activity_rhs(b, geom["block_n"]), geom["slice_k"])
    assert (counts[::2] == 0).all() and (counts[1::2] > 0).all()
    assert _route(a, b, geom)[0] == "mma"
    pairs = _grouped_pairs(a, b, ks, counts, kp, geom, None)
    for y, _ in pairs:
        assert not y[::2].any()
    _assert_close(pairs, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_on_the_fly_entries_match_plain(cuda, dtype):
    """``grouped_spgemm`` / ``grouped_spgemm_kfused``: planning, then one
    K3 / K4 launch, equal to the plain walks of the same schedules."""
    a, b, ks, counts, kp, geom = _grouped_case(cuda, 5, 37, 200, 50, 16,
                                               16, 32, dtype)
    n3 = gsk.grouped_spgemm_planned.launches
    n4 = gsk.grouped_spgemm_kfused_planned.launches
    y3 = gsk.grouped_spgemm(a, b, **geom)
    y4 = gsk.grouped_spgemm_kfused(a, b, **geom)
    torch.cuda.synchronize()
    assert gsk.grouped_spgemm_planned.launches == n3 + 1
    assert gsk.grouped_spgemm_kfused_planned.launches == n4 + 1
    _assert_close([
        (y3, gsk.grouped_spgemm_planned_plain(a, b, ks, counts, **geom)),
        (y4, gsk.grouped_spgemm_kfused_planned_plain(a, b, kp.gk, kp.counts,
                                                     **geom))], dtype)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
def test_moe_generate_matches_cpu(cuda, arch):
    """The MoE smoke models on the card (K1 + K3, K2 + K4) emit the CPU
    plain path's tokens, in float32, past mixtral-smoke's window."""
    cfg = smoke_config(arch)
    cpu = tfm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.float32)
    gpu = tfm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.float32).to(cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    rc = RunConfig(act_dtype="float32")
    for kc in (False, True):
        c = dataclasses.replace(cfg, sparse_mode="dual",
                                sparse_use_kernel=True, sparse_kcondense=kc)
        n = gsk.grouped_spgemm_planned.launches + \
            gsk.grouped_spgemm_kfused_planned.launches
        want = serve_loop.generate(cpu, {"tokens": tokens}, c,
                                   max_new_tokens=8, rc=rc, device="cpu")
        got = serve_loop.generate(gpu, {"tokens": tokens}, c,
                                  max_new_tokens=8, rc=rc)
        assert torch.equal(want, got.cpu())
        assert gsk.grouped_spgemm_planned.launches + \
            gsk.grouped_spgemm_kfused_planned.launches == n + 3 * 2 * 8


def test_sparse_kv_generate_matches_cpu(cuda):
    """The smoke model's sparse-KV decode on the card (K1 + K3, K2 + K4)
    emits the CPU plain path's tokens."""
    cfg = smoke_config("nemotron-4-340b")
    cpu = tfm.init_model(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    gpu = tfm.init_model(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32).to(cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(1))
    rc = RunConfig(act_dtype="float32")
    for kc in (False, True):
        c = dataclasses.replace(cfg, sparse_mode="dual", sparse_kv=True,
                                sparse_use_kernel=True, sparse_kcondense=kc,
                                sparse_block_t=8)
        n = (gsk.grouped_spgemm_kfused_planned if kc
             else gsk.grouped_spgemm_planned)
        before = n.launches
        want = serve_loop.generate(cpu, {"tokens": tokens}, c,
                                   max_new_tokens=6, capacity=48, rc=rc,
                                   device="cpu")
        got = serve_loop.generate(gpu, {"tokens": tokens}, c,
                                  max_new_tokens=6, capacity=48, rc=rc)
        assert n.launches == before + 2 * 2 * 5
        assert torch.equal(want, got.cpu())


CONV = [  # (N, H, W, C, kh, kw, stride)
    (4, 1, 3002, 80, 1, 3, 1),    # whisper-base conv1
    (2, 1, 3002, 64, 1, 3, 2),    # conv2's geometry, fewer channels
    (1, 7, 9, 3, 3, 3, 1),
    (2, 9, 10, 2, 3, 3, 2),
    (1, 56, 56, 3, 14, 14, 14),   # patch conv, k = s
    (1, 1, 66, 2, 1, 34, 1),      # dx >= 32: the window crosses words
    (1, 1, 65, 2, 1, 2, 1),       # OW = 64 ends on a word boundary
    (1, 1, 100, 2, 1, 33, 2),
    (1, 2, 96, 3, 2, 1, 1),
    (4, 1, 3002, 512, 1, 3, 2),   # whisper-base conv2, as served
    (1, 1, 70000, 2, 1, 3, 2),    # K7's feature route in pieces
    (2, 1, 500, 40, 1, 3, 3),     # stride 3; K5 with a part tile
    (1, 1, 5000, 2, 1, 4100, 2),  # K7's lowered route
]


def _raw(t: torch.Tensor) -> torch.Tensor:
    """Bit patterns, so that equality is bit-equality (-0.0 != 0.0)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("shape", CONV)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernels_match_plain(cuda, shape, dtype):
    """K5 on an NHWC view, then K6 (stride 1) or K7 on its outputs, each
    bit-equal to its plain version on the same inputs; inputs with
    all-zero and all-non-zero rows, -0.0 and bit 31 of words set."""
    n, h, w, c, kh, kw, s = shape
    g = torch.Generator().manual_seed(2)
    x = torch.randn(n, h, w, c, generator=g)
    x[torch.rand(x.shape, generator=g) < 0.5] = 0
    x[0, 0, :, 0] = 0
    x[..., 1::7, :] = -0.0
    x[-1, -1, :, -1] = 1.0
    if w >= 32:
        x[:, :, 31::32, ::2] = 1.5
    x = x.to(dtype).to(cuda)
    xv = x.permute(0, 3, 1, 2)
    before = (k5.bitmap_encode.launches, k67.sparse_im2col.launches,
              k67.sparse_im2col_strided.launches)
    bits, cond = k5.bitmap_encode(xv)
    pb, pc = k5.bitmap_encode_plain(xv)
    torch.cuda.synchronize()
    assert torch.equal(bits, pb) and torch.equal(_raw(cond), _raw(pc))
    if s == 1:
        got = k67.sparse_im2col(cond, bits, kh=kh, kw=kw)
        want = k67.sparse_im2col_plain(cond, bits, kh=kh, kw=kw)
    else:
        got = k67.sparse_im2col_strided(cond, bits, kh=kh, kw=kw, stride=s)
        want = k67.sparse_im2col_strided_plain(cond, bits, kh=kh, kw=kw,
                                               stride=s)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(_raw(got[1]), _raw(want[1]))
    after = (k5.bitmap_encode.launches, k67.sparse_im2col.launches,
             k67.sparse_im2col_strided.launches)
    assert after == (before[0] + 1, before[1] + (s == 1),
                     before[2] + (s != 1))


K6 = [  # ((N, H, W, C, kh, kw), K6's route)
    ((4, 1, 3002, 80, 1, 3), "feature"),     # whisper-base conv1
    ((1, 56, 56, 3, 14, 14), "feature"),     # the patch kernel at stride 1
    ((1, 7, 9, 3, 3, 3), "feature"),
    ((2, 9, 10, 2, 3, 3), "feature"),
    ((1, 1, 66, 2, 1, 34), "feature"),       # dx >= 32
    ((1, 1, 65, 2, 1, 2), "feature"),        # OW = 64
    ((1, 2, 96, 3, 2, 1), "feature"),
    ((2, 1, 500, 40, 1, 3), "feature"),
    ((1, 1, 70000, 2, 1, 3), "feature"),     # pieces of 127 output words
    ((1, 1, 9000, 2, 1, 1024), "feature"),   # the widest kernel it takes
    ((1, 1, 5000, 2, 1, 4100), "lowered"),   # kw past a piece
    ((1, 1, 4000, 2, 1, 1500), "lowered"),   # kw past 1024
]


def _k6_inputs(cuda, shape, dtype):
    """K5's outputs for a map with all-zero and all-non-zero rows, -0.0
    and bit 31 of words set."""
    n, h, w, c, _, _ = shape
    g = torch.Generator().manual_seed(5)
    x = torch.randn(n, h, w, c, generator=g)
    x[torch.rand(x.shape, generator=g) < 0.5] = 0
    x[0, 0, :, 0] = 0
    x[..., 1::7, :] = -0.0
    x[-1, -1, :, -1] = 1.0
    if w >= 32:
        x[:, :, 31::32, ::2] = 1.5
    return k5.bitmap_encode(x.to(dtype).to(cuda).permute(0, 3, 1, 2))


@pytest.mark.parametrize("case", K6)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_routes_match_plain(cuda, case, dtype):
    """K6 on each route bit-equal to its plain version, one launch."""
    shape, route = case
    n, h, w, c, kh, kw = shape
    assert k67.k6_route(n, c, h, w, kh, kw)[0] == route
    bits, cond = _k6_inputs(cuda, shape, dtype)
    before = k67.sparse_im2col.launches
    got = k67.sparse_im2col(cond, bits, kh=kh, kw=kw)
    want = k67.sparse_im2col_plain(cond, bits, kh=kh, kw=kw)
    torch.cuda.synchronize()
    assert k67.sparse_im2col.launches == before + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(_raw(got[1]), _raw(want[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_lowered_route_at_conv1(cuda, dtype, monkeypatch):
    """The lowered route, forced at whisper conv1's shape, agrees too."""
    shape = K6[0][0]
    bits, cond = _k6_inputs(cuda, shape, dtype)
    want = k67.sparse_im2col(cond, bits, kh=1, kw=3)
    monkeypatch.setattr(k67, "k6_route", lambda *args: ("lowered", 0))
    got = k67.sparse_im2col(cond, bits, kh=1, kw=3)
    plain = k67.sparse_im2col_plain(cond, bits, kh=1, kw=3)
    torch.cuda.synchronize()
    for out in (got, want):
        assert torch.equal(out[0], plain[0])
        assert torch.equal(_raw(out[1]), _raw(plain[1]))


@pytest.mark.parametrize("shape", [(2048, 4096), (1000, 700)])
def test_block_mask_on_card_matches_cpu(cuda, shape):
    """bf16 tile norms tie often; the card's mask equals the CPU's."""
    w = torch.randn(shape, generator=torch.Generator().manual_seed(4)).to(
        torch.bfloat16)
    want = pruning.block_mask(w, 0.5, block=(128, 128))
    got = pruning.block_mask(w.to(cuda), 0.5, block=(128, 128))
    assert got.is_cuda and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_routes_match_plain(cuda, dtype):
    """K5 on each route: the NHWC view (channels), the same map contiguous
    as NCHW and a view one element off a 16-byte boundary (rows), with
    non-zeros that straddle segment boundaries (128 columns)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 600, 64, generator=g)
    x[torch.rand(x.shape, generator=g) < 0.5] = 0
    x[0, 0, :, 0] = 0
    x[0, 0, 122:134, 0] = 1.0               # across segments 0 and 1
    x[0, 1, :, 1] = 0
    x[0, 1, 128, 1] = 2.0                   # first column of segment 1
    x[1, 2, :, 2] = 0
    x[1, 2, 255:257, 2] = 3.0               # across segments 1 and 2
    x[1, 0, :127, 3] = 0                    # a segment with one non-zero
    flat = torch.zeros(x.numel() + 1, dtype=dtype, device=cuda)
    flat[1:] = x.flatten().to(dtype)
    base = flat[1:].view(x.shape)
    nhwc = base.clone().permute(0, 3, 1, 2)
    views = {"channels": nhwc, "rows": nhwc.contiguous()}
    views["rows, misaligned"] = base.permute(0, 3, 1, 2)
    for what, xv in views.items():
        assert k5.encode_route(xv) == what.split(",")[0], what
        before = k5.bitmap_encode.launches
        bits, cond = k5.bitmap_encode(xv)
        pb, pc = k5.bitmap_encode_plain(xv)
        torch.cuda.synchronize()
        assert k5.bitmap_encode.launches == before + 1
        assert torch.equal(bits, pb), what
        assert torch.equal(_raw(cond), _raw(pc)), what


def test_whisper_generate_matches_cpu(cuda):
    """whisper-base-smoke's dual and dual+kcondense generate on the card
    (K5-K7 in the stem, K1/K2 everywhere) emit the CPU plain path's
    tokens, with every conv kernel launched once per stem conv."""
    cfg = smoke_config("whisper-base")
    cpu = tfm.init_model(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    gpu = tfm.init_model(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32).to(cuda)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 4), generator=g),
             "mel": torch.randn(2, 2 * cfg.encoder_len, cfg.n_mels,
                                generator=g).clamp(min=0)}
    rc = RunConfig(act_dtype="float32")
    for kc in (False, True):
        c = dataclasses.replace(cfg, sparse_mode="dual",
                                sparse_use_kernel=True, sparse_kcondense=kc)
        before = (k5.bitmap_encode.launches, k67.sparse_im2col.launches,
                  k67.sparse_im2col_strided.launches)
        want = serve_loop.generate(cpu, batch, c, max_new_tokens=5, rc=rc,
                                   device="cpu")
        got = serve_loop.generate(gpu, batch, c, max_new_tokens=5, rc=rc)
        assert (k5.bitmap_encode.launches, k67.sparse_im2col.launches,
                k67.sparse_im2col_strided.launches) == (
                    before[0] + 2, before[1] + 1, before[2] + 1)
        assert torch.equal(want, got.cpu())


@pytest.mark.parametrize("kc", [False, True])
def test_engine_matches_cpu(cuda, kc):
    """The smoke model behind the paged engine on the card (K1 + K3, or
    K2 + K4 with per-slot schedules) emits the CPU engine's tokens for
    staggered requests, with one K3 (K4) launch per site, layer and decode
    tick, and drains its pool."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving.engine import Engine, Request
    cfg = smoke_config("nemotron-4-340b")
    c = dataclasses.replace(cfg, sparse_mode="dual", sparse_use_kernel=True,
                            sparse_kcondense=kc, sparse_block_t=8)
    prompts = [[5, 6, 7], [11, 3, 9, 2, 4, 1, 1, 2, 9], [8], [2] * 17]
    grouped = (gsk.grouped_spgemm_kfused_planned if kc
               else gsk.grouped_spgemm_planned)
    outs, engines = [], []
    for dev in ("cpu", cuda):
        model = tfm.init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu", dtype=torch.float32).to(dev)
        eng = Engine(model, c, serve=ServeConfig(slots=3, capacity=40),
                     rc=RunConfig(act_dtype="float32"), device=dev)
        before = grouped.launches
        done = []
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
            done.extend(eng.step())
        done.extend(eng.run_to_completion())
        outs.append({r.uid: r.output for r in done})
        engines.append(eng)
        if dev != "cpu":
            assert grouped.launches == before + 2 * 2 * eng.decode_calls
    assert outs[0] == outs[1]
    assert engines[0].stats() == engines[1].stats()
    st = engines[1].stats()
    assert st["pages_free"] == st["pages_total"]


# the paper-evaluation entries (phase 13 of chip_smoke.py): on-the-fly
# planning then K1/K2, at a ragged shape and at a conv GEMM's block_n = 64
# (Cout = 64 clamps 128 to 64) with tens of thousands of rows
ON_THE_FLY = [  # (M, K, N, block_m, block_n, slice_k)
    (300, 520, 200, 256, 256, 128),
    (49284, 576, 64, 64, 128, 128),
]


@pytest.mark.parametrize("shape", ON_THE_FLY)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_the_fly_entries_match_plain(cuda, shape, dtype):
    from repro_torch.core import spgemm as csp
    m, k, n, bm, bn, sk = shape
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(m, k, device=cuda, generator=g).clamp(min=0)
    a[: m // 3] = 0                                   # empty row blocks
    b = torch.randn(k, n, device=cuda, generator=g)
    b[torch.rand(k, n, device=cuda, generator=g) < 0.5] = 0
    b[: k // 4] = 0                                   # dead k rows
    a, b = a.to(dtype), b.to(dtype)
    geom = dict(zip(("block_m", "block_n", "slice_k"),
                    pln.clamp_geometry(m, n, k, bm, bn, sk)))
    ks, counts = bsk.plan_slices(a, b, **geom)
    kp = pln.plan_kcondensed(pln.element_activity_lhs(a, geom["block_m"]),
                             pln.element_activity_rhs(b, geom["block_n"]),
                             geom["slice_k"])
    n1 = bsk.bitmap_spgemm_planned.launches
    n2 = bsk.bitmap_spgemm_kfused_planned.launches
    y1 = bsk.bitmap_spgemm(a, b, block_m=bm, block_n=bn, slice_k=sk)
    y2 = bsk.bitmap_spgemm_kfused(a, b, block_m=bm, block_n=bn, slice_k=sk)
    torch.cuda.synchronize()
    assert bsk.bitmap_spgemm_planned.launches == n1 + 1
    assert bsk.bitmap_spgemm_kfused_planned.launches == n2 + 1
    rtol = 1e-5 if dtype == torch.float32 else 1e-2
    for y, p in ((y1, bsk.bitmap_spgemm_planned_plain(a, b, ks, counts,
                                                      **geom)),
                 (y2, bsk.bitmap_spgemm_kfused_planned_plain(
                     a, b, kp.gk, kp.counts, **geom))):
        assert y.dtype == p.dtype == dtype
        scale = p.float().abs().max().item()
        assert (y.float() - p.float()).abs().max().item() <= rtol * scale
    res = csp.spgemm(a, b, block_m=bm, block_n=bn, block_k=256)
    if geom["block_m"] == bm and geom["block_n"] == bn:
        assert int(res.steps.sparse) == int(counts.sum())


def test_conv2d_dual_sparse_matches_conv2d_ref(cuda, monkeypatch):
    """VGG-16 conv4_3's channels and kernel (512 → 512, 3 x 3) on a
    12 x 12 map (the published 28 x 28 cut in depth only).  The oracle
    is cuDNN's float32 conv with TF32 off, as chip_smoke.py runs it."""
    from repro_torch.core import spconv
    from repro_torch.sparse import tape
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(1, 12, 12, 512, device=cuda, generator=g)
    x[..., torch.rand(512, device=cuda, generator=g) < 0.7] = 0
    x[:, :8] = 0                      # output positions 0-59 see only zeros
    w = torch.randn(3, 3, 512, 512, device=cuda, generator=g)
    w[torch.rand(w.shape, device=cuda, generator=g) < 0.7] = 0
    n5, n6 = k5.bitmap_encode.launches, k67.sparse_im2col.launches
    n1 = bsk.bitmap_spgemm_planned.launches
    with tape.collect() as entries:
        res = spconv.conv2d_dual_sparse(x, w, 1, block_m=32, block_n=128,
                                        block_k=128, use_kernel=True)
    torch.cuda.synchronize()
    assert (k5.bitmap_encode.launches, k67.sparse_im2col.launches,
            bsk.bitmap_spgemm_planned.launches) == (n5 + 1, n6 + 1, n1 + 1)
    [e] = tape.summarize(entries)
    assert e["executed_steps"] == e["sparse_steps"] < e["dense_steps"]
    ref = spconv.conv2d_ref(x, w, 1)
    assert (res.out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_jamba_mamba_layer_matches_cpu(cuda):
    """One full-width jamba Mamba block (d_inner 16384, 256 SSD heads,
    state 128) in float32: a prefill of 130 tokens (past two chunks of
    64, so the dt = 0 padding runs) and two decode steps on the card
    against the same on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = get_config("jamba-1.5-large-398b")
    cpu = ssm.Mamba(cfg, dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    cpu.reset_parameters(g)
    with torch.no_grad():
        for p in (cpu.dt_bias, cpu.conv_b):
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    gpu = ssm.Mamba(cfg, device=cuda, dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    x = 0.5 * torch.randn(1, 132, cfg.d_model, generator=g)

    def run(m, xs):
        y, st = ssm.mamba_forward(m, xs[:, :130], cfg, return_state=True)
        outs = [y]
        for t in (130, 131):
            y, st = ssm.mamba_step(m, xs[:, t:t + 1], cfg, st)
            outs.append(y)
        return torch.cat(outs, 1), st

    want, wst = run(cpu, x)
    got, gst = run(gpu, x.to(cuda))
    assert torch.isfinite(got).all()
    for a, b in ((got, want), (gst.state, wst.state), (gst.conv, wst.conv)):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), err


def test_tied_head_dispatch_matches_plain(cuda):
    """mamba2-370m's tied head (embed.T, K = 1024, N = 50280: a ragged
    last N tile) through K1 in dual mode, planned per call, against the
    plain walk on the CPU in bf16; the model has no layers, so the head
    is all it runs."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=0,
                              sparse_mode="dual", sparse_use_kernel=True)
    cpu = tfm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.bfloat16)
    gpu = tfm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.bfloat16).to(cuda)
    assert cpu.lm_head is None
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    before = bsk.bitmap_spgemm_planned.launches
    got = gpu({"tokens": tokens.to(cuda)}, cfg).logits
    assert bsk.bitmap_spgemm_planned.launches == before + 1
    want = cpu({"tokens": tokens}, cfg).logits
    assert got.shape == (2, 40, 50280)
    err = (got.float().cpu() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


def test_vision_frontend_matches_cpu(cuda):
    """llama-3.2-vision-90b's patch-conv frontend at full width (two 560²
    images, 14² patches, d_model 8192, 1601 tokens with the cls token) in
    dual mode, float32: K5 → K7 → K1 on the card, one launch each,
    against the plain chain on the CPU."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import frontend as fem
    cfg = dataclasses.replace(get_config("llama-3.2-vision-90b"),
                              sparse_mode="dual", sparse_use_kernel=True)
    g = torch.Generator().manual_seed(0)
    cpu = fem.VisionFrontend(cfg, dtype=torch.float32)
    cpu.reset_parameters(g)
    with torch.no_grad():
        cpu.bias.copy_(0.1 * torch.randn(cfg.d_model, generator=g))
    gpu = copy.deepcopy(cpu).to(cuda)
    images = torch.randn(2, 560, 560, 3, generator=g).clamp(min=0)
    kernels = (k5.bitmap_encode, k67.sparse_im2col_strided,
               bsk.bitmap_spgemm_planned)
    before = [k.launches for k in kernels]
    got = fem.vision_frontend(gpu, images.to(cuda), cfg)
    assert [k.launches - n for k, n in zip(kernels, before)] == [1, 1, 1]
    want = fem.vision_frontend(cpu, images, cfg)
    assert got.shape == (2, 1601, 8192)
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


# ---------------------------------------------------------------------------
# the tuner on the card: every knob vector knobs_valid admits launches
# ---------------------------------------------------------------------------

def _admitted(m, n, k, dtype_bytes, grouped):
    """The card's lattice of the tuner (backend x block_m x block_n x
    slice_k) as ``knobs_valid`` admits it for the kernel backends."""
    from repro_torch.sparse import autotune as atn
    bms, bns, sks = atn.lattice(m, n, k)
    out = []
    for backend in ("kernel", "kfused"):
        for bm in bms:
            for bn in bns:
                for sk in sks:
                    kn = atn.Knobs(backend, bm, bn, sk)
                    if kn.valid_for(m, n, k, dtype_bytes=dtype_bytes,
                                    grouped=grouped):
                        out.append(kn)
    return out


@pytest.mark.parametrize("mnk", [(64, 2048, 2048), (2, 2048, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_admitted_knobs_launch_and_match_plain(cuda, mnk, dtype):
    """K1/K2 and K3/K4 (E = 4) at every admitted vector of the tuner's
    lattice — block_m 8..64 (the clamp at M), block_n 128..512, slice_k
    32..256 — launch and agree with their plain walks."""
    m, n, k = mnk
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(4, m, k, device=cuda, generator=g).clamp(min=0).square()
    a[:, :, : k // 4] = 0                        # skipped slices
    b = torch.randn(4, k, n, device=cuda, generator=g)
    b[torch.rand(4, k, n, device=cuda, generator=g) < 0.5] = 0
    b[:, :, :128] = 0                            # counts == 0 tiles
    a, b = a.to(dtype), b.to(dtype)
    rtol = 1e-5 if dtype == torch.float32 else 1e-2
    db = 4 if dtype == torch.float32 else 2
    tried = 0
    for grouped in (False, True):
        kns = _admitted(m, n, k, db, grouped)
        assert {kn.block_n for kn in kns} == {128, 256, 512}
        assert {kn.slice_k for kn in kns} == {32, 64, 128, 256}
        for kn in kns:
            aa, bb = (a, b) if grouped else (a[:1], b[:1])
            bm, bn, sk = pln.clamp_geometry(m, n, k, kn.block_m, kn.block_n,
                                            kn.slice_k)
            geom = dict(block_m=bm, block_n=bn, slice_k=sk)
            if kn.backend == "kernel":
                ks, counts = pln.plan_from_activity(
                    pln.block_reduce_lhs(pln.slice_activity_lhs(aa, sk), bm),
                    pln.block_reduce_rhs(pln.slice_activity_rhs(bb, sk), bn))
            else:
                kp = pln.plan_kcondensed(pln.element_activity_lhs(aa, bm),
                                         pln.element_activity_rhs(bb, bn),
                                         sk)
                ks, counts = kp.gk, kp.counts
            if grouped:
                kern = (gsk.grouped_spgemm_planned if kn.backend == "kernel"
                        else gsk.grouped_spgemm_kfused_planned)
                y = kern(aa, bb, ks, counts, **geom)
            else:
                kern = (bsk.bitmap_spgemm_planned if kn.backend == "kernel"
                        else bsk.bitmap_spgemm_kfused_planned)
                y = kern(aa[0], bb[0], ks[0], counts[0], **geom)[None]
            walk = (bsk.walk_slices if kn.backend == "kernel"
                    else bsk.walk_gathers)
            p = walk(aa, bb, ks, counts, **geom)
            torch.cuda.synchronize()
            scale = p.float().abs().max().item()
            err = (y.float() - p.float()).abs().max().item()
            assert err <= rtol * scale, (kn, grouped, err, scale)
            tried += 1
    assert tried >= (96 if m > 8 else 24)


def test_card_timer_spans_host_time(cuda, monkeypatch):
    """The tuner's card timer times the whole dispatch call: a planner
    stubbed to sleep 5 ms shows up in it."""
    import time as _time
    from repro_torch.sparse import autotune as atn
    from repro_torch.sparse import dispatch as dsp
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(64, 1024, device=cuda, generator=g).clamp(
        min=0).bfloat16()
    w = torch.randn(1024, 1024, device=cuda, generator=g).bfloat16()

    def call():
        dsp.matmul(x, w, mode="dual", use_kernel=True, block_m=64,
                   block_n=128, slice_k=128)
    base = atn.card_timer(call, warmup=1, repeat=5)
    orig = dsp.schedule

    def slow(*a, **kw):
        _time.sleep(0.005)
        return orig(*a, **kw)
    monkeypatch.setattr(dsp, "schedule", slow)
    slowed = atn.card_timer(call, warmup=1, repeat=5)
    assert slowed - base >= 4500, (base, slowed)


def test_kernel_error_propagates_from_site(cuda):
    """On the card a kernel's own error leaves ``site.matmul`` and
    quarantines nothing: K1 writes float32 or bfloat16, so a site pinned
    to a float16 output makes its wrapper raise."""
    from repro_torch.sparse import site
    cfg = dataclasses.replace(smoke_config("nemotron-4-340b"),
                              sparse_mode="dual", sparse_use_kernel=True)
    st = site.make("matmul", "card.float16_out", out_dtype="float16")
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(8, 256, device=cuda, generator=g).clamp(min=0).bfloat16()
    w = torch.randn(256, 256, device=cuda, generator=g).bfloat16()
    n1 = bsk.bitmap_spgemm_planned.launches
    with pytest.raises(TypeError, match="kernel writes float32 or bfloat16"):
        site.matmul(x, w, st, cfg)
    assert bsk.bitmap_spgemm_planned.launches == n1
    assert site.quarantine_report() == {}


TRAIN_ARCHS = ("chatglm3-6b", "mixtral-8x7b", "mamba2-370m", "whisper-base",
               "llama-3.2-vision-90b")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_cpu(cuda, arch, monkeypatch):
    """One train step of the smoke model in float32 compute (TF32 off) on
    the card against the CPU: gradients within 1e-4 x max|g|, the loss
    and the updated parameters alike."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import model_zoo
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = smoke_config(arch)
    rc = RunConfig(microbatches=2, learning_rate=1e-3, warmup_steps=2,
                   act_dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticTokens(
        cfg.vocab_size, 4, 16, seed=0).batch_at(0).items()}
    batch.update(model_zoo.frontend_inputs(cfg, 4, dtype=torch.float32,
                                           device="cpu"))
    cpu = model_zoo.build_model(cfg, 0, device="cpu")
    gpu = model_zoo.build_model(cfg, 0, device="cpu").to(cuda)
    g_cpu, l_cpu = tl.make_grad_fn(cfg, rc)(cpu.requires_grad_(True), batch)
    g_gpu, l_gpu = tl.make_grad_fn(cfg, rc)(
        gpu.requires_grad_(True), {k: v.to(cuda) for k, v in batch.items()})
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    for n, g in g_cpu.items():
        assert (g_gpu[n].cpu() - g).abs().max().item() <= 1e-4 * gmax, n
    assert abs(l_gpu.item() - l_cpu.item()) <= 1e-5 * abs(l_cpu.item())
    step = tl.make_train_step(cfg, rc)
    states = [opt.init_opt_state(dict(m.named_parameters()), rc)
              for m in (cpu, gpu)]
    _, _, _, m_cpu = step(cpu, states[0], None, batch)
    _, _, _, m_gpu = step(gpu, states[1], None,
                          {k: v.to(cuda) for k, v in batch.items()})
    assert torch.isfinite(m_gpu["loss"]) and m_gpu["grad_norm"].item() > 0
    assert abs(m_gpu["grad_norm"].item() - m_cpu["grad_norm"].item()) <= \
        1e-4 * gmax


def test_gradient_through_a_kernel_raises_on_card(cuda):
    """As ``jax.grad`` raises through ``pallas_call``: the train step in
    dual mode with the kernel raises, K1 launches nothing and no site is
    quarantined; serving the same weights still launches K1."""
    from repro_torch.models import model_zoo
    from repro_torch.sparse import site
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl
    cfg = dataclasses.replace(smoke_config("nemotron-4-340b"),
                              sparse_mode="dual", sparse_use_kernel=True)
    rc = RunConfig(act_dtype="float32")
    model = model_zoo.build_model(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), device=cuda)
    batch = {"tokens": toks, "labels": toks}
    state = opt.init_opt_state(dict(model.named_parameters()), rc)
    n1 = bsk.bitmap_spgemm_planned.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        tl.make_train_step(cfg, rc)(model, state, None, batch)
    assert bsk.bitmap_spgemm_planned.launches == n1
    assert site.quarantine_report() == {}
    out = serve_loop.generate(model, {"tokens": toks}, cfg, max_new_tokens=2,
                              rc=rc, device=cuda)
    assert out.shape == (2, 2) and bsk.bitmap_spgemm_planned.launches > n1


RESTART_CHILD = """
import os, sys
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
import numpy as np, torch
torch.use_deterministic_algorithms(True)
from repro_torch.launch import train
root = sys.argv[1]
args = ["--arch", "chatglm3-6b", "--smoke", "--global-batch", "8", "--seq",
        "16", "--ckpt-every", "1"]
train.main(args + ["--steps", "6", "--ckpt-dir", root + "/ref"])
train.main(args + ["--steps", "3", "--ckpt-dir", root + "/ft"])
train.main(args + ["--steps", "6", "--ckpt-dir", root + "/ft"])
ref = np.load(root + "/ref/step_00000006/arrays-00000.npz")
ft = np.load(root + "/ft/step_00000006/arrays-00000.npz")
assert sorted(ref.files) == sorted(ft.files)
print("bitwise", all(np.array_equal(ref[k], ft[k]) for k in ref.files))
"""


def test_deterministic_restart_on_card(cuda, tmp_path):
    """The launcher stopped after 3 of 6 steps and resumed ends in the
    state the uninterrupted run ends in, bit for bit, with deterministic
    CUDA (set in a fresh process, before cuBLAS first runs)."""
    import os
    import pathlib
    import subprocess
    import sys
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", RESTART_CHILD, str(tmp_path)],
                         env=dict(os.environ, PYTHONPATH=str(src)),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "resumed from step 3" in out.stdout
    assert out.stdout.rstrip().endswith("bitwise True"), out.stdout


NCCL_CHILD = """
import dataclasses
import torch
from repro_torch.configs import smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import bitmap_spgemm as bsk
from repro_torch.kernels import grouped_spgemm as gsk
from repro_torch.launch import mesh as meshmod
from repro_torch.models import moe as moem
from repro_torch.models import nn as tnn
torch.backends.cuda.matmul.allow_tf32 = False
dev = meshmod.init_distributed("cuda")
assert torch.distributed.get_backend() == "nccl"
mesh = meshmod.make_host_mesh()
rules = shd.make_rules("decode")
cfg = dataclasses.replace(smoke_config("qwen3-moe-235b-a22b"),
                          sparse_mode="dual", sparse_use_kernel=True)
g = torch.Generator(device=dev).manual_seed(0)
whole = moem.MoE(cfg, device=dev, dtype=torch.float32)
whole.reset_parameters(g)
sharded = moem.MoE(cfg, device=dev, dtype=torch.float32)
with torch.no_grad():
    for a, b in zip(sharded.parameters(), whole.parameters()):
        a.copy_(b)
moem.shard_moe_(sharded, cfg, mesh, rules)
x = torch.randn(2, 7, cfg.d_model, device=dev, generator=g)
y0, aux0 = moem.moe_forward(whole, x, cfg)
real, held = bsk.run, []
def run(src, plain, a, b, sched, counts, **kw):
    y = real(src, plain, a, b, sched, counts, **kw)
    kw.pop("kfused"), kw.pop("device")
    p = plain(a, b, sched, counts, **kw)
    held.append((src, float((y - p).abs().max() / p.abs().max().clamp(min=1e-30))))
    return y
bsk.run = run
n3 = gsk.grouped_spgemm_planned.launches
with tnn.axis_rules(rules, mesh=mesh):
    y1, aux1 = moem.moe_forward(sharded, x, cfg,
                                plans=moem.shard_plans(sharded, cfg))
bsk.run = real
assert gsk.grouped_spgemm_planned.launches - n3 == 3, held
assert [h[0] for h in held] == ["grouped_spgemm.cu"] * 3, held
assert max(h[1] for h in held) <= 1e-5, held
err = float((y1 - y0).abs().max() / y0.abs().max())
assert err <= 1e-5 and abs(float(aux1 - aux0)) <= 1e-6, (err, aux0, aux1)
torch.distributed.destroy_process_group()
print("ok", err)
"""


def test_one_rank_nccl_moe_matches_no_mesh(cuda):
    """A one-rank NCCL group's MoE under the host mesh and the decode
    rules (the TP branch at tp = 1) equals the same MoE with no mesh, and
    each of its K3 launches equals K3's plain walk."""
    import os
    import pathlib
    import subprocess
    import sys
    from repro_torch.testing import sharded_moe as sm
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src), RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(sm.free_port()))
    out = subprocess.run([sys.executable, "-c", NCCL_CHILD], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "1 ranks over nccl" in out.stdout
    assert out.stdout.split()[-2] == "ok", out.stdout


def test_quarantine_report_empty_after_module(cuda):
    """No site of any test above degraded to its plain arm: on the card a
    quarantine is a kernel failure."""
    from repro_torch.sparse import site
    assert site.quarantine_report() == {}
