"""K1-K7, the sparse-KV decode and the whisper path on the card against
their plain versions (needs an NVIDIA GPU with nvcc; skipped elsewhere).  Run there with
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
]


@pytest.mark.parametrize("shape", NARROW)
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_grouped_narrow_route_matches_plain(cuda, shape, out_dtype):
    """bf16 products of at most 16 columns: the narrow-N tensor-core
    kernel, N in {1, 8, 12, 16}."""
    a, b, ks, counts, kp, geom = _grouped_case(cuda, *shape, torch.bfloat16)
    assert _route(a, b, geom) == ("narrow", 1)
    pairs = _grouped_pairs(a, b, ks, counts, kp, geom, out_dtype)
    for y, _ in pairs:
        assert not y[2].any()
    _assert_close(pairs, out_dtype or torch.bfloat16)


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
