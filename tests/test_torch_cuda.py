"""K1/K2 on the card against their plain versions (needs an NVIDIA GPU
with nvcc; skipped elsewhere).  Run there with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed.  Tolerance, relative to the largest plain output: 1e-5 for a
float32 output (the same float32 products summed in another order), 1e-2
for bf16 (one bf16 rounding of sums that may differ in their last float32
bits).
"""
import pytest
import torch

from repro_torch.kernels import bitmap_spgemm as bsk
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
