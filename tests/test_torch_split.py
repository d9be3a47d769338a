"""K1/K2's split schedules, on the CPU: the wrapper's split helpers and
the plain walk summed over the splits the tensor-core kernel walks.

``split_ranges`` must cut every tile's steps ``[0, min(counts, S))`` into
contiguous shares that cover each step exactly once; ``split_count`` must
not split once the tiles fill two waves of SMs.  Summing the plain walk of
each share's steps in split order (the order of the kernel's second
launch) equals the whole walk within 1e-6 of its largest output in
float32: the shares' float32 sums only regroup the same products.
"""
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.kernels import bitmap_spgemm as bsk  # noqa: E402
from repro_torch.sparse import plan as pln  # noqa: E402

torch.set_num_threads(1)

H100_SMS = 132


@settings(max_examples=200, deadline=None)
@given(counts=st.lists(st.integers(0, 40), min_size=1, max_size=24),
       s=st.integers(1, 32), splits=st.integers(1, 12))
def test_split_ranges_partition_each_tile_once(counts, s, splits):
    c = torch.tensor(counts, dtype=torch.int32).view(1, -1, 1)
    t0, t1 = bsk.split_ranges(c, s, splits)
    assert t0.shape == t1.shape == (splits,) + tuple(c.shape)
    steps = c.to(torch.int64).clamp(max=s)
    # contiguous, in order: share q starts where share q - 1 ended
    assert (t0[0] == 0).all() and (t1[-1] == steps).all()
    assert (t0[1:] == t1[:-1]).all() and (t1 >= t0).all()
    # so every step t < min(counts, S) is walked by exactly one share
    t = torch.arange(s + 1).view(-1, 1, 1, 1, 1)
    walked = ((t >= t0) & (t < t1)).sum(1)              # (S+1, 1, X, 1)
    assert torch.equal(walked, (t[:, 0] < steps).long())
    # and the shares are as even as ceil allows
    assert ((t1 - t0) <= -(-steps // splits)).all()


@settings(max_examples=200, deadline=None)
@given(blocks=st.integers(0, 5000), s=st.integers(1, 600),
       sms=st.integers(1, 200), m=st.integers(1, 8192),
       k=st.integers(8, 80000))
def test_split_count(blocks, s, sms, m, k):
    splits = bsk.split_count(blocks, s, sms, m=m, k=k)
    assert splits >= 1
    if blocks >= bsk.SPLIT_BELOW_WAVES * sms or blocks == 0:
        assert splits == 1                  # the tiles fill two waves
    if splits > 1:
        assert blocks * (splits - 1) < bsk.SPLIT_WAVES * sms
        assert splits * bsk.MIN_SPLIT_STEPS <= s
        assert splits * m * 8 <= 2 * k // 4


@pytest.mark.parametrize("m,k,n,geom,want", [
    # nemotron-4-340b decode and prefill on an H100 (132 SMs)
    (2, 18432, 1536, (8, 128, 128), 18),       # attn.k/v: 12 tiles
    (2, 18432, 18432, (8, 128, 128), 8),       # attn.q/o: 144 tiles
    (2, 73728, 18432, (8, 128, 128), 8),       # mlp.down
    (2, 18432, 73728, (8, 128, 128), 1),       # mlp.up: 576 tiles
    (64, 18432, 1536, (64, 128, 128), 18),     # 8 steps a share
    (64, 18432, 256000, (64, 128, 128), 1),    # lm_head: 2000 tiles
    # whisper-base's encoder: 6000 rows never split
    (6000, 2048, 512, (128, 128, 128), 1),
    (6000, 512, 512, (128, 128, 128), 1),
])
def test_split_count_at_served_shapes(m, k, n, geom, want):
    bm, bn, sk = geom
    mt, nt, s = -(-m // bm), -(-n // bn), -(-k // sk)
    blocks = bsk.mma_blocks(1, mt, nt, bm, bn)
    assert bsk.split_count(blocks, s, H100_SMS, m=m, k=k) == want


def test_mma_blocks_cover_each_tile():
    # rows per CUDA block: the smallest of 16/32/64/128 holding block_m
    assert bsk.mma_blocks(1, 3, 5, 8, 128) == 15
    assert bsk.mma_blocks(1, 3, 5, 37, 12) == 15
    assert bsk.mma_blocks(2, 3, 5, 256, 256) == 2 * 3 * 2 * 5 * 2


def _operands(rng, m, k, n, bn):
    """relu2 activations and block-pruned weights: where N spans several
    column blocks, a counts == 0 tile beside tiles with many steps."""
    a = np.square(np.maximum(rng.normal(size=(m, k)), 0)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    if n > bn:
        b[:, :bn] = 0
    b[rng.random((k, n)) < 0.5] = 0
    return torch.from_numpy(a), torch.from_numpy(b)


def _share(sched, counts, t0, t1):
    """The schedule of one share: its steps front-packed, its counts."""
    s = sched.shape[3]
    u = torch.arange(s).view(1, 1, 1, s)
    idx = (t0[..., None] + u).clamp(max=s - 1)
    if sched.ndim == 5:
        idx = idx[..., None].expand(*idx.shape, sched.shape[4])
    return torch.gather(sched, 3, idx), (t1 - t0).to(torch.int32)


# (M, K, N, block_m, block_n, slice_k): slice_k 40 and 96 (not multiples
# of 16), block_m 37, N = 300, and N <= block_n with a deep K
SPLIT_SHAPES = [
    (37, 400, 300, 37, 128, 40),
    (2, 4096, 96, 8, 128, 96),
    (20, 960, 40, 8, 16, 96),
    (3, 2048, 128, 8, 128, 128),
]


@pytest.mark.parametrize("kfused", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
@pytest.mark.parametrize("splits", [2, 3, 7])
def test_split_walks_sum_to_the_whole_walk(shape, splits, kfused):
    m, k, n, bm, bn, sk = shape
    a, b = _operands(np.random.default_rng(splits), m, k, n, bn)
    bm, bn, sk = pln.clamp_geometry(m, n, k, bm, bn, sk)
    if kfused:
        kp = pln.plan_kcondensed(pln.element_activity_lhs(a, bm),
                                 pln.element_activity_rhs(b, bn), sk)
        sched, counts, walk = kp.gk[None], kp.counts[None], bsk.walk_gathers
    else:
        ks, counts = pln.plan_from_activity(
            pln.block_reduce_lhs(pln.slice_activity_lhs(a, sk), bm),
            pln.block_reduce_rhs(pln.slice_activity_rhs(b, sk), bn))
        sched, counts, walk = ks[None], counts[None], bsk.walk_slices
    assert (counts == 0).any() or counts.numel() == 1
    assert int(counts.max()) >= splits
    kw = dict(block_m=bm, block_n=bn, slice_k=sk, out_dtype=torch.float32)
    whole = walk(a[None], b[None], sched, counts, **kw)
    t0, t1 = bsk.split_ranges(counts, sched.shape[3], splits)
    total = None
    for q in range(splits):                   # the kernel's order
        part = walk(a[None], b[None], *_share(sched, counts, t0[q], t1[q]),
                    **kw)
        total = part if total is None else total + part
    scale = whole.abs().max().item()
    assert scale > 0
    assert (total - whole).abs().max().item() <= 1e-6 * scale
