"""K5's, K6's and K7's routes on the CPU: the rules that pick each CUDA
route, and NumPy models of the routes' bit arithmetic held against the
bit-by-bit definitions and the plain versions.

The CUDA kernels cannot run here.  The models below repeat their index
arithmetic step for step (K5's channels route: segment words and counts,
then each segment's offset in its condensed row and its share of the zero
tail; K7's feature route: the staged piece of words and values, the S3
prefix and the carry into the next piece, the stride-2 fold, the S4 word
prefix and the copy; K6's feature route: the staged piece, each dx's
window words, length and offset, the carry, and the copy of each run in
aligned 16-byte chunks put together from two staged 16-byte loads), with
staged arrays cut to the sizes the kernels stage, so that an index past
them fails.  Everything is exact: the kernels only move raw bits, so
outputs compare as bit patterns.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import im2col as ti2c
from repro_torch.kernels import bitmap_encode as k5
from repro_torch.kernels import sparse_im2col as k67

torch.set_num_threads(1)

M32, M64 = (1 << 32) - 1, (1 << 64) - 1
SENTINEL = 0x5A5A  # marks an output element no step wrote


def _popc(x) -> int:
    return bin(int(x)).count("1")


def _below(b: int) -> int:
    return (1 << b) - 1


def _raw(t: torch.Tensor) -> np.ndarray:
    """Bit patterns of a bf16 / float32 tensor as unsigned numpy ints."""
    if t.element_size() == 2:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.view(torch.int32).numpy().view(np.uint32)


def _mag(raw: np.ndarray) -> int:
    return 0x7FFF if raw.dtype == np.uint16 else 0x7FFFFFFF


# ---------------------------------------------------------------------------
# the route rules
# ---------------------------------------------------------------------------

def _stem_view(n, t, c, dtype):
    """The served K5 call's view: the stem's time-padded NHWC input as
    (N, C, H, W)."""
    x = torch.zeros(n, t, c, dtype=dtype)
    return F.pad(x[:, None], (0, 0, 1, 1)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_encode_route_rule(dtype):
    conv1, conv2 = _stem_view(4, 3000, 80, dtype), _stem_view(4, 3000, 512,
                                                               dtype)
    assert tuple(conv1.shape) == (4, 80, 1, 3002)
    for x, blocks in ((conv1, 288), (conv2, 1536)):
        assert k5.encode_route(x) == "channels"
        assert k5.encode_blocks(x, "channels") == blocks >= 132
    assert k5.encode_route(conv1.contiguous()) == "rows"       # NCHW
    for c in (2, 3):
        assert k5.encode_route(_stem_view(2, 100, c, dtype)) == "rows"
    flat = torch.zeros(4 * 1 * 3002 * 80 + 1, dtype=dtype)
    shifted = flat[1:].view(4, 1, 3002, 80).permute(0, 3, 1, 2)
    assert shifted.data_ptr() % 16 and k5.encode_route(shifted) == "rows"
    # channels that 16-byte loads cannot take whole, C below a tile
    odd = 36 if dtype == torch.bfloat16 else 34
    assert k5.encode_route(_stem_view(1, 64, odd, dtype)) == "rows"
    assert k5.encode_route(_stem_view(1, 64, 16, dtype)) == "rows"
    assert k5.encode_route(_stem_view(1, 64, 32, dtype)) == "channels"
    assert k5.encode_blocks(conv1, "rows") == 40


def test_strided_route_rule():
    # (N, C, H, W, kh, kw, stride) -> (route, output words a piece)
    cases = {
        (4, 512, 1, 3002, 1, 3, 2): ("feature", 47),   # whisper conv2
        (1, 1, 1, 70000, 1, 3, 2): ("feature", 63),    # pieces
        (1, 3, 560, 560, 14, 14, 14): ("feature", 2),  # the patch conv
        (1, 2, 1, 5000, 1, 3, 3): ("feature", 42),
        (1, 2, 1, 5000, 1, 4100, 2): ("lowered", 0),   # kw past a piece
        (1, 2, 1, 9000, 1, 3, 200): ("lowered", 0),    # stride past it
        (1, 1, 1, 9000, 1, 1500, 2): ("lowered", 0),   # kw > 1024 words
    }
    for (n, c, h, w, kh, kw, s), want in cases.items():
        assert k67.strided_route(n, c, h, w, kh, kw, s) == want


# ---------------------------------------------------------------------------
# K5's channels route
# ---------------------------------------------------------------------------

def k5_channels_model(raw: np.ndarray):
    """K5's channels route on rows (R, W) of raw element bits: pass 1
    writes each segment's words and count, pass 2 places the
    segment's values after the counts of the row's earlier segments and
    zeroes the part of the row's tail in its own columns."""
    r_, w = raw.shape
    seg, mag = k5.SEG, _mag(raw)
    nseg, ww = -(-w // seg), -(-w // 32)
    bits = np.full((r_, ww), SENTINEL, np.uint64)
    counts = np.full((r_, nseg), -1, np.int64)
    cond = np.full((r_, w), SENTINEL, raw.dtype)
    lanes = np.arange(32)
    words = {}
    for r in range(r_):
        for s in range(nseg):                                    # pass 1
            col0, ncols = s * seg, min(seg, w - s * seg)
            cnt = 0
            for q in range(-(-ncols // 32)):
                col = q * 32 + lanes
                v = raw[r, col0 + np.minimum(col, ncols - 1)]
                nz = (col < ncols) & ((v & mag) != 0)
                word = int((nz.astype(np.uint64) << lanes.astype(
                    np.uint64)).sum())
                words[r, s, q] = word
                bits[r, s * (seg // 32) + q] = word
                cnt += _popc(word)
            counts[r, s] = cnt
    for r in range(r_):
        for s in range(nseg):                                    # pass 2
            col0, ncols = s * seg, min(seg, w - s * seg)
            before, total = counts[r, :s].sum(), counts[r].sum()
            run = before
            for q in range(-(-ncols // 32)):
                word = words[r, s, q]
                for lane in range(32):
                    if word >> lane & 1:
                        cond[r, run + _popc(word & _below(lane))] = \
                            raw[r, col0 + q * 32 + lane]
                run += _popc(word)
            for i in range(max(total, col0), col0 + ncols):
                cond[r, i] = 0
    return bits, cond


@pytest.mark.parametrize("w", [31, 32, 33, 127, 128, 129, 300, 543])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_channels_model_matches_plain(w, dtype):
    """Rows whose non-zeros straddle word (31/32) and segment (127/128)
    boundaries, all-zero and all-non-zero rows, -0.0 and NaN."""
    rng = np.random.default_rng(w)
    x = rng.standard_normal((6, w)).astype(np.float32)
    x[rng.random(x.shape) < 0.5] = 0
    x[0] = 0                                        # all zero
    x[1] = 1.5                                      # all non-zero
    x[2, :] = 0
    x[2, max(0, w - 3):] = 2.0                      # only the last few
    for b in (31, 32, 127, 128, 256):
        if b < w:
            x[3, b] = 3.0                           # on the boundaries
            x[4, b - 1: b + 1] = 0
    x[5, ::7] = -0.0
    x[5, 3::11] = np.nan
    xt = torch.from_numpy(x).to(dtype)
    bits, cond = k5_channels_model(_raw(xt))
    pb, pc = k5.bitmap_encode_plain(xt)
    np.testing.assert_array_equal(bits, pb.numpy().view(np.uint32))
    np.testing.assert_array_equal(cond, _raw(pc))


# ---------------------------------------------------------------------------
# K7's feature route
# ---------------------------------------------------------------------------

def even_bits(sw: np.ndarray, nwords: int, q: int, r: int) -> int:
    """The stride-2 fold: bits r, r+2, ..., r+62 of staged words q, q+1,
    q+2 (zero from nwords on), compressed to one 32-bit word."""
    def at(i):
        return int(sw[i]) if i < nwords else 0
    x = at(q) | at(q + 1) << 32
    if r:
        x = (x >> r) | ((at(q + 2) << (64 - r)) & M64)
    x &= 0x5555555555555555
    for sh, m in ((1, 0x3333333333333333), (2, 0x0F0F0F0F0F0F0F0F),
                  (4, 0x00FF00FF00FF00FF), (8, 0x0000FFFF0000FFFF),
                  (16, 0x00000000FFFFFFFF)):
        x = (x | x >> sh) & m
    return x


@pytest.mark.parametrize("dx", [0, 1, 31, 32, 33])
@pytest.mark.parametrize("tail", [0, 1, 31])
def test_even_bits_fold_is_the_strided_bits(dx, tail):
    """Output word j of an output row at stride 2 holds feature bits
    64j + dx + 2i, i < 32, masked to OW; the fold gives exactly those."""
    rng = np.random.default_rng(dx * 32 + tail)
    pattern = [0, M32, 1 << 31, *rng.integers(0, M32, 5, dtype=np.uint64)]
    words = np.array(pattern * 2, np.uint64)              # 14 words
    w = 32 * len(words)
    feat = [(int(words[c >> 5]) >> (c & 31)) & 1 for c in range(w)]
    ow = (w - dx - 1) // 2 + 1
    ow -= (ow - tail) % 32                              # OW % 32 == tail
    for j in range(-(-ow // 32)):
        cb = 64 * j + dx
        got = even_bits(words, len(words), cb >> 5, cb & 31)
        if j == -(-ow // 32) - 1 and ow % 32:
            got &= _below(ow % 32)
        want = sum(feat[(32 * j + i) * 2 + dx] << i for i in range(32)
                   if 32 * j + i < ow)
        assert got == want, (j, hex(got), hex(want))


def k7_feature_model(cond_raw, bits, kh, kw, s, pj):
    """K7's feature route, block by block (image, channel, dy), piece by
    piece, as ``feature_rows_kernel`` walks it."""
    n, c, h, w = cond_raw.shape
    ww = bits.shape[-1]
    oh, ow = ti2c.out_size(h, kh, s), ti2c.out_size(w, kw, s)
    oww, p = -(-ow // 32), oh * ow
    tail = _below(ow % 32) if ow % 32 else M32
    out_bits = np.full((n, kh * kw * c, oh, oww), SENTINEL, np.uint64)
    out_vals = np.full((n, kh * kw * c, p), SENTINEL, cond_raw.dtype)
    for img in range(n):
        for dy in range(kh):
            for ci in range(c):
                krow = [(dy * kw + dx) * c + ci for dx in range(kw)]
                run = [0] * kw
                for oy in range(oh):
                    y = oy * s + dy
                    crow, brow = cond_raw[img, ci, y], bits[img, ci, y]
                    carry = None
                    for j0 in range(0, oww, pj):
                        pjn = min(pj, oww - j0)
                        ox_end = min(ow, 32 * (j0 + pjn))
                        wa, nxt = j0 * s, j0 + pjn < oww
                        wnext = (j0 + pjn) * s
                        cend = (ox_end - 1) * s + kw
                        nwords = -(-cend // 32) - wa
                        if nxt:
                            nwords = max(nwords, wnext - wa)
                        nwords = min(nwords, ww - wa)
                        p0 = 0 if j0 == 0 else carry
                        nv = min(32 * nwords, w - p0)
                        sw = brow[wa:wa + nwords]            # A
                        sv = crow[p0:p0 + nv]
                        assert len(sw) == nwords and len(sv) == nv
                        pre = np.concatenate(                # B: S3
                            [[0], np.cumsum([_popc(v) for v in sw])])
                        if nxt:
                            carry = p0 + int(pre[wnext - wa])
                        ob = np.zeros((kw, pjn), np.int64)
                        op = np.zeros((kw, pjn), np.int64)
                        for dx in range(kw):                 # S2, S4
                            for jj in range(pjn):
                                j = j0 + jj
                                cb = 32 * j * s + dx
                                if s == 2:
                                    word = even_bits(sw, nwords,
                                                     (cb >> 5) - wa, cb & 31)
                                else:
                                    word = 0
                                    for i in range(32):
                                        if 32 * j + i >= ow:
                                            break
                                        col = cb + i * s
                                        lw = (col >> 5) - wa
                                        assert 0 <= lw
                                        word |= (int(sw[lw]) >> (col & 31)
                                                 & 1) << i
                                if j == oww - 1:
                                    word &= tail
                                ob[dx, jj] = word
                                out_bits[img, krow[dx], oy, j] = word
                            cnt = [_popc(v) for v in ob[dx]]
                            op[dx] = run[dx] + np.cumsum(cnt) - cnt
                            run[dx] += sum(cnt)
                        for dx in range(kw):                 # C
                            for jj in range(pjn):
                                wd = int(ob[dx, jj])
                                c0 = 32 * jj * s + dx     # piece-local
                                for lane in range(32):
                                    if wd >> lane & 1:
                                        col = c0 + lane * s
                                        lw = col >> 5
                                        vi = int(pre[lw]) + _popc(
                                            int(sw[lw]) & _below(col & 31))
                                        pos = int(op[dx, jj]) + _popc(
                                            wd & _below(lane))
                                        out_vals[img, krow[dx], pos] = sv[vi]
                for dx in range(kw):                         # zero tails
                    out_vals[img, krow[dx], run[dx]:] = 0
    return out_bits, out_vals


K7_SHAPES = [  # (N, H, W, C, kh, kw, stride)
    (2, 1, 300, 3, 1, 3, 2),      # whisper conv2-like
    (1, 1, 100, 2, 1, 33, 2),     # dx >= 32: three feature words a word
    (1, 1, 161, 2, 1, 1, 2),      # kw < stride: columns between windows
    (2, 9, 10, 2, 3, 3, 2),
    (1, 1, 200, 2, 1, 3, 3),      # stride 3: the bit loop
    (1, 28, 28, 2, 14, 14, 14),   # patch-like, k = s: kh rows a block
    (1, 1, 9000, 1, 1, 3, 2),     # the rule's pieces: 3 of 63 words
]


@pytest.mark.parametrize("zeros", ["half", "few"])
@pytest.mark.parametrize("shape", K7_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k7_feature_model_matches_plain(shape, dtype, zeros):
    """The feature route at the rule's piece and at pieces of 1 and 2
    output words (a carry across every piece boundary) equals the plain
    version bit for bit, on half-zero maps and on near-dense ones."""
    n, h, w, c, kh, kw, s = shape
    rng = np.random.default_rng(w + kw)
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    if zeros == "half":
        x[rng.random(x.shape) < 0.5] = 0
        x[..., 1::7] = -0.0
    else:
        x[..., 5::97] = 0
    x[0, 0, 0] = 0
    x[-1, -1, -1] = 1.0
    if w >= 32:
        x[..., 31::32] = 1.5
    xt = torch.from_numpy(x).to(dtype)
    bits, cond = k5.bitmap_encode(xt, device="cpu")
    want_b, want_v = k67.sparse_im2col_strided_plain(cond, bits, kh=kh,
                                                     kw=kw, stride=s)
    route, pj = k67.strided_route(n, c, h, w, kh, kw, s)
    assert route == "feature"
    oww = want_b.shape[-1]
    pieces = {pj} if w > 1000 else {pj, 1, min(2, oww)}
    for piece in sorted(pieces):
        got_b, got_v = k7_feature_model(_raw(cond),
                                        bits.numpy().view(np.uint32), kh,
                                        kw, s, piece)
        np.testing.assert_array_equal(got_b,
                                      want_b.numpy().view(np.uint32))
        np.testing.assert_array_equal(got_v, _raw(want_v))


# ---------------------------------------------------------------------------
# K6's feature route
# ---------------------------------------------------------------------------

def test_k6_route_rule():
    # (N, C, H, W, kh, kw) -> (route, output words a piece)
    cases = {
        (4, 80, 1, 3002, 1, 3): ("feature", 94),      # whisper conv1
        (1, 1, 1, 9000, 1, 3): ("feature", 127),      # pieces
        (1, 3, 56, 56, 14, 14): ("feature", 2),       # patch-like
        (1, 2, 1, 66, 1, 34): ("feature", 2),
        (1, 2, 1, 5000, 1, 4100): ("lowered", 0),     # kw past a piece
        (1, 2, 1, 4000, 1, 1500): ("lowered", 0),     # kw > 1024
        (1, 2, 1, 9000, 1, 1024): ("feature", 96),
    }
    for (n, c, h, w, kh, kw), want in cases.items():
        assert k67.k6_route(n, c, h, w, kh, kw) == want


def shifted16(a, b, sh):
    """K6's ``shifted16``: the 16 bytes ``sh`` bytes into a:b, each four
    little-endian 32-bit words, by funnel shifts of neighbouring words."""
    x = [int(v) for v in (*a, *b)]
    s = (sh & 3) * 8
    q = sh >> 2
    return [((x[q + j] | x[q + j + 1] << 32) >> s) & M32 for j in range(4)]


def copy_run_model(out, dst, sv, src, n, total, vec, lo, hi):
    """K6's ``copy_run``: out[dst + i] = sv[src + i] for i < n and 0 for
    n <= i < total, out a flat array whose element 0 is 16-byte aligned,
    sv the staged values (its element 0 16-byte aligned).  Whole chunks
    of ``vec`` elements go as 16-byte stores: the values' chunks [f0, f1)
    each the 16 bytes ``sh`` elements into two aligned 16-byte loads of
    sv, the zeros' chunks [z0, z1); the elements outside them one by one.
    Every value a store takes must come from sv[lo, hi), the staged
    values, and every load must lie in sv."""
    lead = dst % vec
    endv, end = lead + n, lead + total
    sh = (src - lead) % vec
    base = (src - lead - sh) // vec            # s4: sv's 16-byte loads
    f0 = -(-lead // vec)
    f1 = max(endv // vec, f0)
    z0 = -(-endv // vec)
    z1 = max(end // vec, z0)
    row0 = dst - lead                          # out element of chunk 0
    for k in range(f0, f1):
        b = base + k
        assert b >= 0 and (b + 1 + (sh > 0)) * vec <= len(sv)
        first = b * vec + sh
        assert lo <= first and first + vec <= hi
        words = np.ascontiguousarray(sv[b * vec:(b + 2) * vec]).view(
            np.uint32)
        if len(words) < 8:                      # sh == 0: one load
            words = np.concatenate([words, np.zeros(4, np.uint32)])
        chunk = np.array(shifted16(words[:4], words[4:], sh * sv.itemsize),
                         np.uint32)
        out[row0 + k * vec: row0 + (k + 1) * vec] = chunk.view(sv.dtype)
    for k in range(z0, z1):
        out[row0 + k * vec: row0 + (k + 1) * vec] = 0
    v0 = min(f0 * vec, endv)
    v1 = max(f1 * vec, v0)
    e0 = min(z0 * vec, end)
    e1 = max(z1 * vec, e0)
    edges = [*range(lead, v0), *range(v1, endv), *range(endv, e0),
             *range(e1, end)]
    assert len(edges) == len(set(edges)) <= 4 * vec
    for e in edges:
        if e < endv:
            assert lo <= src + e - lead < hi
            out[dst + e - lead] = sv[src + e - lead]
        else:
            out[dst + e - lead] = 0


@pytest.mark.parametrize("vec", [8, 4])
def test_copy_run_model_every_alignment(vec):
    """Runs of 0 .. 3 chunks at every destination and source alignment,
    with zero tails of 0 .. 2 chunks, write exactly their elements and
    nothing around them."""
    rng = np.random.default_rng(vec)
    dtype = np.uint16 if vec == 8 else np.uint32
    sv = rng.integers(1, 1 << 15, 8 * vec).astype(dtype)
    for dst in range(vec):
        for src in range(vec, 2 * vec):
            for n in (0, 1, vec - 1, vec, vec + 1, 3 * vec - 1):
                for zeros in (0, 1, vec - 1, 2 * vec + 1):
                    out = np.full(8 * vec, SENTINEL, dtype)
                    copy_run_model(out, vec + dst, sv, src, n, n + zeros,
                                   vec, src, src + n)
                    want = np.full(8 * vec, SENTINEL, dtype)
                    want[vec + dst: vec + dst + n] = sv[src:src + n]
                    want[vec + dst + n: vec + dst + n + zeros] = 0
                    np.testing.assert_array_equal(out, want)


def k6_feature_model(cond_raw, bits, kh, kw, pj):
    """K6's feature route, block by block (image, channel, dy), piece by
    piece, as ``feature_runs_kernel`` walks it (the last piece's copies
    write the zero tails); cond and the outputs as flat arrays with
    element 0 16-byte aligned, as the wrapper's tensors are."""
    n, c, h, w = cond_raw.shape
    ww = bits.shape[-1]
    vec = 16 // cond_raw.itemsize
    oh, ow = h - kh + 1, w - kw + 1
    oww, p, kkc = -(-ow // 32), oh * ow, kh * kw * c
    tail = _below(ow % 32) if ow % 32 else M32
    nw = -(-(32 * pj + kw - 1) // 32)               # RunSmem's staged words
    nv_alloc = 32 * nw + 2 * vec
    flat = np.concatenate([cond_raw.reshape(-1),
                           np.full(vec, SENTINEL, cond_raw.dtype)])
    out_bits = np.full((n, kkc, oh, oww), SENTINEL, np.uint64)
    out_vals = np.full(n * kkc * p, SENTINEL, cond_raw.dtype)
    for img in range(n):
        for dy in range(kh):
            for ci in range(c):
                krow = [img * kkc + (dy * kw + dx) * c + ci
                        for dx in range(kw)]
                srun = [0] * kw
                carry = None
                for oy in range(oh):
                    y = oy + dy
                    row0 = ((img * c + ci) * h + y) * w
                    brow = bits[img, ci, y]
                    for j0 in range(0, oww, pj):
                        pjn = min(pj, oww - j0)
                        ox_end = min(ow, 32 * (j0 + pjn))
                        nxt = j0 + pjn < oww
                        nwords = min(-(-(ox_end - 1 + kw) // 32), ww) - j0
                        assert 0 < nwords <= nw
                        p0 = 0 if j0 == 0 else carry          # A
                        nv = min(32 * nwords, w - p0)
                        sw = brow[j0:j0 + nwords]
                        lead = (row0 + p0) % vec
                        nload = -(-(lead + nv) // vec) * vec
                        assert nload <= nv_alloc
                        sv = np.full(nv_alloc, SENTINEL, cond_raw.dtype)
                        sv[:nload] = flat[row0 + p0 - lead:
                                          row0 + p0 - lead + nload]
                        if nxt:                                # B: carry
                            assert pjn <= nwords
                            carry = p0 + sum(_popc(v) for v in sw[:pjn])
                        seg = []
                        for dx in range(kw):                   # B: dx
                            q, r = dx >> 5, dx & 31
                            off = sum(_popc(v) for v in sw[:q]) + _popc(
                                int(sw[q]) & _below(r))
                            ln = 0
                            for jj in range(pjn):
                                lo = int(sw[q + jj])
                                hi = (int(sw[q + jj + 1])
                                      if q + jj + 1 < nwords else 0)
                                word = ((lo >> r) | (hi << (32 - r))) & M32 \
                                    if r else lo
                                if j0 + jj == oww - 1:
                                    word &= tail
                                out_bits[img, krow[dx] - img * kkc, oy,
                                         j0 + jj] = word
                                ln += _popc(word)
                            seg.append((off, ln, srun[dx]))
                            srun[dx] += ln
                        last = not nxt and oy == oh - 1
                        for dx, (off, ln, run) in enumerate(seg):   # C
                            copy_run_model(out_vals, krow[dx] * p + run, sv,
                                           lead + off, ln,
                                           p - run if last else ln, vec,
                                           lead, lead + nv)
    return out_bits, out_vals.reshape(n, kkc, p)


K6_SHAPES = [  # (N, H, W, C, kh, kw)
    (2, 1, 300, 3, 1, 3),         # whisper conv1-like
    (1, 1, 120, 2, 1, 34),        # dx 0, 1, 31, 32, 33: windows cross words
    (1, 1, 66, 3, 1, 3),          # OW % 32 == 0
    (1, 1, 67, 2, 1, 3),          # OW % 32 == 1
    (1, 1, 97, 2, 1, 3),          # OW % 32 == 31
    (2, 9, 10, 2, 3, 3),          # H > 1: runs carried over output rows
    (1, 6, 45, 2, 3, 5),          # H > 1 across words
    (1, 1, 9000, 1, 1, 3),        # the rule's pieces: 3 of 127 words
]


@pytest.mark.parametrize("zeros", ["half", "few"])
@pytest.mark.parametrize("shape", K6_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_feature_model_matches_plain(shape, dtype, zeros):
    """The feature route at the rule's piece and at pieces of 1 and 2
    output words (a carry across every piece boundary) equals the plain
    version bit for bit, on half-zero maps (runs at every offset modulo
    16 bytes) and on near-dense ones."""
    n, h, w, c, kh, kw = shape
    rng = np.random.default_rng(w + kw)
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    if zeros == "half":
        x[rng.random(x.shape) < 0.5] = 0
        x[..., 1::7] = -0.0
    else:
        x[..., 5::97] = 0
    x[0, 0, 0] = 0
    x[-1, -1, -1] = 1.0
    if w >= 32:
        x[..., 31::32] = 1.5
    xt = torch.from_numpy(x).to(dtype)
    bits, cond = k5.bitmap_encode(xt, device="cpu")
    want_b, want_v = k67.sparse_im2col_plain(cond, bits, kh=kh, kw=kw)
    route, pj = k67.k6_route(n, c, h, w, kh, kw)
    assert route == "feature"
    oww = want_b.shape[-1]
    pieces = {pj} if w > 1000 else {pj, 1, min(2, oww)}
    for piece in sorted(pieces):
        got_b, got_v = k6_feature_model(_raw(cond),
                                        bits.numpy().view(np.uint32), kh,
                                        kw, piece)
        np.testing.assert_array_equal(got_b,
                                      want_b.numpy().view(np.uint32))
        np.testing.assert_array_equal(got_v, _raw(want_v))
