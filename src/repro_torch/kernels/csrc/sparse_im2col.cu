// K6: stride-1 implicit bitmap im2col for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/sparse_im2col.py::sparse_im2col_pallas
// (_im2col_kernel) of the JAX package.  Input: one image batch as K5
// leaves it, condensed values (N, C, H, W) and bitmaps (N, C, H, ww =
// ceil(W/32)).  For lowered row k = (dy*kw + dx)*C + ci and output row oy
// the window is columns dx .. dx+OW-1 of feature row oy+dy, and the
// kernel writes
//   S2  the window's bits, row-packed: (N, KKC, OH, ceil(OW/32)) words,
//       each output row starting a fresh word, built by word shift/OR
//       (lo = word[q+j] >> r | word[q+j+1] << (32 - r), q = dx/32,
//       r = dx%32) and the last word masked to the OW%32 tail;
//   S3  the offset of the window's first non-zero in the row's condensed
//       values: the popcount of the row's words before q plus that of
//       word q below bit r;
//   S4  the window's popcount as its length, and that many condensed
//       values copied to the end of the lowered row's values so far
//       ((N, KKC, P), P = OH*OW, zero tail).
// At stride 1 a window's values are one contiguous run of the condensed
// row, cond[row][off, off + len): the copy is a memmove, not a gather.
// Traps: the words are uint32_t (a signed shift would sign-extend); r == 0
// takes word q whole, since `x << 32` is undefined; word q+1 past the
// row's last word reads as zero (the JAX kernel pads the bitmap by one
// word instead).
//
// Bound by bytes: the lowered values are written once (5.8 MB of whisper
// conv1's 7.2) and the condensed rows read once.  Two routes, chosen by
// the wrapper's rule (kernels/sparse_im2col.py::k6_route):
//
// * feature (kRouteFeature): one block per (image, channel, dy) makes the
//   kw lowered rows of that channel and dy, walking their OH output rows.
//   Each feature row is staged once in shared memory, words and condensed
//   values (16-byte loads, four in flight a thread), in pieces of `pj`
//   output words (a whole row at whisper conv1), double-buffered, with
//   two barriers a piece:
//     A  stage the piece: its words from word j0 on and its condensed
//        values from the row's non-zeros before column 32*j0 (the carry);
//     B  one warp per dx builds the piece's output words (S2), sums their
//        popcounts (S4) and the popcount of the staged words before the
//        window's first column (S3); one more warp sums the popcount of
//        the piece's own words, the carry into the next piece;
//     C  for each dx, the run of len staged values from off goes to
//        out_vals[run, run + len) in aligned 16-byte stores, each put
//        together from two aligned 16-byte shared-memory loads by funnel
//        shifts of (off - run) mod 16 bytes (a template per shift, so the
//        loop has no branch); the last piece of the last output row also
//        writes the lowered row's zero tail, in 16-byte stores; only the
//        elements of the part chunks at the ends go one by one.
//   128 threads a block.  Whisper conv1 has 320 feature rows, 2-3 an SM,
//   and a block's time is its chain of dependent steps: 256 or 512
//   threads, splitting a row's copy over 2-4 blocks, and a separate
//   zero-tail pass all measured slower on the H100.
// * lowered (kRouteLowered): one block per (lowered row, image), for the
//   shapes whose pieces would not fit (kw in the thousands): it walks its
//   output rows, each with two block scans, and copies 2-byte elements.
#include "bitmap_rows.cuh"

namespace repro {

// 128 threads a block, each with up to 4 staging loads in flight
constexpr int kRunThreads = 128, kLoads = 4;

// The feature route's shared memory for pieces of pj output words: the
// kw runs and the carry, then two buffers of the staged values (sv),
// words (sw) and each dx's (off, len, run) of the piece.  Byte offsets.
// (The offsets are ints, as the kernel uses them; the host checks
// `bytes` before a launch.)
struct RunSmem {
  int carry, buf, bufbytes, sw, seg;
  long long bytes;
  __host__ __device__ RunSmem(long long pj, long long kw, int elem_bytes) {
    const long long nw = (32 * pj + kw - 1 + 31) / 32;  // staged words
    // the values of nw words, the 16-byte load's lead and one more
    // 16-byte load past the end (the shifted copy reads it whole)
    const long long nv = 32 * nw + 2 * (16 / elem_bytes);
    const long long o_sw = align16(nv * elem_bytes);
    const long long o_seg = o_sw + align16(4 * nw);
    const long long per = o_seg + align16(12 * kw);
    const long long o_buf = align16(4 * kw) + 16;
    bytes = o_buf + 2 * per;
    carry = (int)align16(4 * kw);
    buf = (int)o_buf;
    bufbytes = (int)per;
    sw = (int)o_sw;
    seg = (int)o_seg;
  }
};

// The 16 bytes that start SH bytes into a:b (SH even, below 16).
template <int SH>
__device__ __forceinline__ uint4 shifted16(uint4 a, uint4 b) {
  constexpr unsigned s = (SH & 3) * 8;
  const uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  constexpr int q = SH >> 2;
  return make_uint4(__funnelshift_r(x[q], x[q + 1], s),
                    __funnelshift_r(x[q + 1], x[q + 2], s),
                    __funnelshift_r(x[q + 2], x[q + 3], s),
                    __funnelshift_r(x[q + 3], x[q + 4], s));
}

template <int SH>
__device__ __forceinline__ void copy_chunks(uint4* d4, const uint4* s4,
                                            int k0, int k1, int tid,
                                            int nthr) {
#pragma unroll 1
  for (int k = k0 + tid; k < k1; k += nthr)
    d4[k] = SH ? shifted16<SH>(s4[k], s4[k + 1]) : s4[k];
}

// dst[i] = src[i] for i < len and 0 for len <= i < total: src in shared
// memory at any element alignment; the 16-byte aligned chunks of dst in
// whole 16-byte stores (a loop per kind: values, zeros), the few
// elements of the part chunks at the ends one by one
template <typename T>
__device__ __forceinline__ void copy_run(T* dst, const T* src, int len,
                                         int total, int tid, int nthr) {
  constexpr int VEC = 16 / sizeof(T);
  const int lead = (int)(((uintptr_t)dst & 15) / sizeof(T));
  uint4* d4 = reinterpret_cast<uint4*>(dst - lead);
  const int endv = lead + len, end = lead + total;
  const int sh = (int)(((uintptr_t)(src - lead)) & 15);
  const uint4* s4 = reinterpret_cast<const uint4*>(
      reinterpret_cast<const unsigned char*>(src - lead) - sh);
  // whole chunks of values [f0, f1) and of zeros [z0, z1)
  const int f0 = (lead + VEC - 1) / VEC, f1 = max(endv / VEC, f0);
  const int z0 = (endv + VEC - 1) / VEC, z1 = max(end / VEC, z0);
  switch (sh) {
    case 0: copy_chunks<0>(d4, s4, f0, f1, tid, nthr); break;
    case 2: copy_chunks<2>(d4, s4, f0, f1, tid, nthr); break;
    case 4: copy_chunks<4>(d4, s4, f0, f1, tid, nthr); break;
    case 6: copy_chunks<6>(d4, s4, f0, f1, tid, nthr); break;
    case 8: copy_chunks<8>(d4, s4, f0, f1, tid, nthr); break;
    case 10: copy_chunks<10>(d4, s4, f0, f1, tid, nthr); break;
    case 12: copy_chunks<12>(d4, s4, f0, f1, tid, nthr); break;
    default: copy_chunks<14>(d4, s4, f0, f1, tid, nthr); break;
  }
#pragma unroll 1
  for (int k = z0 + tid; k < z1; k += nthr)
    d4[k] = make_uint4(0u, 0u, 0u, 0u);
  // the elements outside whole chunks: values [lead, f0*VEC) and
  // [f1*VEC, endv) (all of [lead, endv) without whole chunks), zeros
  // [endv, z0*VEC) and [z1*VEC, end)
  const int v0 = min(f0 * VEC, endv), v1 = max(f1 * VEC, v0);
  const int e0 = min(z0 * VEC, end), e1 = max(z1 * VEC, e0);
  const int n1 = v0 - lead, n2 = max(endv - v1, 0), n3 = e0 - endv;
  const int n4 = max(end - e1, 0);
  for (int i = tid; i < n1 + n2 + n3 + n4; i += nthr) {
    const int e = i < n1 ? lead + i
                : i < n1 + n2 ? v1 + i - n1
                : i < n1 + n2 + n3 ? endv + i - n1 - n2
                : e1 + i - n1 - n2 - n3;
    dst[e - lead] = e < endv ? src[e - lead] : T(0);
  }
}

template <int BYTES>
__global__ void __launch_bounds__(kRunThreads)
    feature_runs_kernel(const void* cond_, const uint32_t* bits,
                        uint32_t* out_bits, void* out_vals_, int c, int h,
                        int w, int kh, int kw, int pj) {
  using T = typename Raw<BYTES>::T;
  constexpr int VEC = 16 / BYTES;
  constexpr int kWarps = kRunThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const RunSmem L(pj, kw, BYTES);
  int* srun = reinterpret_cast<int*>(smem);  // (kw,)
  int* carry = reinterpret_cast<int*>(smem + L.carry);
  const int ci = (int)(blockIdx.x % c);
  const int img = (int)(blockIdx.x / c / kh), dy = (int)(blockIdx.x / c % kh);
  const int oh = h - kh + 1, ow = w - kw + 1;
  const int ww = (w + 31) / 32, oww = (ow + 31) / 32;
  const long long p = (long long)oh * ow, kkc = (long long)kh * kw * c;
  const long long chan = (long long)img * c + ci;
  const T* crow0 = static_cast<const T*>(cond_) + chan * h * w;
  const uint32_t* brow0 = bits + chan * h * ww;
  T* vals = static_cast<T*>(out_vals_);
  // lowered row k of (dy, dx, ci) in image img
  auto krow = [&](int dx) {
    return (long long)img * kkc + ((long long)dy * kw + dx) * c + ci;
  };
  const unsigned tail = (ow & 31) ? below(ow & 31) : kFullMask;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kw; i += kRunThreads) srun[i] = 0;
  int piece = 0;
  for (int oy = 0; oy < oh; ++oy) {
    const T* crow = crow0 + (long long)(oy + dy) * w;
    const uint32_t* brow = brow0 + (long long)(oy + dy) * ww;
    for (int j0 = 0; j0 < oww; j0 += pj, ++piece) {
      unsigned char* buf = smem + L.buf + (piece & 1) * L.bufbytes;
      T* sv = reinterpret_cast<T*>(buf);
      uint32_t* sw = reinterpret_cast<uint32_t*>(buf + L.sw);
      int* seg = reinterpret_cast<int*>(buf + L.seg);  // (kw, 3)
      const int pjn = min(pj, oww - j0);
      const int ox_end = min(ow, 32 * (j0 + pjn));  // output columns
      const bool next = j0 + pjn < oww;             // a piece follows
      const bool last = !next && oy == oh - 1;
      // words j0 .. of the row, through the piece's last column
      const int nwords = min((ox_end - 1 + kw + 31) / 32, ww) - j0;
      // A: the piece's words and its condensed values from p0 on
      const int p0 = j0 == 0 ? 0 : *carry;
      const int nv = min(32 * nwords, w - p0);
      const T* vsrc = crow + p0;
      const int lead = (int)(((uintptr_t)vsrc & 15) / BYTES);
      const uint4* vv = reinterpret_cast<const uint4*>(vsrc - lead);
      const int nvl = (lead + nv + VEC - 1) / VEC;
      // every load of a round in flight before its shared-memory stores
      for (int i0 = threadIdx.x; i0 < max(nvl, nwords);
           i0 += kLoads * kRunThreads) {
        uint4 v[kLoads];
        uint32_t wd[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int i = i0 + u * kRunThreads;
          if (i < nvl) v[u] = vv[i];
          if (i < nwords) wd[u] = brow[j0 + i];
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int i = i0 + u * kRunThreads;
          if (i < nvl) reinterpret_cast<uint4*>(sv)[i] = v[u];
          if (i < nwords) sw[i] = wd[u];
        }
      }
      __syncthreads();
      // B: task dx < kw the S2 words, S4 length and S3 offset of dx's
      // window; task kw the carry
      for (int task = warp; task <= kw; task += kWarps) {
        if (task == kw) {
          if (next) {
            int cnt = 0;
            for (int i = lane; i < pjn; i += 32) cnt += __popc(sw[i]);
            cnt = __reduce_add_sync(kFullMask, cnt);
            if (lane == 0) *carry = p0 + cnt;
          }
          continue;
        }
        const int dx = task, q = dx >> 5;
        const unsigned r = dx & 31;
        int off = 0;
        for (int i = lane; i < q; i += 32) off += __popc(sw[i]);
        if (lane == 0) off += __popc(sw[q] & below(r));
        uint32_t* gbits = out_bits + (krow(dx) * oh + oy) * oww + j0;
        int len = 0;
        for (int jj = lane; jj < pjn; jj += 32) {
          const uint32_t lo = sw[q + jj];
          const uint32_t hi = q + jj + 1 < nwords ? sw[q + jj + 1] : 0u;
          uint32_t word = r ? (lo >> r) | (hi << (32u - r)) : lo;
          if (j0 + jj == oww - 1) word &= tail;
          gbits[jj] = word;
          len += __popc(word);
        }
        off = __reduce_add_sync(kFullMask, off);
        len = __reduce_add_sync(kFullMask, len);
        if (lane == 0) {
          seg[3 * dx] = off;
          seg[3 * dx + 1] = len;
          seg[3 * dx + 2] = srun[dx];
          srun[dx] += len;
        }
      }
      __syncthreads();
      // C: each dx's run of staged values to its place in its lowered row
      for (int dx = 0; dx < kw; ++dx) {
        const int run = seg[3 * dx + 2], len = seg[3 * dx + 1];
        copy_run(vals + krow(dx) * p + run, sv + lead + seg[3 * dx], len,
                 last ? (int)(p - run) : len, threadIdx.x, kRunThreads);
      }
    }
  }
}

template <int BYTES>
__global__ void im2col_kernel(const void* cond, const uint32_t* bits,
                              uint32_t* out_bits, void* out_vals, int c,
                              int h, int w, int kh, int kw, int stride) {
  using T = typename Raw<BYTES>::T;
  __shared__ int sh[33];
  const LoweredRow<T> L(cond, bits, out_bits, out_vals, c, h, w, kh, kw,
                        stride);
  const int q = L.dx >> 5;
  const unsigned r = L.dx & 31;
  const unsigned tail = (L.ow & 31) ? below(L.ow & 31) : kFullMask;
  long long run = 0;  // values of the lowered row written so far
  for (int oy = 0; oy < L.oh; ++oy) {
    const uint32_t* row = L.bits + (long long)(oy + L.dy) * L.ww;
    // S3: non-zeros of the feature row before column dx
    int part = 0;
    for (int i = threadIdx.x; i < q; i += blockDim.x) part += __popc(row[i]);
    if (threadIdx.x == 0) part += __popc(row[q] & below(r));
    int off;
    block_exclusive_scan(part, &off, sh);
    // S2: the window's words; S4: their popcount
    int len = 0;
    for (int j0 = 0; j0 < L.oww; j0 += blockDim.x) {
      const int j = j0 + threadIdx.x;
      int cnt = 0;
      if (j < L.oww) {
        const uint32_t lo = row[q + j];
        const uint32_t hi = q + j + 1 < L.ww ? row[q + j + 1] : 0u;
        uint32_t word = r ? (lo >> r) | (hi << (32u - r)) : lo;
        if (j == L.oww - 1) word &= tail;
        L.out_bits[(long long)oy * L.oww + j] = word;
        cnt = __popc(word);
      }
      int tot;
      block_exclusive_scan(cnt, &tot, sh);
      len += tot;
    }
    // S4: the window's len condensed values, appended
    const T* src = L.cond + (long long)(oy + L.dy) * w + off;
    for (int i = threadIdx.x; i < len; i += blockDim.x)
      L.out_vals[run + i] = src[i];
    run += len;
  }
  for (long long i = run + threadIdx.x; i < L.p; i += blockDim.x)
    L.out_vals[i] = T(0);
}

template <int BYTES>
int launch_runs(const void* cond, const void* bits, void* out_bits,
                void* out_vals, int n, int c, int h, int w, int kh, int kw,
                int pj, cudaStream_t s) {
  const long long blocks = (long long)n * c * kh;
  const long long p = (long long)(h - kh + 1) * (w - kw + 1);
  const RunSmem L(pj, kw, BYTES);
  if (pj < 1 || blocks > 0x7fffffffLL || p > 0x7fffffffLL ||
      L.bytes > kMaxSmem)
    return cudaErrorInvalidValue;
  auto kernel = &feature_runs_kernel<BYTES>;
  if (L.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)blocks, kRunThreads, (size_t)L.bytes, s>>>(
      cond, static_cast<const uint32_t*>(bits),
      static_cast<uint32_t*>(out_bits), out_vals, c, h, w, kh, kw, pj);
  return cudaGetLastError();
}

}  // namespace repro

// route: 0 lowered, 1 feature; pj: output words a piece of the feature
// route stages (the wrapper's rule picks it)
extern "C" int repro_sparse_im2col(int route, int pj, int elem_bytes,
                                   const void* cond, const void* bits,
                                   void* out_bits, void* out_vals, int n,
                                   int c, int h, int w, int kh, int kw,
                                   int stride, void* stream) {
  if (stride != 1 || (elem_bytes != 2 && elem_bytes != 4))
    return cudaErrorInvalidValue;
  if ((long long)n * c * kh <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (route == repro::kRouteFeature)
    return elem_bytes == 2
               ? repro::launch_runs<2>(cond, bits, out_bits, out_vals, n, c,
                                       h, w, kh, kw, pj, s)
               : repro::launch_runs<4>(cond, bits, out_bits, out_vals, n, c,
                                       h, w, kh, kw, pj, s);
  if (route != repro::kRouteLowered) return cudaErrorInvalidValue;
  if (elem_bytes == 2)
    return repro::launch_lowered(repro::im2col_kernel<2>, cond, bits,
                                 out_bits, out_vals, n, c, h, w, kh, kw,
                                 stride, 0, stream);
  return repro::launch_lowered(repro::im2col_kernel<4>, cond, bits,
                               out_bits, out_vals, n, c, h, w, kh, kw, stride,
                               0, stream);
}
