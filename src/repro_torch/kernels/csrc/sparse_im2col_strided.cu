// K7: implicit bitmap im2col at stride >= 2 for Hopper (sm_90a).
//
// Replaces the TPU kernel
// kernels/sparse_im2col.py::sparse_im2col_strided_pallas
// (_im2col_kernel_strided) of the JAX package, with K6's output contract:
// row-packed lowered bits (N, KKC, OH, ceil(OW/32)) and the lowered rows'
// condensed values (N, KKC, P), zero tail; lowered row k = (dy*kw + dx)*C
// + ci.  At stride s the window's bits are not contiguous in the feature
// row: bit ox of output row (oy, dx) is bit ox*s + dx of feature row
// oy*s + dy, and its value sits in the row's condensed values at the
// exclusive popcount prefix of the row's words (S3) plus the popcount of
// its word below it.  The TPU's one-hot row, column and gather matmuls are
// not carried over.
//
// Bound by bytes: the lowered values are written once (18.4 MB of whisper
// conv2's 32.6) and the condensed rows read once.  Two routes, chosen by
// the wrapper's rule (kernels/sparse_im2col.py::strided_route):
//
// * feature (kRouteFeature): one block per (image, channel, dy) makes the
//   kw lowered rows of that channel and dy, walking their OH output rows.
//   Each feature row is staged once in shared memory, words and condensed
//   values (16-byte loads), in pieces of `pj` output words (a whole row
//   at whisper conv2), double-buffered, with two barriers a piece:
//     A  stage the piece;
//     B  warp 0 builds the words' exclusive popcount prefix (S3); one warp
//        per dx builds the output words, one thread a word (S2: at stride
//        2 the even bits of three neighbouring words, folded; at other
//        strides 32 bits tested in a loop), and their exclusive prefix
//        (S4), which places each word's values in its lowered row;
//     C  for each dx, a warp takes an output word and each lane whose bit
//        is set copies its value from shared memory to out_vals[run +
//        rank], so that neighbouring lanes store neighbouring addresses
//        (two words in flight a warp).
//   The zero tails are written last, with 16-byte stores.  128 threads a
//   block, at most 64 registers, so that 8 blocks (8 feature rows) share
//   an SM: the copy is bound by instruction issue and latency more than
//   by bytes.  (Compacting each piece in shared memory for 16-byte stores
//   measured slower.)
// * lowered (kRouteLowered): one block per (lowered row, image), for the
//   shapes whose pieces would not fit (kw or s in the thousands): it tests
//   each strided bit and compacts the set ones with a block scan per 256
//   output columns.
//
// The words are uint32_t and every shift of a 32-bit word is below 32.
#include "bitmap_rows.cuh"

namespace repro {

constexpr int kThreads = 128;

// The feature route's shared memory for pieces of pj output words: the
// kw runs (long long) and the carry, then two buffers of the staged values
// (sv), words (sw), their prefix (pre), and the piece's output words (ob)
// and their positions (op) over every dx.  Byte offsets.
// (The offsets are ints, as the kernel uses them; the host checks
// `bytes` before a launch.)
struct PieceSmem {
  int carry, buf, bufbytes, sw, pre, ob, op;
  long long bytes;
  __host__ __device__ PieceSmem(long long pj, long long kw, long long stride,
                                int elem_bytes) {
    const long long span = 32 * pj * stride - stride + kw;  // columns
    const long long nw =
        (span + 31) / 32 > pj * stride ? (span + 31) / 32 : pj * stride;
    const long long nv = 32 * nw + 2 * (16 / elem_bytes);
    const long long o_sw = align16(nv * elem_bytes);
    const long long o_pre = o_sw + align16(4 * nw);
    const long long o_ob = o_pre + align16(4 * (nw + 1));
    const long long o_op = o_ob + align16(4 * kw * pj);
    const long long o_buf = align16(8 * kw) + 16;
    const long long per = o_op + align16(4 * kw * pj);
    bytes = o_buf + 2 * per;
    carry = (int)align16(8 * kw);
    buf = (int)o_buf;
    bufbytes = (int)per;
    sw = (int)o_sw;
    pre = (int)o_pre;
    ob = (int)o_ob;
    op = (int)o_op;
  }
};

// dst[0, len) = 0, in whole 16-byte chunks between the partial ends
template <typename T>
__device__ __forceinline__ void zero_out(T* dst, long long len, int tid,
                                         int nthr) {
  constexpr int VEC = 16 / sizeof(T);
  const int lead = (int)(((uintptr_t)dst & 15) / sizeof(T));
  uint4* d4 = reinterpret_cast<uint4*>(dst - lead);
  const long long end = lead + len;
  for (long long k = tid; k < (end + VEC - 1) / VEC; k += nthr) {
    if (k * VEC >= lead && (k + 1) * VEC <= end) {
      d4[k] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (long long e = max(k * VEC, (long long)lead);
           e < min((k + 1) * VEC, end); ++e)
        dst[e - lead] = T(0);
    }
  }
}

// S2 at stride 2: bits dx, dx+2, ..., dx+62 of the window that starts at
// bit 0 of staged word q, out of words q, q+1, q+2 (zero past nwords),
// compressed to 32 bits by mask-and-fold
__device__ __forceinline__ unsigned even_bits(const uint32_t* sw, int nwords,
                                              int q, unsigned r) {
  auto at = [&](int i) -> unsigned long long {
    return i < nwords ? sw[i] : 0u;
  };
  unsigned long long x = at(q) | (at(q + 1) << 32);
  if (r) x = (x >> r) | (at(q + 2) << (64 - r));
  x &= 0x5555555555555555ull;
  x = (x | (x >> 1)) & 0x3333333333333333ull;
  x = (x | (x >> 2)) & 0x0f0f0f0f0f0f0f0full;
  x = (x | (x >> 4)) & 0x00ff00ff00ff00ffull;
  x = (x | (x >> 8)) & 0x0000ffff0000ffffull;
  x = (x | (x >> 16)) & 0x00000000ffffffffull;
  return (unsigned)x;
}

// inclusive prefix of v over the warp
__device__ __forceinline__ int warp_inclusive(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

template <int BYTES, bool STRIDE2>
__global__ void __launch_bounds__(kThreads, 8)
    feature_rows_kernel(const void* cond_, const uint32_t* bits,
                        uint32_t* out_bits, void* out_vals_, int c, int h,
                        int w, int kh, int kw, int stride, int pj) {
  using T = typename Raw<BYTES>::T;
  constexpr int VEC = 16 / BYTES;
  extern __shared__ __align__(16) unsigned char smem[];
  const PieceSmem L(pj, kw, stride, BYTES);
  long long* srun = reinterpret_cast<long long*>(smem);  // (kw,)
  int* carry = reinterpret_cast<int*>(smem + L.carry);
  const int ci = (int)(blockIdx.x % c);
  const int img = (int)(blockIdx.x / c / kh), dy = (int)(blockIdx.x / c % kh);
  const int oh = (h - kh) / stride + 1, ow = (w - kw) / stride + 1;
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
  const unsigned lanes_below = below(lane);
  for (int i = threadIdx.x; i < kw; i += kThreads) srun[i] = 0;
  int piece = 0;
  for (int oy = 0; oy < oh; ++oy) {
    const int y = oy * stride + dy;
    const T* crow = crow0 + (long long)y * w;
    const uint32_t* brow = brow0 + (long long)y * ww;
    for (int j0 = 0; j0 < oww; j0 += pj, ++piece) {
      unsigned char* buf = smem + L.buf + (piece & 1) * L.bufbytes;
      T* sv = reinterpret_cast<T*>(buf);
      uint32_t* sw = reinterpret_cast<uint32_t*>(buf + L.sw);
      int* pre = reinterpret_cast<int*>(buf + L.pre);
      uint32_t* ob = reinterpret_cast<uint32_t*>(buf + L.ob);
      int* op = reinterpret_cast<int*>(buf + L.op);
      const int pjn = min(pj, oww - j0);
      const int ox_end = min(ow, 32 * (j0 + pjn));  // output columns
      const int wa = j0 * stride;                   // first staged word
      const bool next = j0 + pjn < oww;             // a piece follows
      const int wnext = (j0 + pjn) * stride;        // its first word
      const long long cend = (long long)(ox_end - 1) * stride + kw;
      int nwords = (int)((cend + 31) / 32) - wa;
      if (next) nwords = max(nwords, wnext - wa);
      nwords = min(nwords, ww - wa);
      // A: the piece's words and its condensed values from p0 on
      const int p0 = j0 == 0 ? 0 : *carry;
      const int nv = min(32 * nwords, w - p0);
      for (int i = threadIdx.x; i < nwords; i += kThreads)
        sw[i] = brow[wa + i];
      const T* vsrc = crow + p0;
      const int lead = (int)(((uintptr_t)vsrc & 15) / BYTES);
      const uint4* vv = reinterpret_cast<const uint4*>(vsrc - lead);
      for (int i = threadIdx.x; i < (lead + nv + VEC - 1) / VEC;
           i += kThreads)
        reinterpret_cast<uint4*>(sv)[i] = vv[i];
      __syncthreads();
      // B: task 0 the S3 prefix, task 1 + dx the S2 words and S4 prefix
      for (int task = warp; task <= kw; task += kThreads / 32) {
        if (task == 0) {
          int run = 0;
          for (int b0 = 0; b0 <= nwords; b0 += 32) {
            const int i = b0 + lane;
            const int v = i < nwords ? __popc(sw[i]) : 0;
            const int incl = warp_inclusive(v);
            if (i <= nwords) pre[i] = run + incl - v;
            if (next && i == wnext - wa) *carry = p0 + run + incl - v;
            run += __shfl_sync(kFullMask, incl, 31);
          }
          continue;
        }
        const int dx = task - 1;
        long long run = srun[dx];
        uint32_t* gbits = out_bits + (krow(dx) * oh + oy) * oww;
        for (int b0 = 0; b0 < pjn; b0 += 32) {
          const int jj = b0 + lane, j = j0 + jj;
          unsigned word = 0;
          if (jj < pjn) {
            const int cb = 32 * j * stride + dx;  // column of bit 0
            if (STRIDE2) {
              word = even_bits(sw, nwords, (cb >> 5) - wa, cb & 31);
            } else {
              for (int i = 0; i < 32 && 32 * j + i < ow; ++i) {
                const int col = cb + i * stride;
                word |= ((sw[(col >> 5) - wa] >> (col & 31)) & 1u) << i;
              }
            }
            if (j == oww - 1) word &= tail;
            ob[dx * pj + jj] = word;
            gbits[j] = word;
          }
          const int v = __popc(word);
          const int incl = warp_inclusive(v);
          if (jj < pjn) op[dx * pj + jj] = (int)run + incl - v;
          run += __shfl_sync(kFullMask, incl, 31);
        }
        if (lane == 0) srun[dx] = run;
      }
      __syncthreads();
      // C: each set bit's value to its slot in its lowered row; a warp
      // takes one output word (its tail bits are clear), a lane one bit
      for (int dx = 0; dx < kw; ++dx) {
        T* orow = vals + krow(dx) * p;
        const uint32_t* obd = ob + dx * pj;
        const int* opd = op + dx * pj;
#pragma unroll 2
        for (int jj = warp; jj < pjn; jj += kThreads / 32) {
          const unsigned wd = obd[jj];
          if ((wd >> lane) & 1u) {
            const int col = (32 * (j0 + jj) + lane) * stride + dx;
            const int lw = (col >> 5) - wa;
            const int vi = pre[lw] + __popc(sw[lw] & below(col & 31));
            orow[opd[jj] + __popc(wd & lanes_below)] = sv[lead + vi];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int dx = 0; dx < kw; ++dx)
    zero_out(vals + krow(dx) * p + srun[dx], p - srun[dx], threadIdx.x,
             kThreads);
}

template <int BYTES>
__global__ void lowered_rows_kernel(const void* cond, const uint32_t* bits,
                                    uint32_t* out_bits, void* out_vals, int c,
                                    int h, int w, int kh, int kw,
                                    int stride) {
  using T = typename Raw<BYTES>::T;
  extern __shared__ int smem_i[];
  int* sh = smem_i;        // the scan's 33 ints
  int* pre = smem_i + 33;  // (ww,) exclusive popcount prefix of one row
  const LoweredRow<T> L(cond, bits, out_bits, out_vals, c, h, w, kh, kw,
                        stride);
  long long run = 0;  // values of the lowered row written so far
  for (int oy = 0; oy < L.oh; ++oy) {
    const int y = oy * stride + L.dy;
    const uint32_t* row = L.bits + (long long)y * L.ww;
    const T* src = L.cond + (long long)y * w;
    // S3: the row's exclusive word-popcount prefix
    int carry = 0;
    for (int i0 = 0; i0 < L.ww; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      int tot;
      const int ex =
          block_exclusive_scan(i < L.ww ? __popc(row[i]) : 0, &tot, sh);
      if (i < L.ww) pre[i] = carry + ex;
      carry += tot;
    }
    __syncthreads();
    // S2 + S4: test each strided bit, compact the set ones in order
    int len = 0;
    for (int x0 = 0; x0 < L.ow; x0 += blockDim.x) {
      const int ox = x0 + threadIdx.x;
      bool on = false;
      int off = 0;
      if (ox < L.ow) {
        const int col = ox * stride + L.dx;
        const uint32_t word = row[col >> 5];
        const unsigned b = col & 31;
        on = (word >> b) & 1u;
        off = pre[col >> 5] + __popc(word & below(b));
      }
      const unsigned ballot = __ballot_sync(kFullMask, on);
      const int wj = (x0 >> 5) + (threadIdx.x >> 5);
      if ((threadIdx.x & 31) == 0 && wj < L.oww)
        L.out_bits[(long long)oy * L.oww + wj] = ballot;
      int tot;
      const int rank = block_exclusive_scan(on ? 1 : 0, &tot, sh);
      if (on) L.out_vals[run + len + rank] = src[off];
      len += tot;
    }
    run += len;
    __syncthreads();  // every read of pre is done before the next row
  }
  for (long long i = run + threadIdx.x; i < L.p; i += blockDim.x)
    L.out_vals[i] = T(0);
}

template <int BYTES>
int launch_feature(const void* cond, const void* bits, void* out_bits,
                   void* out_vals, int n, int c, int h, int w, int kh, int kw,
                   int stride, int pj, cudaStream_t s) {
  const long long blocks = (long long)n * c * kh;
  const long long p = (long long)((h - kh) / stride + 1) *
                      ((w - kw) / stride + 1);
  const PieceSmem L(pj, kw, stride, BYTES);
  if (pj < 1 || blocks > 0x7fffffffLL || p > 0x7fffffffLL ||
      L.bytes > kMaxSmem)
    return cudaErrorInvalidValue;
  auto kernel = stride == 2 ? &feature_rows_kernel<BYTES, true>
                            : &feature_rows_kernel<BYTES, false>;
  if (L.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)blocks, kThreads, (size_t)L.bytes, s>>>(
      cond, static_cast<const uint32_t*>(bits),
      static_cast<uint32_t*>(out_bits), out_vals, c, h, w, kh, kw, stride,
      pj);
  return cudaGetLastError();
}

}  // namespace repro

// route: 0 lowered, 1 feature; pj: output words a piece of the feature
// route stages (the wrapper's rule picks it)
extern "C" int repro_sparse_im2col_strided(int route, int pj, int elem_bytes,
                                           const void* cond, const void* bits,
                                           void* out_bits, void* out_vals,
                                           int n, int c, int h, int w, int kh,
                                           int kw, int stride, void* stream) {
  if (stride < 1 || (elem_bytes != 2 && elem_bytes != 4))
    return cudaErrorInvalidValue;
  if ((long long)n * c * kh <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (route == repro::kRouteFeature)
    return elem_bytes == 2
               ? repro::launch_feature<2>(cond, bits, out_bits, out_vals, n,
                                          c, h, w, kh, kw, stride, pj, s)
               : repro::launch_feature<4>(cond, bits, out_bits, out_vals, n,
                                          c, h, w, kh, kw, stride, pj, s);
  if (route != repro::kRouteLowered) return cudaErrorInvalidValue;
  // the wrapper keeps this under the 48 KB of static shared memory
  const size_t smem = (33 + (size_t)(w + 31) / 32) * sizeof(int);
  if (elem_bytes == 2)
    return repro::launch_lowered(repro::lowered_rows_kernel<2>, cond, bits,
                                 out_bits, out_vals, n, c, h, w, kh, kw,
                                 stride, smem, stream);
  return repro::launch_lowered(repro::lowered_rows_kernel<4>, cond, bits,
                               out_bits, out_vals, n, c, h, w, kh, kw, stride,
                               smem, stream);
}
