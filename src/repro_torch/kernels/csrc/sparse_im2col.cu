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
// Traps: the words are uint32_t (a signed shift would sign-extend); r == 0
// takes word q whole, since `x << 32` is undefined; word q+1 past the
// row's last word reads as zero (the JAX kernel pads the bitmap by one
// word instead).
//
// Bound by bytes, like the data movement it is: the lowered row's values
// are written once and read from the condensed row once.  One block per
// (lowered row, image) walks its output rows in order, because each
// row's segment starts where the previous one ended; within a row the
// words and the copy spread over the block's threads.
#include "bitmap_rows.cuh"

namespace repro {

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

}  // namespace repro

extern "C" int repro_sparse_im2col(int elem_bytes, const void* cond,
                                   const void* bits, void* out_bits,
                                   void* out_vals, int n, int c, int h, int w,
                                   int kh, int kw, int stride, void* stream) {
  if (stride != 1) return cudaErrorInvalidValue;
  if (elem_bytes == 2)
    return repro::launch_lowered(repro::im2col_kernel<2>, cond, bits,
                                 out_bits, out_vals, n, c, h, w, kh, kw,
                                 stride, 0, stream);
  if (elem_bytes == 4)
    return repro::launch_lowered(repro::im2col_kernel<4>, cond, bits,
                                 out_bits, out_vals, n, c, h, w, kh, kw,
                                 stride, 0, stream);
  return cudaErrorInvalidValue;
}
