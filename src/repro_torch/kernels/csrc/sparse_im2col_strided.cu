// K7: implicit bitmap im2col at stride >= 2 for Hopper (sm_90a).
//
// Replaces the TPU kernel
// kernels/sparse_im2col.py::sparse_im2col_strided_pallas
// (_im2col_kernel_strided) of the JAX package, with K6's output contract:
// row-packed lowered bits (N, KKC, OH, ceil(OW/32)) and the lowered rows'
// condensed values (N, KKC, P), zero tail.  At stride s the window's bits
// are not contiguous in the feature row, so there is no word shift: bit
// ox*s + dx of feature row oy*s + dy is tested directly, and its value's
// offset in the row's condensed values is the exclusive popcount prefix
// of the row's words (held in shared memory, one int a word) plus the
// popcount of its word below it.  The set bits of an output row are then
// compacted in order: the warp's __ballot_sync is the output word, and a
// block-wide prefix of the bits is each value's slot.  The TPU's one-hot
// row, column and gather matmuls are not carried over.
//
// Bound by bytes, as K6.  One block per (lowered row, image) walks its
// output rows in order; within a row its threads take 256 output columns
// at a time.  The words are uint32_t and every shift is below 32.
#include "bitmap_rows.cuh"

namespace repro {

template <int BYTES>
__global__ void im2col_strided_kernel(const void* cond, const uint32_t* bits,
                                      uint32_t* out_bits, void* out_vals,
                                      int c, int h, int w, int kh, int kw,
                                      int stride) {
  using T = typename Raw<BYTES>::T;
  extern __shared__ int smem[];
  int* sh = smem;        // the scan's 33 ints
  int* pre = smem + 33;  // (ww,) exclusive popcount prefix of one row
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

}  // namespace repro

extern "C" int repro_sparse_im2col_strided(int elem_bytes, const void* cond,
                                           const void* bits, void* out_bits,
                                           void* out_vals, int n, int c,
                                           int h, int w, int kh, int kw,
                                           int stride, void* stream) {
  if (stride < 1) return cudaErrorInvalidValue;
  // the wrapper keeps this under the 48 KB of static shared memory
  const size_t smem = (33 + (size_t)(w + 31) / 32) * sizeof(int);
  if (elem_bytes == 2)
    return repro::launch_lowered(repro::im2col_strided_kernel<2>, cond, bits,
                                 out_bits, out_vals, n, c, h, w, kh, kw,
                                 stride, smem, stream);
  if (elem_bytes == 4)
    return repro::launch_lowered(repro::im2col_strided_kernel<4>, cond, bits,
                                 out_bits, out_vals, n, c, h, w, kh, kw,
                                 stride, smem, stream);
  return cudaErrorInvalidValue;
}
