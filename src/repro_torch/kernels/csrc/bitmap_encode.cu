// K5: dense -> bitmap encode for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/bitmap_encode.py::bitmap_encode_pallas
// (_encode_kernel) of the JAX package.  Per (image, channel, row) of an
// (N, C, H, W) input read through its strides (the conv path hands over
// an NHWC tensor, so W is strided by C): the LSB-first packed non-zero
// bitmap (N, C, H, ceil(W/32)) and the row's non-zeros front-packed
// ("condensed") into (N, C, H, W) with a zero tail.
//
// Bound by bytes: each element is read once and written at most once, and
// the work per element is a compare and a popcount.  One warp walks one
// row in 32-element chunks: __ballot_sync of `v != 0` is the chunk's
// bitmap word, and a lane's slot in the condensed row is the running count
// plus the popcount of the ballot below it.  The TPU's one-hot selection
// matmul (a gather kept on the MXU) is not carried over: a warp ballot
// and a prefix popcount do it directly.  The strided read of an NHWC input
// is not coalesced; neighbouring channels' warps read the same sectors,
// which L2 serves.
#include "bitmap_rows.cuh"

namespace repro {

template <int BYTES>
__global__ void encode_kernel(const void* x_, uint32_t* bits, void* cond_,
                              int n, int c, int h, int w, long long sn,
                              long long sc, long long sh, long long sw) {
  using T = typename Raw<BYTES>::T;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= (long long)n * c * h) return;  // the whole warp leaves
  const int y = (int)(row % h);
  const long long nc = row / h;
  const T* src = static_cast<const T*>(x_) + (nc / c) * sn + (nc % c) * sc +
                 y * sh;
  const int ww = (w + 31) / 32;
  uint32_t* brow = bits + row * ww;
  T* crow = static_cast<T*>(cond_) + row * w;
  int run = 0;  // non-zeros of the row so far
  for (int q = 0; q < ww; ++q) {
    const int col = q * 32 + lane;
    const T v = col < w ? src[col * sw] : T(0);
    const bool nz = (v & Raw<BYTES>::kMag) != 0;
    const unsigned word = __ballot_sync(kFullMask, nz);
    if (lane == 0) brow[q] = word;
    if (nz) crow[run + __popc(word & below(lane))] = v;
    run += __popc(word);
  }
  for (int i = run + lane; i < w; i += 32) crow[i] = T(0);
}

}  // namespace repro

extern "C" int repro_bitmap_encode(int elem_bytes, const void* x, void* bits,
                                   void* cond, int n, int c, int h, int w,
                                   long long sn, long long sc, long long sh,
                                   long long sw, void* stream) {
  const long long rows = (long long)n * c * h;
  if (rows <= 0 || w <= 0) return cudaSuccess;
  constexpr int kWarps = 8;  // rows per 256-thread block
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<uint32_t*>(bits);
  if (elem_bytes == 2) {
    repro::encode_kernel<2><<<blocks, 32 * kWarps, 0, s>>>(
        x, b, cond, n, c, h, w, sn, sc, sh, sw);
  } else if (elem_bytes == 4) {
    repro::encode_kernel<4><<<blocks, 32 * kWarps, 0, s>>>(
        x, b, cond, n, c, h, w, sn, sc, sh, sw);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
