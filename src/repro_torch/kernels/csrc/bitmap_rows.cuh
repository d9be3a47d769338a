// Shared pieces of the conv kernels K5-K7 (bitmap encode and the implicit
// bitmap im2col) for Hopper (sm_90a).
//
// The three kernels only move data: they test elements for non-zero,
// pack bits, count them and copy values.  So they copy raw element bit
// patterns (Raw<BYTES>::T) and every output is bit-equal to the plain
// version in any float type of that width.  Bitmaps are 32-bit words,
// LSB first: bit i of word q is column 32q + i.  The PyTorch side holds
// them as int32 bit patterns; here they are uint32_t only, because a
// right shift of a signed word with bit 31 set would smear ones into the
// window.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;
// the im2col kernels' routes, as their wrappers number them
constexpr int kRouteLowered = 0, kRouteFeature = 1;
// the dynamic shared memory one block may use on the H100
constexpr long long kMaxSmem = 227 * 1024;

// raw element bits by width; an element is non-zero iff its magnitude
// bits are (so -0.0 is zero, NaN is not, as `x != 0` has it)
template <int BYTES> struct Raw;
template <> struct Raw<2> {
  using T = uint16_t;
  static constexpr T kMag = 0x7fff;
};
template <> struct Raw<4> {
  using T = uint32_t;
  static constexpr T kMag = 0x7fffffffu;
};

// the bits of a word below bit b (b < 32: 1u << 32 is undefined)
__device__ __forceinline__ unsigned below(unsigned b) {
  return (1u << b) - 1u;
}

__host__ __device__ constexpr long long align16(long long b) {
  return (b + 15) & ~15ll;
}

// Exclusive prefix sum of v over the block, in thread order; *total gets
// the block's sum.  Every thread of the block must call it.  blockDim.x
// is a multiple of 32, at most 1024; sh holds 33 ints.  Ends with a
// barrier, so sh may be reused at once.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total,
                                                    int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < nwarps ? sh[lane] : 0;
    int s = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, s, o);
      if (lane >= o) s += y;
    }
    sh[lane] = s - t;
    if (lane == 31) sh[32] = s;
  }
  __syncthreads();
  const int out = sh[warp] + x - v;
  *total = sh[32];
  __syncthreads();
  return out;
}

// Geometry of one lowered row k = (dy*kw + dx)*c + ci of image n, and its
// pointers: the feature row's condensed values and bitmap words, and the
// lowered row's row-packed bits (oh, oww) and values (p).
template <typename T>
struct LoweredRow {
  const T* cond;        // (h, w) of channel ci
  const uint32_t* bits;  // (h, ww) of channel ci
  uint32_t* out_bits;   // (oh, oww)
  T* out_vals;          // (p,)
  int dy, dx, oh, ow, ww, oww;
  long long p;

  __device__ LoweredRow(const void* cond_, const uint32_t* bits_,
                        uint32_t* out_bits_, void* out_vals_, int c, int h,
                        int w, int kh, int kw, int stride) {
    const int k = blockIdx.x, n = blockIdx.y;
    const int ci = k % c, dxy = k / c;
    dx = dxy % kw;
    dy = dxy / kw;
    oh = (h - kh) / stride + 1;
    ow = (w - kw) / stride + 1;
    ww = (w + 31) / 32;
    oww = (ow + 31) / 32;
    p = (long long)oh * ow;
    const long long kkc = (long long)kh * kw * c;
    const long long chan = (long long)n * c + ci;
    cond = static_cast<const T*>(cond_) + chan * h * w;
    bits = bits_ + chan * h * ww;
    out_bits = out_bits_ + ((long long)n * kkc + k) * oh * oww;
    out_vals = static_cast<T*>(out_vals_) + ((long long)n * kkc + k) * p;
  }
};

// the launch both im2col kernels share: one block per (lowered row,
// image), 256 threads, `smem` bytes of dynamic shared memory
template <typename Kernel>
int launch_lowered(Kernel kernel, const void* cond, const void* bits,
                   void* out_bits, void* out_vals, int n, int c, int h,
                   int w, int kh, int kw, int stride, size_t smem,
                   void* stream) {
  const long long kkc = (long long)kh * kw * c;
  if (kkc <= 0 || n <= 0) return cudaSuccess;
  const dim3 grid((unsigned)kkc, (unsigned)n);
  kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      cond, static_cast<const uint32_t*>(bits),
      static_cast<uint32_t*>(out_bits), out_vals, c, h, w, kh, kw, stride);
  return cudaGetLastError();
}

}  // namespace repro
