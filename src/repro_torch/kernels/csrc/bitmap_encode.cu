// K5: dense -> bitmap encode for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/bitmap_encode.py::bitmap_encode_pallas
// (_encode_kernel) of the JAX package.  Per (image, channel, row) of an
// (N, C, H, W) input read through its strides: the LSB-first packed
// non-zero bitmap (N, C, H, ceil(W/32)) and the row's non-zeros
// front-packed ("condensed") into (N, C, H, W) with a zero tail.  The
// TPU's one-hot selection matmul (a gather kept on the MXU) is not
// carried over: a warp ballot and a prefix popcount do it directly.
//
// Bound by bytes: each element is read once and written at most once, and
// the work per element is a compare and a popcount.  Two routes, chosen by
// the wrapper's rule (kernels/bitmap_encode.py::encode_route):
//
// * channels (kRouteChannels): the conv path's NHWC input, W strided by C
//   and C contiguous.  Reading a row along W there pulls one sector per
//   element, so a block takes a tile of one (image, y): kTileC channels by
//   a segment of kSeg columns, one warp for each 16 bytes of channels
//   (8 bf16 or 4 float32), one lane for each column of a 32-column word.
//   Each lane loads its columns' channels with 16-byte loads, so the
//   channel row never needs a transposed copy: __ballot_sync over the
//   lanes of one channel's element is that channel's word.  (Staging the
//   tile transposed in shared memory, padded against bank conflicts, and
//   balloting from there measured slower on an H100.)
//   A value's slot in its condensed row is the row's non-zero count before
//   its segment plus its rank inside the segment, so the route runs in two
//   passes: pass 1 writes the words and each segment's count; pass 2 sums
//   the counts of the row's earlier segments (one warp reduction), loads
//   the tile again (mostly from L2), writes the condensed values and the
//   part of the zero tail that falls in its own columns.
//   With 128-column segments and 32-channel tiles, whisper's stem gives
//   288 blocks (conv1) and 1536 (conv2) on the card's 132 SMs (256-column
//   segments, half as many blocks, measured slower at both).  A one-pass
//   form that keeps the tile in registers across a grid-wide barrier
//   (cooperative launch) was no faster over both stem shapes and needs
//   every block resident: not taken.
// * rows (kRouteRows): any other layout (contiguous NCHW, other strides, a
//   base or channel stride that 16-byte loads cannot take, C < 32).  One
//   warp walks one row in 32-element chunks: __ballot_sync of `v != 0` is
//   the chunk's word, and a lane's slot is the running count plus the
//   popcount of the ballot below it.
#include "bitmap_rows.cuh"

namespace repro {

constexpr int kRouteRows = 0, kRouteChannels = 1;
constexpr int kTileC = 32;     // channels of a channels-route tile
constexpr int kSeg = 128;      // columns of a segment
constexpr int kSegWords = kSeg / 32;
constexpr int kThreads = 256;  // the most threads a block has

template <int BYTES>
__global__ void __launch_bounds__(kThreads)
    encode_rows_kernel(const void* x_, uint32_t* bits, void* cond_, int n,
                       int c, int h, int w, long long sn, long long sc,
                       long long sh, long long sw) {
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

// One channels-route tile: block -> (image, y, channel group, segment),
// the segment fastest.  The channel stride is 1.
struct Tile {
  int img, y, c0, cn, col0, ncols, seg;
  __device__ Tile(int c, int h, int w, int nseg) {
    const unsigned ngroups = (c + kTileC - 1) / kTileC;
    unsigned b = blockIdx.x;
    seg = (int)(b % (unsigned)nseg);
    b /= (unsigned)nseg;
    const int g = (int)(b % ngroups);
    b /= ngroups;
    y = (int)(b % (unsigned)h);
    img = (int)(b / (unsigned)h);
    c0 = g * kTileC;
    cn = min(kTileC, c - c0);
    col0 = seg * kSeg;
    ncols = min(kSeg, w - col0);
  }
  // row index (image, channel c0 + ch, y) of the (N, C, H, .) outputs
  __device__ long long row(int ch, int c, int h) const {
    return ((long long)img * c + c0 + ch) * h + y;
  }
};

// A warp's part of a tile: VEC channels (one 16-byte load) of each of the
// segment's columns, lane l holding column 32q + l in d[q].  The lanes'
// loads are strided by the column stride; the warps of a block read the
// rest of each column's channels beside them.
template <int BYTES>
struct Part {
  static constexpr int VEC = 16 / BYTES;
  uint4 d[kSegWords];
  __device__ void load(const void* x_, const Tile& t, int ch0, long long sn,
                       long long sh, long long sw) {
    using T = typename Raw<BYTES>::T;
    const T* base = static_cast<const T*>(x_) + t.img * sn + t.y * sh +
                    t.c0 + ch0 + (long long)t.col0 * sw;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int q = 0; q < kSegWords; ++q) {
      const int col = q * 32 + lane;
      d[q] = col < t.ncols
                 ? *reinterpret_cast<const uint4*>(base + col * sw)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ typename Raw<BYTES>::T at(int q, int j) const {
    return reinterpret_cast<const typename Raw<BYTES>::T*>(&d[q])[j];
  }
};

// pass 1: each (channel, segment)'s words and non-zero count.  Warp v
// takes channels c0 + v*VEC ..; __ballot_sync over the lanes' columns
// turns the loaded columns into each channel's words.
template <int BYTES>
__global__ void __launch_bounds__(kThreads)
    encode_bits_kernel(const void* x_, uint32_t* bits, int* counts, int c,
                       int h, int w, long long sn, long long sh, long long sw,
                       int nseg) {
  constexpr int VEC = Part<BYTES>::VEC;
  const Tile t(c, h, w, nseg);
  const int lane = threadIdx.x & 31, ch0 = (threadIdx.x >> 5) * VEC;
  if (ch0 >= t.cn) return;  // the whole warp leaves
  Part<BYTES> part;
  part.load(x_, t, ch0, sn, sh, sw);
  const int ww = (w + 31) / 32, nq = (t.ncols + 31) / 32;
  // lane kSegWords*(j % kPer) + q holds channel j's word q in mine[j/kPer]
  constexpr int kPer = 32 / kSegWords;
  unsigned mine[(VEC + kPer - 1) / kPer] = {};
  int cnt = 0;                  // lane j: channel j's count
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    int k = 0;
#pragma unroll
    for (int q = 0; q < kSegWords; ++q) {
      const unsigned word = __ballot_sync(
          kFullMask, (part.at(q, j) & Raw<BYTES>::kMag) != 0);
      if (lane == (j % kPer) * kSegWords + q) mine[j / kPer] = word;
      k += __popc(word);
    }
    if (lane == j) cnt = k;
  }
  const int q = lane % kSegWords;
#pragma unroll
  for (int i = 0; i < (VEC + kPer - 1) / kPer; ++i) {
    const int j = i * kPer + lane / kSegWords;
    if (q < nq && j < VEC)
      bits[t.row(ch0 + j, c, h) * ww + t.seg * kSegWords + q] = mine[i];
  }
  if (lane < VEC) counts[t.row(ch0 + lane, c, h) * nseg + t.seg] = cnt;
}

// pass 2: each (channel, segment)'s condensed values and its share of the
// row's zero tail
template <int BYTES>
__global__ void __launch_bounds__(kThreads)
    encode_values_kernel(const void* x_, const int* counts, void* cond_,
                         int c, int h, int w, long long sn, long long sh,
                         long long sw, int nseg) {
  using T = typename Raw<BYTES>::T;
  constexpr int VEC = Part<BYTES>::VEC;
  const Tile t(c, h, w, nseg);
  const int lane = threadIdx.x & 31, ch0 = (threadIdx.x >> 5) * VEC;
  if (ch0 >= t.cn) return;
  // the rows' segment counts (lane s holds segment s), loaded beside x
  int cnt[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    cnt[j] = lane < nseg ? counts[t.row(ch0 + j, c, h) * nseg + lane] : 0;
  Part<BYTES> part;
  part.load(x_, t, ch0, sn, sh, sw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const long long r = t.row(ch0 + j, c, h);
    // the row's non-zeros before this segment, and in all
    int before = lane < t.seg ? cnt[j] : 0, total = cnt[j];
    for (int s = lane + 32; s < nseg; s += 32) {  // rows past 32 segments
      const int k = counts[r * nseg + s];
      total += k;
      if (s < t.seg) before += k;
    }
    before = (int)__reduce_add_sync(kFullMask, (unsigned)before);
    total = (int)__reduce_add_sync(kFullMask, (unsigned)total);
    T* crow = static_cast<T*>(cond_) + r * w;
    int run = before;
#pragma unroll
    for (int q = 0; q < kSegWords; ++q) {
      const T v = part.at(q, j);
      const bool nz = (v & Raw<BYTES>::kMag) != 0;
      const unsigned word = __ballot_sync(kFullMask, nz);
      if (nz) crow[run + __popc(word & below(lane))] = v;
      run += __popc(word);
    }
    // the zero tail [total, w), this segment's columns of it
    for (int i = max(total, t.col0) + lane; i < t.col0 + t.ncols; i += 32)
      crow[i] = T(0);
  }
}

template <int BYTES>
int launch(int route, const void* x, uint32_t* bits, void* cond, int* counts,
           int n, int c, int h, int w, long long sn, long long sc,
           long long sh, long long sw, cudaStream_t s) {
  if (route == kRouteRows) {
    const long long rows = (long long)n * c * h;
    const unsigned blocks = (unsigned)((rows + 7) / 8);  // a warp a row
    encode_rows_kernel<BYTES><<<blocks, kThreads, 0, s>>>(
        x, bits, cond, n, c, h, w, sn, sc, sh, sw);
    return cudaGetLastError();
  }
  // the wrapper's rule holds; checked again, since a 16-byte load of a
  // misaligned address faults
  const long long a = (long long)(uintptr_t)x;
  if (route != kRouteChannels || sc != 1 || c < kTileC ||
      (c * BYTES) % 16 || a % 16 || (n > 1 && (sn * BYTES) % 16) ||
      (h > 1 && (sh * BYTES) % 16) || (w > 1 && (sw * BYTES) % 16))
    return cudaErrorInvalidValue;
  const int nseg = (w + kSeg - 1) / kSeg;
  const long long blocks =
      (long long)nseg * ((c + kTileC - 1) / kTileC) * h * n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int threads = 32 * kTileC / Part<BYTES>::VEC;
  encode_bits_kernel<BYTES><<<(unsigned)blocks, threads, 0, s>>>(
      x, bits, counts, c, h, w, sn, sh, sw, nseg);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  encode_values_kernel<BYTES><<<(unsigned)blocks, threads, 0, s>>>(
      x, counts, cond, c, h, w, sn, sh, sw, nseg);
  return cudaGetLastError();
}

}  // namespace repro

// route: 0 rows, 1 channels; counts: (N*C*H, ceil(W/kSeg)) int32 scratch
// of the channels route (unused by the rows route)
extern "C" int repro_bitmap_encode(int route, int elem_bytes, const void* x,
                                   void* bits, void* cond, void* counts,
                                   int n, int c, int h, int w, long long sn,
                                   long long sc, long long sh, long long sw,
                                   void* stream) {
  if ((long long)n * c * h <= 0 || w <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<uint32_t*>(bits);
  auto k = static_cast<int*>(counts);
  if (elem_bytes == 2)
    return repro::launch<2>(route, x, b, cond, k, n, c, h, w, sn, sc, sh, sw,
                            s);
  if (elem_bytes == 4)
    return repro::launch<4>(route, x, b, cond, k, n, c, h, w, sn, sc, sh, sw,
                            s);
  return cudaErrorInvalidValue;
}
