// The grouped K3/K4's own routes: the decode attention's two products.
//
// Replaces, with grouped_spgemm{,_kfused}.cu, the JAX package's TPU kernels
// kernels/grouped_spgemm.py::grouped_spgemm_planned (_grouped_kernel) and
// ::grouped_spgemm_kfused_planned (_grouped_kfused_kernel) at the shapes
// the 128-column kernels (spgemm_mma.cuh, spgemm_tile.cuh) serve badly.
// C[e] = A[e] @ B[e] for E stacked problems, schedules as in spgemm_mma.cuh:
// ks (E, Mt, Nt, S) front-packed k-slices (KFUSED = false) or gk
// (E, Mt, Nt, S, slice_k) gathered positions (KFUSED = true); steps
// t < min(counts, S) only; positions outside [0, K), rows >= M and columns
// >= N read as zero (masked, no operand padded); counts == 0 tiles store
// zeros and load nothing.  Sums are float32, cast once on store.
//
// 1. Narrow N (route 2): bfloat16 A and B with N <= 16, the score
//    K[e] (T, hd) @ q[e]^T (hd, G) at G = 12.  A 128-column block would
//    leave 116 of its columns idle, and there is one tile per block-row of
//    cache slots, most unscheduled.  Here one warp owns one output tile of
//    up to 64 rows (16 / 32 / 64: the smallest that holds block_m) by all
//    16 columns; a problem's tiles are dealt to its CUDA blocks (8 warps)
//    in turn, so that the scheduled tiles of a cache's written front fall
//    on different SMs.  B[e] (K x N, 4.6 KB at hd 192) is staged in shared
//    memory, transposed, through registers (its 24-byte rows rule out
//    cp.async's 16-byte copies), by blocks with a scheduled tile only (9
//    of a problem's 16 at 271 written slots).  A warp reads A straight
//    into its mma fragments: within each 32-position chunk lane (g, t)
//    loads rows g and g + 8 at positions 8t .. 8t + 7 (one 16-byte load a
//    row), and the two k16 products of the chunk take them in a permuted
//    order that B's fragments (16-byte shared loads at the same positions)
//    follow, so every position still meets its own B row.  A lane's 8
//    positions go by one 16-byte load a row wherever they are consecutive
//    from a multiple of 8 (K3's slices; K4's gathers over a wholly active
//    head), else one by one.  Columns 12-15 read zero from shared memory
//    and are not stored.  Two chunks' loads are issued before their mma,
//    and the next two chunks' schedule words are read while they fly;
//    at most 128 registers a thread let two CUDA blocks share an SM, so
//    the served score's 256 blocks run in one wave.  Its bound is set by
//    bytes (2*G flops per byte of K: the scheduled key rows, B and the
//    float32 output, which the unscheduled tiles write as zeros); at the
//    decode shape its time is set by a few dependent trips to device
//    memory.
// 2. Mixed (route 3): float32 A, bfloat16 B, the value p[e] (G, T) @
//    V[e] (T, hd), with V read as stored (no float32 copy of the cache).
//    B's rows are loaded as bf16, 16 bytes (8 columns) at a time where
//    aligned, and widened in registers, which is exact; the products and
//    sums are SIMT float32 FMA, so the result is the float32 walk's up to
//    the order of the sums.  At G = 12 the product does 12 flops per byte
//    of V, under float32 SIMT's ridge of about 20: bytes bound it, and bf16
//    V halves them.  The work is small (one problem's scheduled V is
//    288 x 192 at 271 tokens), so the design is for latency: a CUDA block
//    owns 16 rows by 32 columns of one tile, and its 256 threads split the
//    tile's scheduled positions 64 ways (4 threads, 8 columns each, a
//    position), each thread two positions a round with all their loads in
//    flight and the next round's schedule words read meanwhile.  The 64
//    partial sums of each output meet in a fixed order
//    (shuffles within a warp, then the 8 warps in turn in shared memory),
//    so results do not vary from run to run.  At the served shape that is
//    96 CUDA blocks of 3 rounds, against the 128-column kernel's 32 blocks
//    of 9 sequential chunks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spgemm_mma.cuh"
#include "spgemm_tile.cuh"

namespace repro {
namespace grouped {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// --- 1. narrow N --------------------------------------------------------

constexpr int kNarrowN = 16;          // two n8 fragments
constexpr int kNarrowMaxK = 2048;     // B staged whole: 66.5 KB of bf16
constexpr int kChunk = 32;            // positions of two k16 products
constexpr int kGroup = 2;             // chunks whose loads fly together
                                      // (1 for 64-row warp tiles)

// shared row pitch of the staged B^T (elements): = 32 mod 64, so that the
// 16-byte reads of rows g and g + 1 fall 64 bytes apart in the banks
__host__ __device__ constexpr int narrow_pitch(int k) {
  return (k + 63) / 64 * 64 + 32;
}

struct NarrowArgs {
  const uint16_t* a;    // bf16 bits
  const uint16_t* b;
  const int* sched;
  const int* counts;
  void* out;
  int out_f32;
  int m, n, k, mt, nt, s, block_m, block_n, slice_k;
  int msub;             // warp tiles per output tile along rows
  int items;            // warp tiles per problem: mt * msub * nt
  int bpp;              // CUDA blocks per problem
  int pitch;
  int a_vec;            // A's rows 16-byte aligned
  int b_vec;            // B[p] 16-byte aligned
};

// two CUDA blocks an SM (at most 128 registers a thread), so that the
// decode score's 256 blocks run in one wave
template <int WR, bool KFUSED>
__global__ void __launch_bounds__(kThreads, 2)
narrow_kernel(const NarrowArgs args) {
  constexpr int MT = WR / 16;                 // m16 tiles per warp
  constexpr int GROUP = MT <= 2 ? kGroup : kGroup / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* bs = reinterpret_cast<uint16_t*>(smem_raw);   // [16][pitch]

  const int m = args.m, n = args.n, k = args.k, pitch = args.pitch;
  const int slice_k = args.slice_k;
  const long long p = blockIdx.x / args.bpp;  // problem
  const int tid = threadIdx.x, lane = tid & 31;

  // this warp's tile (i, mi, j) of problem p, if it has one: a problem's
  // tiles are dealt to its blocks in turn, so that neighbouring scheduled
  // tiles (a cache's written slots) fall on different SMs
  const int w = (blockIdx.x % args.bpp) + (tid >> 5) * args.bpp;
  const int j = w % args.nt;
  const int mi = (w / args.nt) % args.msub;
  const int i = w / (args.nt * args.msub);
  const long long tile = (p * args.mt + i) * args.nt + j;
  const int row_lo = i * args.block_m + mi * WR;
  const int row_hi = min(min(i * args.block_m + args.block_m, row_lo + WR), m);
  const int col_lo = j * args.block_n;
  const int col_hi = min(col_lo + args.block_n, n);
  const bool live = w < args.items && row_lo < row_hi && col_lo < col_hi;
  const int steps = live ? max(min(args.counts[tile], args.s), 0) : 0;

  // B[p] (K x N, row-major) transposed into bs[col][pos], columns >= N and
  // positions >= K zero; only in blocks with a scheduled tile (most of the
  // decode score's blocks only store zeros)
  if (__syncthreads_or(steps > 0)) {
    for (int x = tid; x < kNarrowN * pitch; x += kThreads)
      if (x / pitch >= n || x % pitch >= k) bs[x] = 0;
    const uint16_t* b = args.b + p * k * n;
    const int kn = k * n;
    if (args.b_vec) {                 // 8 elements a 16-byte load
#pragma unroll 4
      for (int v = tid; v < kn / 8; v += kThreads) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(b) + v);
        const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
        int kk = v * 8 / n, nn = v * 8 % n;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          bs[nn * pitch + kk] =
              static_cast<uint16_t>(wd[e >> 1] >> (16 * (e & 1)));
          if (++nn == n) { nn = 0; ++kk; }
        }
      }
    } else {
#pragma unroll 4
      for (int f = tid; f < kn; f += kThreads)
        bs[(f % n) * pitch + f / n] = __ldg(b + f);
    }
    __syncthreads();
  }
  if (!live) return;

  const uint16_t* a = args.a + p * m * k;
  const int* my = args.sched + tile * args.s * (KFUSED ? slice_k : 1);
  const int cps = (slice_k + kChunk - 1) / kChunk;   // chunks per step
  const int total = steps * cps;
  const int g = lane >> 2, t4 = lane & 3;

  float acc[MT][2][4];
#pragma unroll
  for (int x = 0; x < MT; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int z = 0; z < 4; ++z) acc[x][y][z] = 0.f;

  // contraction positions of this lane's 8 step lanes 8t .. 8t + 7 of
  // chunk q (-1: reads zero)
  auto positions = [&](int q, int (&kx)[8]) {
    const int t = q / cps;
    const int x0 = (q % cps) * kChunk + 8 * t4;
    const int base = (!KFUSED && q < total) ? my[t] * slice_k : 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int x = x0 + e;
      int kk = -1;
      if (q < total && x < slice_k)
        kk = KFUSED ? my[static_cast<long long>(t) * slice_k + x] : base + x;
      kx[e] = (kk >= 0 && kk < k) ? kk : -1;
    }
  };

  int kx[GROUP][8];
#pragma unroll
  for (int u = 0; u < GROUP; ++u) positions(u, kx[u]);
  for (int q0 = 0; q0 < total; q0 += GROUP) {
    // per chunk: A rows (m16 tile, g / g + 8) and B columns (n8 tile) at
    // this lane's 8 positions, as four 32-bit words of bf16 pairs
    uint32_t av[GROUP][MT][2][4];
    uint32_t bv[GROUP][2][4];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      // 8 consecutive positions from a multiple of 8: one 16-byte load a
      // row (K3's slices whenever A's layout allows; K4's gathers where
      // they happen to be contiguous, as a wholly active head is)
      // (decided for the whole warp, so that it takes one path)
      const int kx0 = kx[u][0];
      bool vec = args.a_vec && kx0 >= 0 && (kx0 & 7) == 0;
#pragma unroll
      for (int e = 1; e < 8; ++e) vec = vec && kx[u][e] == kx0 + e;
      if (__all_sync(0xffffffffu, vec)) {
#pragma unroll
        for (int x = 0; x < MT; ++x)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row_lo + x * 16 + g + 8 * h;
            const uint4 v = row < row_hi
                ? __ldg(reinterpret_cast<const uint4*>(
                      a + static_cast<long long>(row) * k + kx0))
                : make_uint4(0u, 0u, 0u, 0u);
            av[u][x][h][0] = v.x; av[u][x][h][1] = v.y;
            av[u][x][h][2] = v.z; av[u][x][h][3] = v.w;
          }
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int col = col_lo + y * 8 + g;
          const uint4 v = col < col_hi
              ? *reinterpret_cast<const uint4*>(bs + col * pitch + kx0)
              : make_uint4(0u, 0u, 0u, 0u);
          bv[u][y][0] = v.x; bv[u][y][1] = v.y;
          bv[u][y][2] = v.z; bv[u][y][3] = v.w;
        }
      } else {
        // position by position
#pragma unroll
        for (int x = 0; x < MT; ++x)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row_lo + x * 16 + g + 8 * h;
            const bool rok = row < row_hi;
            const uint16_t* src = a + static_cast<long long>(rok ? row : 0) * k;
#pragma unroll
            for (int wd = 0; wd < 4; ++wd) {
              const int k0 = kx[u][2 * wd], k1 = kx[u][2 * wd + 1];
              const uint32_t lo = rok && k0 >= 0 ? __ldg(src + k0) : 0u;
              const uint32_t hi = rok && k1 >= 0 ? __ldg(src + k1) : 0u;
              av[u][x][h][wd] = lo | (hi << 16);
            }
          }
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int col = col_lo + y * 8 + g;
          const bool cok = col < col_hi;
          const uint16_t* src = bs + (cok ? col : 0) * pitch;
#pragma unroll
          for (int wd = 0; wd < 4; ++wd) {
            const int k0 = kx[u][2 * wd], k1 = kx[u][2 * wd + 1];
            const uint32_t lo = cok && k0 >= 0
                ? static_cast<uint32_t>(src[k0]) : 0u;
            const uint32_t hi = cok && k1 >= 0
                ? static_cast<uint32_t>(src[k1]) : 0u;
            bv[u][y][wd] = lo | (hi << 16);
          }
        }
      }
    }
    // the next group's positions, read while this group's operands load
#pragma unroll
    for (int u = 0; u < GROUP; ++u) positions(q0 + GROUP + u, kx[u]);
    // k16 product hk of a chunk takes this lane's positions 4hk .. 4hk + 3
    // as its k = 2t, 2t + 1 (word 2hk) and 2t + 8, 2t + 9 (word 2hk + 1),
    // in A's fragment and B's alike
#pragma unroll
    for (int u = 0; u < GROUP; ++u)
#pragma unroll
      for (int hk = 0; hk < 2; ++hk)
#pragma unroll
        for (int x = 0; x < MT; ++x) {
          const uint32_t af[4] = {av[u][x][0][2 * hk], av[u][x][1][2 * hk],
                                  av[u][x][0][2 * hk + 1],
                                  av[u][x][1][2 * hk + 1]};
#pragma unroll
          for (int y = 0; y < 2; ++y)
            mma::mma_bf16(acc[x][y], af, bv[u][y][2 * hk],
                          bv[u][y][2 * hk + 1]);
        }
  }

  // fragment (x, y) holds rows g, g + 8 and columns 2t, 2t + 1
#pragma unroll
  for (int x = 0; x < MT; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        const int row = row_lo + x * 16 + g + (z >> 1) * 8;
        const int col = col_lo + y * 8 + 2 * t4 + (z & 1);
        if (row >= row_hi || col >= col_hi) continue;
        const long long idx = (p * m + row) * static_cast<long long>(n) + col;
        if (args.out_f32) static_cast<float*>(args.out)[idx] = acc[x][y][z];
        else static_cast<__nv_bfloat16*>(args.out)[idx] =
            __float2bfloat16(acc[x][y][z]);
      }
}

template <int WR, bool KFUSED>
static int launch_narrow_wr(NarrowArgs args, int e, cudaStream_t stream) {
  args.msub = (args.block_m + WR - 1) / WR;
  const long long items = static_cast<long long>(args.mt) * args.msub *
                          args.nt;
  const long long bpp = (items + kWarps - 1) / kWarps;
  if (items > 0x7fffffffLL || bpp * e > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  args.items = static_cast<int>(items);
  args.bpp = static_cast<int>(bpp);
  const int smem = kNarrowN * args.pitch * 2;
  cudaError_t err = cudaFuncSetAttribute(
      narrow_kernel<WR, KFUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  narrow_kernel<WR, KFUSED><<<static_cast<unsigned>(bpp * e), kThreads, smem,
                              stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 A and B, N <= kNarrowN, K <= kNarrowMaxK (else refused:
// cudaErrorInvalidValue; the wrapper's route rule never asks)
template <bool KFUSED>
static int launch_narrow(int out_f32, const void* a, const void* b,
                         const void* sched, const void* counts, void* out,
                         int e, int m, int n, int k, int mt, int nt, int s,
                         int block_m, int block_n, int slice_k,
                         cudaStream_t stream) {
  if (n > kNarrowN || k > kNarrowMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  NarrowArgs args{};
  args.a = static_cast<const uint16_t*>(a);
  args.b = static_cast<const uint16_t*>(b);
  args.sched = static_cast<const int*>(sched);
  args.counts = static_cast<const int*>(counts);
  args.out = out;
  args.out_f32 = out_f32;
  args.m = m; args.n = n; args.k = k; args.mt = mt; args.nt = nt;
  args.s = s; args.block_m = block_m; args.block_n = block_n;
  args.slice_k = slice_k;
  args.pitch = narrow_pitch(k);
  args.a_vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 && k % 8 == 0;
  args.b_vec = reinterpret_cast<uintptr_t>(b) % 16 == 0 && k * n % 8 == 0;
  if (block_m <= 16) return launch_narrow_wr<16, KFUSED>(args, e, stream);
  if (block_m <= 32) return launch_narrow_wr<32, KFUSED>(args, e, stream);
  return launch_narrow_wr<64, KFUSED>(args, e, stream);
}

// --- 2. float32 A x bfloat16 B ------------------------------------------

constexpr int kRows = 16;                     // rows per CUDA block
constexpr int kCols = 32;                     // columns per CUDA block
constexpr int kVec = 8;                       // columns per thread
constexpr int kShare = kCols / kVec;          // threads per position
constexpr int kLanes = kThreads / kShare;     // positions walked at once
constexpr int kUnroll = 2;                    // positions a thread a round

struct MixedArgs {
  const float* a;
  const uint16_t* b;    // bf16 bits
  const int* sched;
  const int* counts;
  void* out;
  int out_f32;
  int m, n, k, mt, nt, s, block_m, block_n, slice_k;
  int msub, nsub;       // CUDA blocks per tile along rows / columns
  int b_vec;            // 16-byte loads of B possible
};

template <bool KFUSED>
__global__ void __launch_bounds__(kThreads)
mixed_kernel(const MixedArgs args) {
  __shared__ float red[kWarps][kRows][kCols];

  const int m = args.m, n = args.n, k = args.k, slice_k = args.slice_k;
  long long bid = blockIdx.x;
  const int nj = static_cast<int>(bid % args.nsub); bid /= args.nsub;
  const int j = static_cast<int>(bid % args.nt); bid /= args.nt;
  const int mi = static_cast<int>(bid % args.msub); bid /= args.msub;
  const int i = static_cast<int>(bid % args.mt); bid /= args.mt;
  const long long p = bid;                    // problem
  const long long tile = (p * args.mt + i) * args.nt + j;
  const int row_lo = i * args.block_m + mi * kRows;
  const int row_hi = min(min(i * args.block_m + args.block_m,
                             row_lo + kRows), m);
  const int col_lo = j * args.block_n + nj * kCols;
  const int col_hi = min(min(j * args.block_n + args.block_n,
                             col_lo + kCols), n);
  if (row_lo >= row_hi || col_lo >= col_hi) return;   // wholly past an edge

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane % kShare;               // columns cg*8 .. of the block
  const int cl = warp * (32 / kShare) + lane / kShare;   // position lane
  const int col0 = col_lo + cg * kVec;
  const float* a = args.a + p * m * k;
  const uint16_t* b = args.b + p * k * n;
  const int* my = args.sched + tile * args.s * (KFUSED ? slice_k : 1);
  const int steps = max(min(args.counts[tile], args.s), 0);
  const int total = steps * slice_k;          // the tile's step lanes

  float acc[kRows][kVec];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[r][c] = 0.f;

  // contraction positions of this thread's round at f0 (-1: reads zero)
  auto positions = [&](int f0, int (&kx)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f = f0 + u * kLanes;
      int kk = -1;
      if (f < total) {
        const int t = f / slice_k, x = f - t * slice_k;
        kk = KFUSED ? my[f] : my[t] * slice_k + x;
      }
      kx[u] = (kk >= 0 && kk < k) ? kk : -1;
    }
  };

  int kx[kUnroll];
  positions(cl, kx);
  for (int f0 = cl; f0 < total; f0 += kLanes * kUnroll) {
    // B's 8 columns as bf16 pairs, A's rows as float
    uint32_t bw[kUnroll][4];
    float af[kUnroll][kRows];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint16_t* src = b + static_cast<long long>(max(kx[u], 0)) * n
                            + col0;
      if (args.b_vec) {
        const uint4 v = (kx[u] >= 0 && col0 < col_hi)
            ? __ldg(reinterpret_cast<const uint4*>(src))
            : make_uint4(0u, 0u, 0u, 0u);
        bw[u][0] = v.x; bw[u][1] = v.y; bw[u][2] = v.z; bw[u][3] = v.w;
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const uint32_t lo = kx[u] >= 0 && col0 + 2 * w < col_hi
              ? __ldg(src + 2 * w) : 0u;
          const uint32_t hi = kx[u] >= 0 && col0 + 2 * w + 1 < col_hi
              ? __ldg(src + 2 * w + 1) : 0u;
          bw[u][w] = lo | (hi << 16);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        af[u][r] = (kx[u] >= 0 && row_lo + r < row_hi)
            ? __ldg(a + static_cast<long long>(row_lo + r) * k + kx[u])
            : 0.f;
    }
    // the next round's positions, read while this round's operands load
    positions(f0 + kLanes * kUnroll, kx);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const uint32_t w = bw[u][c >> 1];
        const float bv = __uint_as_float((c & 1) ? (w & 0xffff0000u)
                                                 : (w << 16));
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r][c] = fmaf(af[u][r], bv, acc[r][c]);
      }
  }

  // the warp's position lanes (lane bits 2-4), then the warps in order
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      float v = acc[r][c];
#pragma unroll
      for (int off = kShare; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][c] = v;
    }
  if (lane < kShare) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kVec; ++c) red[warp][r][cg * kVec + c] = acc[r][c];
  }
  __syncthreads();
  for (int o = tid; o < kRows * kCols; o += kThreads) {
    const int r = o / kCols, c = o % kCols;
    const int row = row_lo + r, col = col_lo + c;
    if (row >= row_hi || col >= col_hi) continue;
    float v = red[0][r][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][r][c];
    const long long idx = (p * m + row) * static_cast<long long>(n) + col;
    if (args.out_f32) static_cast<float*>(args.out)[idx] = v;
    else static_cast<__nv_bfloat16*>(args.out)[idx] = __float2bfloat16(v);
  }
}

template <bool KFUSED>
static int launch_mixed(int out_f32, const void* a, const void* b,
                        const void* sched, const void* counts, void* out,
                        int e, int m, int n, int k, int mt, int nt, int s,
                        int block_m, int block_n, int slice_k,
                        cudaStream_t stream) {
  MixedArgs args{};
  args.a = static_cast<const float*>(a);
  args.b = static_cast<const uint16_t*>(b);
  args.sched = static_cast<const int*>(sched);
  args.counts = static_cast<const int*>(counts);
  args.out = out;
  args.out_f32 = out_f32;
  args.m = m; args.n = n; args.k = k; args.mt = mt; args.nt = nt;
  args.s = s; args.block_m = block_m; args.block_n = block_n;
  args.slice_k = slice_k;
  args.msub = (block_m + kRows - 1) / kRows;
  args.nsub = (block_n + kCols - 1) / kCols;
  // problem p's B starts p*k*n elements in: still 16-byte aligned when N
  // is a multiple of 8; column blocks start on multiples of 8 when
  // block_n is
  args.b_vec = reinterpret_cast<uintptr_t>(b) % 16 == 0 && n % kVec == 0 &&
               block_n % kVec == 0;
  const long long blocks = static_cast<long long>(e) * mt * args.msub * nt *
                           args.nsub;
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  mixed_kernel<KFUSED><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace grouped
}  // namespace repro
