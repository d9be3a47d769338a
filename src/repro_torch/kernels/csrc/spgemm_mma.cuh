// Tensor-core tile kernel of the dual-side sparse GEMMs K1/K2, bfloat16
// operands (float32 operands stay on the SIMT kernel, spgemm_tile.cuh).
//
// Replaces, with bitmap_spgemm{,_kfused}.cu, the JAX package's TPU kernels
// kernels/bitmap_spgemm.py::bitmap_spgemm_planned (_spgemm_kernel) and
// ::bitmap_spgemm_kfused_planned (_spgemm_kfused_kernel).
//
// C = A @ B for E stacked problems (E = 1 for K1/K2), A (E, M, K) and
// B (E, K, N) row-major bfloat16, output float32 or bfloat16, tiled into
// (block_m x block_n) blocks with a per-block schedule:
//
//   K1 (KFUSED = false): ks (E, Mt, Nt, S) int32, front-packed active
//      k-slices; step t covers positions [ks[t] * slice_k, + slice_k).
//   K2 (KFUSED = true):  gk (E, Mt, Nt, S, slice_k) int32; lane l of step t
//      is contraction position gk[t, l].
//
// Steps t < min(counts, S) only.  Positions outside [0, K), rows >= M and
// columns >= N read as zero (masked here, no operand is padded); blocks
// whose count is 0 store zeros.  Products are exact (bf16 x bf16 in the
// tensor cores), sums float32, one cast when the tile is stored.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   * decode (M = 2) and prefill (M = 64) at nemotron-4-340b's widths do
//     2*M flops per weight byte, under the ~295 flop/byte ridge: the bytes
//     of B's scheduled slices bound them (at M = 2: 0.017 ms for a
//     18432 x 1536 projection, 0.81 ms for 18432 x 73728; at M = 64 the
//     same within 1 %);
//   * whisper-base's encoder at M = 6000 rows does 2*6000 flops per weight
//     byte, above the ridge: its flops bound it (6000 x 512 x 2048: 12.6
//     GFLOP, 0.0127 ms).
// What each piece of the design does about that:
//   1. Split schedules.  When the output tiles fill fewer than about two
//      waves of SMs (18432 x 1536 has 12 tiles of 128 columns), each
//      tile's steps [0, min(counts, S)) are cut into `splits` contiguous
//      shares, one CUDA block each; the shares write float32 partials to a
//      workspace (splits, E, M, N) and split_sum_kernel adds them in split
//      order (deterministic, no atomics) and casts.  splits == 1 writes
//      the output directly.  The wrapper chooses splits.
//   2. A ring of kStages stages in shared memory, filled by 16-byte
//      cp.async.cg copies (zero-fill for masked lanes), so that
//      kStages - 1 chunks (48 KB of B per CUDA block at 64 positions a
//      chunk) are in flight while one multiplies.  K1 copies each
//      scheduled B row of the chunk and A's rows (contiguous positions);
//      K2 copies B's gathered rows the same way, one row per 16 threads,
//      and gathers A's single elements (a few rows, resident in L2)
//      through registers, a warp along one row so that neighbouring
//      positions share sectors.  Where N, K or a block edge is not a
//      multiple of 8 elements, the operand goes through registers too.
//      Each chunk's contraction positions are read from the schedule
//      once, a thread a position, into an index ring in shared memory, one
//      chunk ahead; a block first prefetches its share of the schedule
//      into L2, so those reads do not wait on device memory.
//   3. Tensor cores: mma.sync.m16n8k16 bf16 -> f32, fed by ldmatrix
//      (ldmatrix.trans for B's k-major rows) from padded rows that keep
//      the eight addresses of each 8x8 load in distinct banks.  A CUDA
//      block covers 16, 32, 64 or 128 rows (the smallest that holds
//      block_m; 128 at a time beyond) by 128 columns, with 8 warps.
//   4. Few instructions per chunk: at 2 rows a chunk is 16 KB of B and a
//      handful of mma, so the per-chunk work of the threads (addresses,
//      the barrier, the index) and not the tensor cores sets the pace
//      once enough bytes are in flight; so chunks are 64 positions deep
//      (32 at 64 rows, where a 64-deep chunk's fragments would cost the
//      registers of a second resident block).  Measured on the card:
//      loading the register-path values an iteration earlier, or copying
//      the index with cp.async further ahead, added instructions to every
//      chunk and was slower at every served shape.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {
namespace mma {

constexpr int kThreads = 256;                 // 8 warps
constexpr int kCols = 128;                    // columns per CUDA block
constexpr int kStages = 4;                    // ring depth
constexpr int kBLd = kCols + 8;               // B row pitch (elements)

struct Args {
  const uint16_t* a;    // bf16 bits
  const uint16_t* b;
  const int* sched;
  const int* counts;
  void* out;
  float* ws;            // (splits, E, M, N) partials; null when splits == 1
  int out_f32;
  int e, m, n, k, mt, nt, s, block_m, block_n, slice_k, splits;
  int msub, nsub;       // CUDA blocks per tile along rows / columns
  int a_vec, b_vec;     // 16-byte copies possible for A / B
};

// contraction positions a stage (see 4. above)
template <int BM>
__host__ __device__ constexpr int chunk_for() {
  return BM == 64 ? 32 : 64;
}

template <int BM>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * ((BM * (chunk_for<BM>() + 8) + chunk_for<BM>() * kBLd) * 2
                    + chunk_for<BM>() * 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy; bytes = 0 writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 elements at src[off(e)] for e < 8 (a lane reads 0 where ok(e)
// fails), packed as one 16-byte vector
template <typename Ok, typename Off>
__device__ __forceinline__ uint4 gather8(const uint16_t* src, Ok ok,
                                         Off off) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t bits = ok(e) ? static_cast<uint32_t>(__ldg(src + off(e)))
                                : 0u;
    w[e >> 1] |= bits << (16 * (e & 1));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int BM, bool KFUSED>
__global__ void __launch_bounds__(kThreads)
spgemm_mma_kernel(const Args args) {
  constexpr int kChunk = chunk_for<BM>();     // contraction positions a stage
  constexpr int kALd = kChunk + 8;            // A row pitch (elements)
  constexpr int WARPS_M = BM == 16 ? 1 : 2;
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int WM = BM / WARPS_M;            // rows per warp
  constexpr int WN = kCols / WARPS_N;         // columns per warp
  constexpr int MT = WM / 16;                 // m16 tiles per warp
  constexpr int NT = WN / 8;                  // n8 tiles per warp (even)
  constexpr int A_GROUPS = BM * kChunk / 8;   // 8-element groups a stage
  constexpr int B_GROUPS = kChunk * kCols / 8;
  constexpr int A_PT = (A_GROUPS + kThreads - 1) / kThreads;
  constexpr int B_PT = B_GROUPS / kThreads;
  // register path of A: a thread holds positions 2p, 2p + 1 of one row
  constexpr int PAIRS = kChunk / 2;
  constexpr int A_ROWS_PASS = kThreads / PAIRS;
  constexpr int A_PASSES = (BM + A_ROWS_PASS - 1) / A_ROWS_PASS;
  static_assert(NT % 2 == 0 && MT >= 1 && B_GROUPS % kThreads == 0 &&
                kThreads % PAIRS == 0 && BM % A_ROWS_PASS == 0, "tiling");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* As = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* Bs = As + kStages * BM * kALd;
  int* Idx = reinterpret_cast<int*>(Bs + kStages * kChunk * kBLd);

  const int m = args.m, n = args.n, k = args.k, slice_k = args.slice_k;
  long long bid = blockIdx.x;
  const int split = static_cast<int>(bid % args.splits); bid /= args.splits;
  const int nj = static_cast<int>(bid % args.nsub); bid /= args.nsub;
  const int j = static_cast<int>(bid % args.nt); bid /= args.nt;
  const int mi = static_cast<int>(bid % args.msub); bid /= args.msub;
  const int i = static_cast<int>(bid % args.mt); bid /= args.mt;
  const long long p = bid;                    // problem
  const long long tile = (p * args.mt + i) * args.nt + j;

  const int row_lo = i * args.block_m + mi * BM;
  const int row_hi = min(min(i * args.block_m + args.block_m, row_lo + BM), m);
  const int col_lo = j * args.block_n + nj * kCols;
  const int col_hi = min(min(j * args.block_n + args.block_n,
                             col_lo + kCols), n);
  if (row_lo >= row_hi || col_lo >= col_hi) return;   // wholly past an edge

  const uint16_t* a = args.a + p * m * k;
  const uint16_t* b = args.b + p * k * n;
  const int words = KFUSED ? slice_k : 1;     // schedule words a step
  const int* my_sched = args.sched + tile * args.s * words;

  // this split's share of the tile's steps
  const int steps = max(min(args.counts[tile], args.s), 0);
  const int per = (steps + args.splits - 1) / args.splits;
  const int t0 = min(split * per, steps);
  const int t1 = min(t0 + per, steps);
  const int cps = (slice_k + kChunk - 1) / kChunk;   // chunks per step
  const int total = (t1 - t0) * cps;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;

  // the share's schedule words into L2 (128-byte lines), so that the
  // index reads below do not wait on device memory
  {
    const char* lo = reinterpret_cast<const char*>(
        my_sched + static_cast<long long>(t0) * words);
    const long long bytes = static_cast<long long>(t1 - t0) * words * 4;
    for (long long off = static_cast<long long>(tid) * 128; off < bytes;
         off += kThreads * 128)
      asm volatile("prefetch.global.L2 [%0];\n" :: "l"(lo + off));
  }

  // contraction position of lane l of chunk c, or -1 where it reads zero
  auto kindex = [&](int c, int l) -> int {
    const int t = t0 + c / cps;
    const int x = (c % cps) * kChunk + l;
    if (x >= slice_k) return -1;
    const int kx = KFUSED ? my_sched[static_cast<long long>(t) * slice_k + x]
                          : my_sched[t] * slice_k + x;
    return (kx >= 0 && kx < k) ? kx : -1;
  };

  uint4 a_reg[A_PT];          // A, 8 consecutive positions (K1, unaligned)
  uint32_t a_pair[A_PASSES];  // A, 2 gathered positions (K2)
  uint4 b_reg[B_PT];          // B, unaligned columns

  // start chunk c's copies into its ring slot; register-path values are
  // loaded here and stored by stash()
  auto start = [&](int c) {
    const int slot = c % kStages;
    const int* ix = Idx + slot * kChunk;
    if (KFUSED) {
      const int pair = tid % PAIRS;
      const int k0 = ix[2 * pair], k1 = ix[2 * pair + 1];
#pragma unroll
      for (int u = 0; u < A_PASSES; ++u) {
        const int grow = row_lo + u * A_ROWS_PASS + tid / PAIRS;
        const bool live = grow < row_hi;
        const uint16_t* src = a + static_cast<long long>(live ? grow : 0) * k;
        const uint32_t lo = live && k0 >= 0 ? __ldg(src + k0) : 0u;
        const uint32_t hi = live && k1 >= 0 ? __ldg(src + k1) : 0u;
        a_pair[u] = lo | (hi << 16);
      }
    } else {
#pragma unroll
      for (int u = 0; u < A_PT; ++u) {
        const int g = tid + u * kThreads;
        if (g >= A_GROUPS) break;
        const int row = g / (kChunk / 8);
        const int l0 = (g % (kChunk / 8)) * 8;
        const int grow = row_lo + row;
        const bool live = grow < row_hi;
        const uint16_t* src = a + static_cast<long long>(live ? grow : 0) * k;
        if (args.a_vec) {
          const int kx = ix[l0];
          const bool ok = live && kx >= 0;
          cp_async16(As + (slot * BM + row) * kALd + l0, ok ? src + kx : a,
                     ok ? 16 : 0);
        } else {
          a_reg[u] = gather8(src, [&](int e) { return live &&
                                                ix[l0 + e] >= 0; },
                             [&](int e) { return ix[l0 + e]; });
        }
      }
    }
#pragma unroll
    for (int u = 0; u < B_PT; ++u) {
      const int g = tid + u * kThreads;
      const int kr = g / (kCols / 8);
      const int c0 = (g % (kCols / 8)) * 8;
      const int col = col_lo + c0;
      const int kx = ix[kr];
      const uint16_t* src = b + static_cast<long long>(kx >= 0 ? kx : 0) * n
                            + col;
      if (args.b_vec) {
        const bool ok = kx >= 0 && col < col_hi;
        cp_async16(Bs + (slot * kChunk + kr) * kBLd + c0, ok ? src : b,
                   ok ? 16 : 0);
      } else {
        b_reg[u] = gather8(src, [&](int e) { return kx >= 0 &&
                                             col + e < col_hi; },
                           [&](int e) { return e; });
      }
    }
  };

  auto stash = [&](int c) {
    const int slot = c % kStages;
    if (KFUSED) {
#pragma unroll
      for (int u = 0; u < A_PASSES; ++u) {
        const int row = u * A_ROWS_PASS + tid / PAIRS;
        *reinterpret_cast<uint32_t*>(As + (slot * BM + row) * kALd
                                     + 2 * (tid % PAIRS)) = a_pair[u];
      }
    } else if (!args.a_vec) {
#pragma unroll
      for (int u = 0; u < A_PT; ++u) {
        const int g = tid + u * kThreads;
        if (g >= A_GROUPS) break;
        *reinterpret_cast<uint4*>(As + (slot * BM + g / (kChunk / 8)) * kALd
                                  + (g % (kChunk / 8)) * 8) = a_reg[u];
      }
    }
    if (!args.b_vec) {
#pragma unroll
      for (int u = 0; u < B_PT; ++u) {
        const int g = tid + u * kThreads;
        *reinterpret_cast<uint4*>(Bs + (slot * kChunk + g / (kCols / 8)) * kBLd
                                  + (g % (kCols / 8)) * 8) = b_reg[u];
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int x = 0; x < MT; ++x)
#pragma unroll
    for (int y = 0; y < NT; ++y)
#pragma unroll
      for (int z = 0; z < 4; ++z) acc[x][y][z] = 0.f;

  auto compute = [&](int slot) {
    const uint16_t* as = As + slot * BM * kALd;
    const uint16_t* bs = Bs + slot * kChunk * kBLd;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      uint32_t af[MT][4];
      uint32_t bf[NT][2];
#pragma unroll
      for (int x = 0; x < MT; ++x)
        ldmatrix_x4(af[x], as + (wm * WM + x * 16 + (lane & 15)) * kALd + kk
                               + (lane >> 4) * 8);
#pragma unroll
      for (int y = 0; y < NT; y += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + (lane & 15)) * kBLd + wn * WN + y * 8
                                 + (lane >> 4) * 8);
        bf[y][0] = r[0];
        bf[y][1] = r[1];
        bf[y + 1][0] = r[2];
        bf[y + 1][1] = r[3];
      }
#pragma unroll
      for (int x = 0; x < MT; ++x)
#pragma unroll
        for (int y = 0; y < NT; ++y) mma_bf16(acc[x][y], af[x], bf[y][0],
                                              bf[y][1]);
    }
  };

  // chunk q multiplies while chunks q+1 .. q+kStages-1 are in flight
  if (total > 0) {
    if (tid < kChunk) {
#pragma unroll
      for (int c = 0; c < kStages; ++c)
        if (c < total) Idx[c * kChunk + tid] = kindex(c, tid);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < total) {
        start(c);
        stash(c);
      }
      cp_commit();
    }
    for (int q = 0; q < total; ++q) {
      cp_wait<kStages - 2>();          // chunk q has landed (this thread)
      __syncthreads();                 // ... for every thread; slot q-1 free
      const int c = q + kStages - 1;   // the chunk to start now
      if (c < total) start(c);
      const bool fill = tid < kChunk && c + 1 < total;
      const int next = fill ? kindex(c + 1, tid) : -1;
      compute(q % kStages);
      if (c < total) stash(c);
      // chunk c + 1's index slot is chunk q's, whose copies began long ago
      if (fill) Idx[((c + 1) % kStages) * kChunk + tid] = next;
      cp_commit();
    }
    cp_wait<0>();
  }

  // store: fragment (x, y) holds rows g, g + 8 and columns 2*t4, 2*t4 + 1
  const int g8 = lane >> 2, t4 = lane & 3;
  const long long plane = static_cast<long long>(args.e) * m * n;
#pragma unroll
  for (int x = 0; x < MT; ++x)
#pragma unroll
    for (int y = 0; y < NT; ++y)
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        const int row = row_lo + wm * WM + x * 16 + g8 + (z >> 1) * 8;
        const int col = col_lo + wn * WN + y * 8 + t4 * 2 + (z & 1);
        if (row >= row_hi || col >= col_hi) continue;
        const long long idx = (p * m + row) * static_cast<long long>(n) + col;
        if (args.splits > 1) args.ws[split * plane + idx] = acc[x][y][z];
        else if (args.out_f32)
          static_cast<float*>(args.out)[idx] = acc[x][y][z];
        else static_cast<__nv_bfloat16*>(args.out)[idx] =
            __float2bfloat16(acc[x][y][z]);
      }
}

// out[i] = sum over s in order of ws[s, i], cast once
__global__ void __launch_bounds__(kThreads)
split_sum_kernel(const float* __restrict__ ws, void* __restrict__ out,
                 int out_f32, long long count, int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       i < count; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v += ws[s * count + i];
    if (out_f32) static_cast<float*>(out)[i] = v;
    else static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  }
}

template <int BM, bool KFUSED>
static int launch_bm(Args args, cudaStream_t stream) {
  args.msub = (args.block_m + BM - 1) / BM;
  args.nsub = (args.block_n + kCols - 1) / kCols;
  const long long blocks = static_cast<long long>(args.e) * args.mt *
                           args.msub * args.nt * args.nsub * args.splits;
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  constexpr int smem = smem_bytes<BM>();
  cudaError_t err = cudaFuncSetAttribute(
      spgemm_mma_kernel<BM, KFUSED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  spgemm_mma_kernel<BM, KFUSED><<<static_cast<unsigned>(blocks), kThreads,
                                  smem, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || args.splits == 1) return static_cast<int>(err);
  const long long count = static_cast<long long>(args.e) * args.m * args.n;
  const long long want = (count + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(want < 8192 ? want : 8192);
  split_sum_kernel<<<grid, kThreads, 0, stream>>>(args.ws, args.out,
                                                  args.out_f32, count,
                                                  args.splits);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 A and B (dtype_code 1 at the C entries).  splits >= 1 shares
// of every tile's steps; ws holds splits * e * m * n floats when
// splits > 1.  Returns the cudaError_t of the launches (0 on success); an
// empty output launches nothing and succeeds.
template <bool KFUSED>
static int launch_mma(int out_f32, const void* a, const void* b,
                      const void* sched, const void* counts, void* out,
                      void* ws, int e, int m, int n, int k, int mt, int nt,
                      int s, int block_m, int block_n, int slice_k,
                      int splits, void* stream_ptr) {
  if (block_m <= 0 || block_n <= 0 || slice_k <= 0 || e < 0 || m < 0 ||
      n < 0 || k < 0 || mt < 0 || nt < 0 || s < 0 || splits < 1 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0 || m == 0 || n == 0 || mt == 0 || nt == 0)
    return static_cast<int>(cudaSuccess);
  Args args{};
  args.a = static_cast<const uint16_t*>(a);
  args.b = static_cast<const uint16_t*>(b);
  args.sched = static_cast<const int*>(sched);
  args.counts = static_cast<const int*>(counts);
  args.out = out;
  args.ws = static_cast<float*>(ws);
  args.out_f32 = out_f32;
  args.e = e; args.m = m; args.n = n; args.k = k;
  args.mt = mt; args.nt = nt; args.s = s;
  args.block_m = block_m; args.block_n = block_n; args.slice_k = slice_k;
  args.splits = splits;
  // K1's A rows are contiguous positions in whole groups of 8 when K and
  // slice_k are; K2 gathers A's positions one by one.  B's rows are
  // copied 8 columns at a time when N and the column blocks allow it.
  args.a_vec = !KFUSED && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
               k % 8 == 0 && slice_k % 8 == 0;
  args.b_vec = reinterpret_cast<uintptr_t>(b) % 16 == 0 && n % 8 == 0 &&
               block_n % 8 == 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (block_m <= 16) return launch_bm<16, KFUSED>(args, stream);
  if (block_m <= 32) return launch_bm<32, KFUSED>(args, stream);
  if (block_m <= 64) return launch_bm<64, KFUSED>(args, stream);
  return launch_bm<128, KFUSED>(args, stream);
}

}  // namespace mma
}  // namespace repro
