// SIMT tile kernel of the dual-side sparse GEMMs with float32 operands:
// K1/K2 and the grouped K3/K4 (bfloat16 runs on the tensor cores,
// spgemm_mma.cuh and spgemm_grouped.cuh; K3/K4's float32 x bfloat16 value
// product on spgemm_grouped.cuh's mixed kernel).
//
// C[e] = A[e] @ B[e] for E stacked problems (E = 1 for K1/K2), A (E, M, K)
// and B (E, K, N) row-major float32, with each output tiled
// into (block_m x block_n) blocks and a per-block schedule:
//
//   K1/K3 (KFUSED = false): ks (E, Mt, Nt, S) int32, front-packed active
//      k-slice indices; step t of block (e, i, j) covers contraction
//      positions [ks[e,i,j,t] * slice_k, ks[e,i,j,t] * slice_k + slice_k).
//   K2/K4 (KFUSED = true):  gk (E, Mt, Nt, S, slice_k) int32 gather maps;
//      lane l of step t is contraction position gk[e,i,j,t,l].
//
// The problem index is folded into the 1-D grid; each problem's operands,
// schedule and output sit at fixed strides, so a grouped product is the
// same tile loop as a single one.
//
// Both walk t < min(counts[i, j], S) only.  Contraction positions outside
// [0, K) (K1's partial last slice, K2's tail lanes in [K, S*slice_k)) read
// as zero, as do rows >= M and columns >= N: the edges are masked here, no
// operand is padded.  Every block stores its whole tile, so blocks whose
// count is 0 write zeros.
//
// Design: one CUDA block of 256 threads owns an output tile; a tile wider
// than 128 columns, or taller than 128 rows, is split over several blocks,
// each walking the tile's whole schedule.  The contraction is staged
// through shared memory 32 positions at a time as float; the next chunk's
// global loads are started into registers before the current chunk is
// multiplied, so they overlap.  Each warp owns TM rows and each lane 4
// columns; products accumulate in float32 registers (SIMT FMA) and are
// cast once on store.  B rows are read with 16-byte vector loads where
// alignment allows.
//
// Why float32 K1/K2 stay here: float32 FMA of float32 inputs matches the
// plain float32 walk to 1e-5 of its largest output (only the order of the
// sums differs), which TF32 tensor cores, keeping about three decimal
// digits of each input, would not.  The card's references (the smoke
// models on the card against the CPU, tests/test_torch_cuda.py) rely on
// that.  Bounds: float32 math peaks near 67 TFLOP/s; at 2 or 64 rows the
// bytes of B's scheduled slices bound it, but one block per tile walking
// its whole schedule leaves SMs idle when tiles are few.
//
// At the attention decode sites (K3/K4 with E = batch x KV heads) the
// score product K[e] (T, hd) @ q[e] (hd, G) reads only the cache-key rows
// of scheduled slot blocks, and the value product p[e] (G, T) @ V[e]
// (T, hd) only V's scheduled slot slices; both do about 2*G flops per byte
// read, so bytes bound them too.  An unscheduled tile loads nothing and
// only stores its zeros (the score output is written whole, as the TPU
// kernel flushes it).  In float32 both run here; the served types take
// spgemm_grouped.cuh's narrow-N score (G = 12 columns, which would leave
// most lanes of a 128-column block idle) and its mixed value kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;      // 8 warps
constexpr int kCols = 128;         // columns per CUDA block: 32 lanes x 4
constexpr int kChunk = 32;         // contraction positions per smem stage

// Element storage: raw bits, so that one code path serves both types.
template <int EB> struct Raw;
template <> struct Raw<4> { using T = uint32_t; };
template <> struct Raw<2> { using T = uint16_t; };

template <int EB>
__device__ __forceinline__ float bits_to_float(uint32_t bits) {
  return EB == 4 ? __uint_as_float(bits) : __uint_as_float(bits << 16);
}

// Element e (0 <= e < 16 / EB) of a 16-byte vector as float.
template <int EB>
__device__ __forceinline__ float vec_elem(const uint4& v, int e) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if (EB == 4) return __uint_as_float(w[e]);
  const uint32_t word = w[e >> 1];
  return (e & 1) ? __uint_as_float(word & 0xffff0000u)
                 : __uint_as_float(word << 16);
}

template <int EB, int TM, bool KFUSED>
__global__ void __launch_bounds__(kThreads)
spgemm_tile_kernel(const void* __restrict__ a_ptr,
                   const void* __restrict__ b_ptr,
                   const int* __restrict__ sched,
                   const int* __restrict__ counts,
                   void* __restrict__ out, int out_f32,
                   int m, int n, int k, int mt, int nt, int s,
                   int block_m, int block_n, int slice_k,
                   int msub, int nsub, int vec_ok) {
  using R = typename Raw<EB>::T;
  constexpr int RB = 8 * TM;                 // rows per CUDA block
  constexpr int A_PER_THREAD = RB * kChunk / kThreads;   // == TM
  constexpr int VEC = 16 / EB;               // elements per 16-byte load
  constexpr int GROUPS_PER_ROW = kCols / VEC;
  constexpr int B_GROUPS = kChunk * GROUPS_PER_ROW / kThreads;

  __shared__ float As[kChunk][RB + 1];       // +1: no bank conflicts
  __shared__ __align__(16) float Bs[kChunk][kCols];

  long long bid = blockIdx.x;
  const int nj = static_cast<int>(bid % nsub); bid /= nsub;
  const int j = static_cast<int>(bid % nt); bid /= nt;
  const int mi = static_cast<int>(bid % msub); bid /= msub;
  const int i = static_cast<int>(bid % mt); bid /= mt;
  const long long p = bid;                   // problem
  // tiles are numbered across problems, as the schedule is laid out
  const long long tile = (p * mt + i) * nt + j;

  const R* a = static_cast<const R*>(a_ptr) + p * m * k;
  const R* b = static_cast<const R*>(b_ptr) + p * k * n;
  const long long out_base = p * m * n;

  const int row_lo = i * block_m + mi * RB;
  const int row_hi = min(min(i * block_m + block_m, row_lo + RB), m);
  const int col_lo = j * block_n + nj * kCols;
  const int col_hi = min(min(j * block_n + block_n, col_lo + kCols), n);
  if (row_lo >= row_hi || col_lo >= col_hi) return;   // wholly past an edge

  const int tid = threadIdx.x;
  const int rg = tid / 32;                   // warp → rows rg*TM ..
  const int cg = tid % 32;                   // lane → cols cg*4 ..

  float acc[TM][4];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  const int steps = min(counts[tile], s);
  const int chunks_per_step = (slice_k + kChunk - 1) / kChunk;
  const int total = steps * chunks_per_step;
  const int* my_sched = sched + tile * s * (KFUSED ? slice_k : 1);

  // contraction index of lane kk of chunk q, or -1 where it reads zero
  auto kindex = [&](int q, int kk) -> int {
    const int t = q / chunks_per_step;
    const int lane = (q % chunks_per_step) * kChunk + kk;
    if (lane >= slice_k) return -1;
    const int kx = KFUSED ? my_sched[static_cast<long long>(t) * slice_k + lane]
                          : my_sched[t] * slice_k + lane;
    return (kx >= 0 && kx < k) ? kx : -1;
  };

  float a_reg[A_PER_THREAD];
  uint4 b_reg[B_GROUPS];

  auto load = [&](int q) {
#pragma unroll
    for (int p = 0; p < A_PER_THREAD; ++p) {
      const int e = tid + p * kThreads;
      const int row = row_lo + e / kChunk;
      const int kx = kindex(q, e % kChunk);
      a_reg[p] = (row < row_hi && kx >= 0)
          ? bits_to_float<EB>(a[static_cast<long long>(row) * k + kx]) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < B_GROUPS; ++p) {
      const int g = tid + p * kThreads;
      const int col = col_lo + (g % GROUPS_PER_ROW) * VEC;
      const int kx = kindex(q, g / GROUPS_PER_ROW);
      const R* src = b + (kx >= 0 ? static_cast<long long>(kx) * n + col : 0);
      if (kx >= 0 && vec_ok && col + VEC <= col_hi) {
        b_reg[p] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const uint32_t bits = (kx >= 0 && col + e < col_hi)
              ? static_cast<uint32_t>(src[e]) : 0u;
          if (EB == 4) w[e] = bits;
          else w[e >> 1] |= bits << (16 * (e & 1));
        }
        b_reg[p] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  auto stash = [&]() {
#pragma unroll
    for (int p = 0; p < A_PER_THREAD; ++p) {
      const int e = tid + p * kThreads;
      As[e % kChunk][e / kChunk] = a_reg[p];
    }
#pragma unroll
    for (int p = 0; p < B_GROUPS; ++p) {
      const int g = tid + p * kThreads;
      const int kk = g / GROUPS_PER_ROW;
      const int c = (g % GROUPS_PER_ROW) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) Bs[kk][c + e] = vec_elem<EB>(b_reg[p], e);
    }
  };

  auto compute = [&]() {
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      float av[TM];
#pragma unroll
      for (int u = 0; u < TM; ++u) av[u] = As[kk][rg * TM + u];
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][cg * 4]);
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        acc[u][0] = fmaf(av[u], bv.x, acc[u][0]);
        acc[u][1] = fmaf(av[u], bv.y, acc[u][1]);
        acc[u][2] = fmaf(av[u], bv.z, acc[u][2]);
        acc[u][3] = fmaf(av[u], bv.w, acc[u][3]);
      }
    }
  };

  if (total > 0) {
    load(0);
    for (int q = 0; q < total; ++q) {
      __syncthreads();                 // last chunk's readers are done
      stash();
      __syncthreads();
      if (q + 1 < total) load(q + 1);  // in flight while this chunk runs
      compute();
    }
  }

#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int row = row_lo + rg * TM + u;
    if (row >= row_hi) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int col = col_lo + cg * 4 + v;
      if (col >= col_hi) continue;
      const long long idx = out_base + static_cast<long long>(row) * n + col;
      if (out_f32) static_cast<float*>(out)[idx] = acc[u][v];
      else static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16(acc[u][v]);
    }
  }
}

template <int EB, int TM, bool KFUSED>
static void launch_tm(dim3 grid, cudaStream_t stream, const void* a,
                      const void* b, const int* sched, const int* counts,
                      void* out, int out_f32, int m, int n, int k, int mt,
                      int nt, int s, int block_m, int block_n, int slice_k,
                      int msub, int nsub, int vec_ok) {
  spgemm_tile_kernel<EB, TM, KFUSED><<<grid, kThreads, 0, stream>>>(
      a, b, sched, counts, out, out_f32, m, n, k, mt, nt, s, block_m,
      block_n, slice_k, msub, nsub, vec_ok);
}

// float32 A and B; e problems (1 for K1/K2).  Returns the cudaError_t of
// the launch (0 on success); an empty grid launches nothing and succeeds.
// (The kernel is written for 2-byte elements too, which no route uses.)
template <bool KFUSED>
static int launch_spgemm(int out_f32, const void* a, const void* b,
                         const void* sched, const void* counts, void* out,
                         int e, int m, int n, int k, int mt, int nt, int s,
                         int block_m, int block_n, int slice_k,
                         void* stream_ptr) {
  if (block_m <= 0 || block_n <= 0 || slice_k <= 0 || e < 0 || m < 0 ||
      n < 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tm = block_m <= 8 ? 1 : block_m <= 16 ? 2 : block_m <= 32 ? 4
               : block_m <= 64 ? 8 : 16;
  const int msub = (block_m + 8 * tm - 1) / (8 * tm);
  const int nsub = (block_n + kCols - 1) / kCols;
  const long long blocks =
      static_cast<long long>(e) * mt * msub * nt * nsub;
  if (blocks == 0 || m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int vec = 4;
  // problem p's B starts p*k*n elements in: still 16-byte aligned when n
  // is a multiple of the vector
  const int vec_ok = (reinterpret_cast<uintptr_t>(b) % 16 == 0) &&
                     (n % vec == 0) && (block_n % vec == 0);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int* sc = static_cast<const int*>(sched);
  const int* cn = static_cast<const int*>(counts);
#define REPRO_LAUNCH(EB, TM)                                                 \
  launch_tm<EB, TM, KFUSED>(grid, stream, a, b, sc, cn, out, out_f32, m, n,  \
                            k, mt, nt, s, block_m, block_n, slice_k, msub,   \
                            nsub, vec_ok)
#define REPRO_BY_TM(EB)                    \
  switch (tm) {                            \
    case 1: REPRO_LAUNCH(EB, 1); break;    \
    case 2: REPRO_LAUNCH(EB, 2); break;    \
    case 4: REPRO_LAUNCH(EB, 4); break;    \
    case 8: REPRO_LAUNCH(EB, 8); break;    \
    default: REPRO_LAUNCH(EB, 16); break;  \
  }
  REPRO_BY_TM(4)
#undef REPRO_BY_TM
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
