// K2: element-granular K-condensed dual-side sparse GEMM for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// kernels/bitmap_spgemm.py::bitmap_spgemm_kfused_planned
// (_spgemm_kfused_kernel) of the JAX package.  Step t of block (i, j)
// gathers the slice_k contraction positions gk[i, j, t, :] straight from
// A's columns and B's rows in device memory (the TPU kept full-K panels
// resident in VMEM; a 128-row bf16 panel at nemotron's d_ff is 18.9 MB,
// far past an SM's shared memory).  Lanes in [K, S*slice_k) read zero.
// bfloat16 operands run on the tensor-core kernel of spgemm_mma.cuh (B's
// gathered rows by cp.async, split schedules as in K1); float32 operands
// on the SIMT kernel of spgemm_tile.cuh with splits == 1.  Takes e = 1.
#include "spgemm_mma.cuh"
#include "spgemm_tile.cuh"

extern "C" int repro_bitmap_spgemm_kfused(int dtype_code, int out_f32,
                                          const void* a, const void* b,
                                          const void* gk, const void* counts,
                                          void* out, void* ws, int e, int m,
                                          int n, int k, int mt, int nt,
                                          int s, int block_m, int block_n,
                                          int slice_k, int splits,
                                          void* stream) {
  if (dtype_code == 1)
    return repro::mma::launch_mma<true>(out_f32, a, b, gk, counts, out, ws,
                                        e, m, n, k, mt, nt, s, block_m,
                                        block_n, slice_k, splits, stream);
  if (dtype_code != 0 || splits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro::launch_spgemm<true>(dtype_code, out_f32, a, b, gk, counts,
                                    out, e, m, n, k, mt, nt, s, block_m,
                                    block_n, slice_k, stream);
}
