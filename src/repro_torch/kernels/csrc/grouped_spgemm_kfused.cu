// K4: grouped element-granular K-condensed dual-side sparse GEMM for
// Hopper (sm_90a).
//
// Replaces the TPU kernel
// kernels/grouped_spgemm.py::grouped_spgemm_kfused_planned
// (_grouped_kfused_kernel) of the JAX package: K2 per problem, step t of
// block (e, i, j) gathering the slice_k contraction positions
// gk[e, i, j, t, :] from A[e]'s columns and B[e]'s rows in device memory
// (the TPU held each problem's full-K panels in VMEM).  Lanes in
// [K, S*slice_k) read zero; counts == 0 blocks store zeros.  See
// spgemm_tile.cuh for the tiling and what bounds it.
#include "spgemm_tile.cuh"

extern "C" int repro_grouped_spgemm_kfused(int dtype_code, int out_f32,
                                           const void* a, const void* b,
                                           const void* gk, const void* counts,
                                           void* out, int e, int m, int n,
                                           int k, int mt, int nt, int s,
                                           int block_m, int block_n,
                                           int slice_k, void* stream) {
  return repro::launch_spgemm<true>(dtype_code, out_f32, a, b, gk, counts,
                                    out, e, m, n, k, mt, nt, s, block_m,
                                    block_n, slice_k, stream);
}
