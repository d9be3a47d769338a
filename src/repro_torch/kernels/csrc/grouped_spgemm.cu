// K3: ragged grouped dual-side sparse GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/grouped_spgemm.py::grouped_spgemm_planned
// (_grouped_kernel) of the JAX package: C[e] = A[e] @ B[e] for E stacked
// problems, block (e, i, j) walking its front-packed active k-slices
// ks[e, i, j, :counts[e, i, j]].  A problem with no occupied rows (an
// empty expert, an unwritten stretch of a KV cache) has counts == 0 blocks
// that load nothing and store zeros.  The TPU ran one (E, Mt, Nt, S) grid
// with S sequential; here E, Mt and Nt fold into one parallel grid and S is
// the loop inside each block.  See spgemm_tile.cuh for the tiling and what
// bounds it.
#include "spgemm_tile.cuh"

extern "C" int repro_grouped_spgemm(int dtype_code, int out_f32,
                                    const void* a, const void* b,
                                    const void* ks, const void* counts,
                                    void* out, int e, int m, int n, int k,
                                    int mt, int nt, int s, int block_m,
                                    int block_n, int slice_k, void* stream) {
  return repro::launch_spgemm<false>(dtype_code, out_f32, a, b, ks, counts,
                                     out, e, m, n, k, mt, nt, s, block_m,
                                     block_n, slice_k, stream);
}
