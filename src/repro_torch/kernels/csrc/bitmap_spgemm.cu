// K1: slice-granular dual-side sparse GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/bitmap_spgemm.py::bitmap_spgemm_planned
// (_spgemm_kernel) of the JAX package.  Block (i, j) walks its
// front-packed active k-slices ks[i, j, :counts[i, j]]; see spgemm_tile.cuh
// for the tiling, the edge masking and what bounds it.  Takes e = 1.
#include "spgemm_tile.cuh"

extern "C" int repro_bitmap_spgemm(int dtype_code, int out_f32,
                                   const void* a, const void* b,
                                   const void* ks, const void* counts,
                                   void* out, int e, int m, int n, int k,
                                   int mt, int nt, int s, int block_m,
                                   int block_n, int slice_k, void* stream) {
  return repro::launch_spgemm<false>(dtype_code, out_f32, a, b, ks, counts,
                                     out, e, m, n, k, mt, nt, s, block_m,
                                     block_n, slice_k, stream);
}
