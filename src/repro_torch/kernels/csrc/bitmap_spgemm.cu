// K1: slice-granular dual-side sparse GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/bitmap_spgemm.py::bitmap_spgemm_planned
// (_spgemm_kernel) of the JAX package.  Block (i, j) walks its
// front-packed active k-slices ks[i, j, :counts[i, j]].  bfloat16 operands
// run on the tensor-core kernel of spgemm_mma.cuh, each tile's steps split
// over `splits` CUDA blocks (partials in ws, summed in split order);
// float32 operands on the SIMT kernel of spgemm_tile.cuh, exact against a
// float32 walk, with splits == 1.  Takes e = 1.
#include "spgemm_mma.cuh"
#include "spgemm_tile.cuh"

extern "C" int repro_bitmap_spgemm(int dtype_code, int out_f32,
                                   const void* a, const void* b,
                                   const void* ks, const void* counts,
                                   void* out, void* ws, int e, int m, int n,
                                   int k, int mt, int nt, int s, int block_m,
                                   int block_n, int slice_k, int splits,
                                   void* stream) {
  if (dtype_code == 1)
    return repro::mma::launch_mma<false>(out_f32, a, b, ks, counts, out, ws,
                                         e, m, n, k, mt, nt, s, block_m,
                                         block_n, slice_k, splits, stream);
  if (dtype_code != 0 || splits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro::launch_spgemm<false>(dtype_code, out_f32, a, b, ks, counts,
                                     out, e, m, n, k, mt, nt, s, block_m,
                                     block_n, slice_k, stream);
}
