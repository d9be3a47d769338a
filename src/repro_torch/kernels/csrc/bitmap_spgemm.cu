// K1: slice-granular dual-side sparse GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/bitmap_spgemm.py::bitmap_spgemm_planned
// (_spgemm_kernel) of the JAX package.  Block (i, j) walks its
// front-packed active k-slices ks[i, j, :counts[i, j]].  bfloat16 operands
// run on the tensor-core kernel of spgemm_mma.cuh, each tile's steps split
// over `splits` CUDA blocks (partials in ws, summed in split order);
// float32 operands on the SIMT kernel of spgemm_tile.cuh, exact against a
// float32 walk, with splits == 1.  Takes e = 1.
#include "spgemm_entry.cuh"

// words: the 20 launch words of spgemm_entry.cuh
extern "C" int repro_bitmap_spgemm(const long long* words) {
  return repro::launch_entry<false, false>(words);
}
