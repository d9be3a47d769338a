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
#include "spgemm_entry.cuh"

// words: the 20 launch words of spgemm_entry.cuh
extern "C" int repro_bitmap_spgemm_kfused(const long long* words) {
  return repro::launch_entry<true, false>(words);
}
