// K3: ragged grouped dual-side sparse GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/grouped_spgemm.py::grouped_spgemm_planned
// (_grouped_kernel) of the JAX package: C[e] = A[e] @ B[e] for E stacked
// problems, block (e, i, j) walking its front-packed active k-slices
// ks[e, i, j, :counts[e, i, j]].  A problem with no occupied rows (an
// empty expert, an unwritten stretch of a KV cache) has counts == 0 blocks
// that load nothing and store zeros.  The TPU ran one (E, Mt, Nt, S) grid
// with S sequential; here E, Mt and Nt fold into one parallel grid and S is
// the loop inside each block.  The wrapper's route picks the kernel (see
// spgemm_entry.cuh): bfloat16 on the tensor cores, in
// the narrow-N layout for the decode score (N <= 16) and else in K1's
// 128-column one with split schedules (partials in ws, summed in split
// order); float32 A with bfloat16 B (the decode value, V as stored) on the
// mixed SIMT kernel; float32 on the SIMT tile kernel.
#include "spgemm_entry.cuh"

// words: the 20 launch words of spgemm_entry.cuh
extern "C" int repro_grouped_spgemm(const long long* words) {
  return repro::launch_entry<false, true>(words);
}
