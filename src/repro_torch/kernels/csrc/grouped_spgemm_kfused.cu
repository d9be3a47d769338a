// K4: grouped element-granular K-condensed dual-side sparse GEMM for
// Hopper (sm_90a).
//
// Replaces the TPU kernel
// kernels/grouped_spgemm.py::grouped_spgemm_kfused_planned
// (_grouped_kfused_kernel) of the JAX package: K2 per problem, step t of
// block (e, i, j) gathering the slice_k contraction positions
// gk[e, i, j, t, :] from A[e]'s columns and B[e]'s rows in device memory
// (the TPU held each problem's full-K panels in VMEM).  Lanes in
// [K, S*slice_k) read zero; counts == 0 blocks store zeros.  Routes as in
// K3 (grouped_spgemm.cu); the narrow-N kernel gathers A's elements one by
// one and B's from its shared copy, the mixed kernel one position a
// thread.
#include "spgemm_entry.cuh"

// words: the 20 launch words of spgemm_entry.cuh
extern "C" int repro_grouped_spgemm_kfused(const long long* words) {
  return repro::launch_entry<true, true>(words);
}
