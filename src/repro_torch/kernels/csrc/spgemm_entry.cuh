// The C entries of K1-K4 (bitmap_spgemm{,_kfused}.cu,
// grouped_spgemm{,_kfused}.cu): one argument, an array of 20 64-bit words,
//
//   route, out_f32, a, b, sched, counts, out, ws, e, m, n, k, mt, nt, s,
//   block_m, block_n, slice_k, splits, stream
//
// so that the wrapper's ctypes call converts one pointer, not twenty
// arguments (at the decode attention's microsecond kernels the host's time
// per call is most of a call).  route picks the kernel (the wrapper's rule,
// kernels/bitmap_spgemm.py::route): 0 float32 A and B on the SIMT kernel
// (spgemm_tile.cuh, splits == 1); 1 bfloat16 on the tensor-core kernel
// (spgemm_mma.cuh, 128 columns, each tile's steps split `splits` ways,
// partials in ws); K3/K4 only: 2 bfloat16 with N <= 16 on the narrow-N
// kernel, 3 float32 A x bfloat16 B on the mixed kernel
// (spgemm_grouped.cuh).  Returns the cudaError_t of the launches (0 on
// success); an empty output launches nothing and succeeds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "spgemm_grouped.cuh"
#include "spgemm_mma.cuh"
#include "spgemm_tile.cuh"

namespace repro {

template <bool KFUSED, bool GROUPED>
static int launch_entry(const long long* w) {
  auto ptr = [&](int i) {
    return reinterpret_cast<void*>(static_cast<uintptr_t>(w[i]));
  };
  auto num = [&](int i) { return static_cast<int>(w[i]); };
  const int route = num(0), out_f32 = num(1);
  const void* a = ptr(2);
  const void* b = ptr(3);
  const void* sched = ptr(4);
  const void* counts = ptr(5);
  void* out = ptr(6);
  void* ws = ptr(7);
  const int e = num(8), m = num(9), n = num(10), k = num(11), mt = num(12),
            nt = num(13), s = num(14), block_m = num(15), block_n = num(16),
            slice_k = num(17), splits = num(18);
  void* stream = ptr(19);
  if (route == 1)
    return mma::launch_mma<KFUSED>(out_f32, a, b, sched, counts, out, ws, e,
                                   m, n, k, mt, nt, s, block_m, block_n,
                                   slice_k, splits, stream);
  if (route == 0 && splits == 1)
    return launch_spgemm<KFUSED>(out_f32, a, b, sched, counts, out, e, m, n,
                                 k, mt, nt, s, block_m, block_n, slice_k,
                                 stream);
  if constexpr (GROUPED) {
    if ((route == 2 || route == 3) && splits == 1 && block_m > 0 &&
        block_n > 0 && slice_k > 0 && e >= 0 && m >= 0 && n >= 0 && k >= 0 &&
        mt >= 0 && nt >= 0 && s >= 0) {
      if (e == 0 || m == 0 || n == 0 || mt == 0 || nt == 0)
        return static_cast<int>(cudaSuccess);
      cudaStream_t st = static_cast<cudaStream_t>(stream);
      if (route == 2)
        return grouped::launch_narrow<KFUSED>(out_f32, a, b, sched, counts,
                                              out, e, m, n, k, mt, nt, s,
                                              block_m, block_n, slice_k, st);
      return grouped::launch_mixed<KFUSED>(out_f32, a, b, sched, counts, out,
                                           e, m, n, k, mt, nt, s, block_m,
                                           block_n, slice_k, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro
