// K6 and K6 halo with bf16 vectors for Hopper (sm_90a): the packed SpMV of
// csrc/packed_common.cuh instantiated for bf16 x on an f32 or bf16 band,
// in its own translation unit so that the f32 / f64 library build
// (csrc/packed.cu) does not grow with it.  The C entries pd_packed_matvec
// and pd_packed_matvec_halo forward bf16 vectors here.
//
// Replaces the bf16-x instantiation of the TPU Pallas kernel
//   polydeal_tpu/ops/packed.py  _packed_matvec_impl (and, on a shard's
//   slab, packed_matvec_t_halo), which keeps bf16 x (packed.py:294, :333)
//   and accumulates in f32 (acc_t, :209).
//
// Each x value is widened to f32 as it is loaded, every product and sum
// runs in f32, and y is rounded to bf16 once (round to nearest even).  What
// bounds it: memory, as the f32 kernel; bf16 x halves only x's bytes
// (4.2 MB -> 2.1 MB against the 130 MB pack at the flagship's fine level),
// so the bound barely moves.

#include "packed_common.cuh"

int packed_matvec_bf16(const void* data, int data_dt, const void* x,
                       const int* oid, const int* offsets, int n_off, int K,
                       int nb, int R_pad, int64_t P, int64_t ldx,
                       int64_t halo, void* y, cudaStream_t s) {
  if (n_off > kMaxOffsets) return -2;
  if (data_dt == F32) {
    return launch_matvec<float, __nv_bfloat16>(data, x, oid, offsets, n_off,
                                               K, nb, R_pad, P, ldx, halo, y,
                                               s);
  }
  if (data_dt == BF16) {
    return launch_matvec<__nv_bfloat16, __nv_bfloat16>(
        data, x, oid, offsets, n_off, K, nb, R_pad, P, ldx, halo, y, s);
  }
  return -1;
}
