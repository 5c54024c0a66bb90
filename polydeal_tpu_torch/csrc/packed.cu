// Packed block SpMV (K6) and the fused Chebyshev step / residual on it (K7)
// for Hopper (sm_90a), over the packed layout of BlockPacked.data_i / oid:
// the C entries and their f32 / f64 instantiations.  The kernels, the
// layout and the design note are in csrc/packed_common.cuh; K6 with bf16
// vectors is built in csrc/packed_bf16.cu, and the entries here forward
// bf16 x to it.
//
// Replaces the TPU Pallas kernels
//   K6  polydeal_tpu/ops/packed.py      _packed_matvec_impl
//   K7  polydeal_tpu/ops/fused_cheb.py  _packed_fused_impl
// and, through the halo entries (pd_packed_matvec_halo,
// pd_packed_fused_halo), the sharded entry points
//   polydeal_tpu/ops/packed.py      packed_matvec_t_halo
//   polydeal_tpu/ops/fused_cheb.py  packed_cheb_step_t_halo,
//                                   packed_residual_t_halo
// on one shard's lane slab: x is x_ext [nb, ldx = P + 2 T] with the
// neighbouring shards' T lanes on each side (every plan offset |o| <= T),
// lane p reads column T + p + off and the update's own x at T + p.  x's row
// stride ldx and the halo width are runtime arguments (the unsharded
// entries pass ldx = P, halo = 0).  A far block-COO tail is not in the
// kernel's product: the caller folds it into b (b_eff = b - A_far x).
//
// Types: band f32 or f64 with f32 or f64 vectors (f64 vectors with either
// band), accumulating in the vector type; K6 (and K6 halo) also takes bf16
// vectors with an f32 or bf16 band.  K7 takes no bf16.
//
// Plain C interface for ctypes (built by polydeal_tpu_torch/ops/_build.py):
// each entry point launches on the given stream and returns
// cudaGetLastError() (0 on success), -1 for an unsupported dtype pair, or
// -2 when the offset table does not fit the default shared memory.

#include "packed_common.cuh"

// Calls F<TD, TV>(args...) for the supported (band, vector) dtype pairs.
#define PD_PACKED_DISPATCH(F, n_off, data_dt, vec_dt, ...)          \
  if (n_off > kMaxOffsets) return -2;                               \
  if (vec_dt == F32) {                                              \
    if (data_dt == F32) return F<float, float>(__VA_ARGS__);        \
  } else if (vec_dt == F64) {                                       \
    if (data_dt == F64) return F<double, double>(__VA_ARGS__);      \
    if (data_dt == F32) return F<float, double>(__VA_ARGS__);       \
  }                                                                 \
  return -1

extern "C" int pd_packed_matvec(const void* data, int data_dt, const void* x,
                                int vec_dt, const int* oid,
                                const int* offsets, int n_off, int K, int nb,
                                int R_pad, long long P, void* y,
                                void* stream) {
  if (vec_dt == BF16) {
    return packed_matvec_bf16(data, data_dt, x, oid, offsets, n_off, K, nb,
                              R_pad, static_cast<int64_t>(P),
                              static_cast<int64_t>(P), 0, y,
                              static_cast<cudaStream_t>(stream));
  }
  PD_PACKED_DISPATCH(launch_matvec, n_off, data_dt, vec_dt, data, x, oid,
                     offsets, n_off, K, nb, R_pad, static_cast<int64_t>(P),
                     static_cast<int64_t>(P), 0, y,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int pd_packed_fused(const void* data, int data_dt, const void* x,
                               int vec_dt, const int* oid, const int* offsets,
                               int n_off, int K, int nb, int R_pad,
                               long long P, const void* b, const void* d,
                               const void* dinv, double c1, double c2,
                               int mode, void* out0, void* out1,
                               void* stream) {
  PD_PACKED_DISPATCH(launch_fused, n_off, data_dt, vec_dt, data, x, oid,
                     offsets, n_off, K, nb, R_pad, static_cast<int64_t>(P),
                     static_cast<int64_t>(P), 0, b, d, dinv, c1, c2, mode,
                     out0, out1, static_cast<cudaStream_t>(stream));
}

// The halo entries: K6 and K7 on a shard's slab, x_ext [nb, ldx] with
// ldx = P + 2 halo.
extern "C" int pd_packed_matvec_halo(const void* data, int data_dt,
                                     const void* x, int vec_dt,
                                     const int* oid, const int* offsets,
                                     int n_off, int K, int nb, int R_pad,
                                     long long P, long long ldx,
                                     long long halo, void* y, void* stream) {
  if (vec_dt == BF16) {
    return packed_matvec_bf16(data, data_dt, x, oid, offsets, n_off, K, nb,
                              R_pad, static_cast<int64_t>(P),
                              static_cast<int64_t>(ldx),
                              static_cast<int64_t>(halo), y,
                              static_cast<cudaStream_t>(stream));
  }
  PD_PACKED_DISPATCH(launch_matvec, n_off, data_dt, vec_dt, data, x, oid,
                     offsets, n_off, K, nb, R_pad, static_cast<int64_t>(P),
                     static_cast<int64_t>(ldx), static_cast<int64_t>(halo), y,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int pd_packed_fused_halo(const void* data, int data_dt,
                                    const void* x, int vec_dt, const int* oid,
                                    const int* offsets, int n_off, int K,
                                    int nb, int R_pad, long long P,
                                    long long ldx, long long halo,
                                    const void* b, const void* d,
                                    const void* dinv, double c1, double c2,
                                    int mode, void* out0, void* out1,
                                    void* stream) {
  PD_PACKED_DISPATCH(launch_fused, n_off, data_dt, vec_dt, data, x, oid,
                     offsets, n_off, K, nb, R_pad, static_cast<int64_t>(P),
                     static_cast<int64_t>(ldx), static_cast<int64_t>(halo), b,
                     d, dinv, c1, c2, mode, out0, out1,
                     static_cast<cudaStream_t>(stream));
}
