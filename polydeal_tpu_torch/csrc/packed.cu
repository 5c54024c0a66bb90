// Packed block SpMV (K6) and the fused Chebyshev step / residual on it (K7)
// for Hopper (sm_90a), over the packed layout of BlockPacked.data_i / oid.
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
// Layout (shared with the JAX package, so one array feeds either):
//   data_i [nb * R_pad, P]: row i*R_pad + k*nb + j multiplies x[j, p + off]
//     with off = offsets[oid[k, p]]; rows k*nb + j >= K*nb of each i-slab
//     are padding (R_pad = K*nb rounded up to 16) and never read.
//   oid [K, P] int32: the offset index slot k holds at lane p; -1 (no
//     block; the stored block is zero) adds nothing.
//   offsets [n_off] int32; x, b, d, dinv, outputs [nb, P] row-major.
//
//   K6:        y[i,p] = sum_k sum_j data_i[i*R_pad + k*nb + j, p] * x[j,p+off]
//   K7 step0:  d' = c2 * dinv * (b - y);          x' = x + d'
//   K7 step:   d' = c1 * d + c2 * dinv * (b - y); x' = x + d'
//   K7 resid:  r  = b - y
//
// What bounds it: memory.  Per lane a call reads the active slots' blocks
// (nb*nb values each), K oid entries and x, and writes y: at the flagship's
// fine level without the relabel (nb=4, K=7, ~6.9 active slots, P=262144)
// about 133 MB in f32, against 2 flops per band value.  The dense 37-offset
// band would be 621 MB.  The design does only what that needs: one thread
// per lane p, as K1.  The oid read of each slot is coalesced along p; an
// inactive slot is skipped without touching its band rows or x.  The
// offset table (37 entries at the fine level) is staged in shared memory,
// since neighbouring lanes of one slot hold different offsets.  x[j, p+off]
// is a bounds-checked load; within one slot a warp's x loads scatter over
// up to one window per offset of the slot (10 at the fine level, up to
// 112,348 lanes apart), so they are served by L2 (x is 4 MB; L2 is 50 MB)
// rather than coalesced: staging windows in shared memory is later work.
// The TPU mechanics (lane tiles, T-padded x, pre-rolled far copies, funnel
// shifts) have no counterpart.  K7 is K6's loop with K2's epilogue, so the
// smoother's vectors are read once and y never goes to device memory.
//
// Types: band f32 or f64; vectors f32 or f64 (f64 vectors with either
// band).  Accumulation runs in the vector type.  No bf16: packed levels
// keep their f32 band for smoothing.  Index arithmetic is 64-bit.
//
// Plain C interface for ctypes (built by polydeal_tpu_torch/ops/_build.py):
// each entry point launches on the given stream and returns
// cudaGetLastError() (0 on success), -1 for an unsupported dtype pair, or
// -2 when the offset table does not fit the default shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { F32 = 0, F64 = 1 };
enum Mode { RESIDUAL = 0, STEP0 = 1, STEP = 2 };

constexpr int kThreads = 256;
constexpr int kMaxOffsets = 48 * 1024 / sizeof(int);

// Stages the offset table in shared memory; every thread of the block
// must call it, before any returns.
__device__ __forceinline__ void stage_offsets(const int* __restrict__ offsets,
                                              int n_off, int* s_off) {
  for (int t = threadIdx.x; t < n_off; t += blockDim.x) s_off[t] = offsets[t];
  __syncthreads();
}

// y[i, p] for one output row i and one lane p: x's column for offset o is
// halo + p + o in rows of ldx entries, zero outside them.
template <typename TD, typename TV>
__device__ __forceinline__ TV packed_row(const TD* __restrict__ data,
                                         const TV* __restrict__ x,
                                         const int* __restrict__ oid,
                                         const int* s_off, int n_off, int K,
                                         int nb, int R_pad, int64_t P,
                                         int64_t ldx, int64_t halo, int i,
                                         int64_t p) {
  TV acc = TV(0);
  const TD* slab = data + static_cast<int64_t>(i) * R_pad * P + p;
  for (int k = 0; k < K; ++k) {
    const int o = __ldg(oid + static_cast<int64_t>(k) * P + p);
    if (o < 0 || o >= n_off) continue;  // no block in this slot
    const int64_t c = halo + p + s_off[o];
    if (c < 0 || c >= ldx) continue;  // x is zero outside its row
    const TD* rows = slab + static_cast<int64_t>(k) * nb * P;
    for (int j = 0; j < nb; ++j) {
      acc += static_cast<TV>(rows[static_cast<int64_t>(j) * P]) *
             x[static_cast<int64_t>(j) * ldx + c];
    }
  }
  return acc;
}

template <typename TD, typename TV>
__global__ void __launch_bounds__(kThreads)
    packed_matvec_kernel(const TD* __restrict__ data,
                         const TV* __restrict__ x,
                         const int* __restrict__ oid,
                         const int* __restrict__ offsets, int n_off, int K,
                         int nb, int R_pad, int64_t P, int64_t ldx,
                         int64_t halo, TV* __restrict__ y) {
  extern __shared__ int s_off[];
  stage_offsets(offsets, n_off, s_off);
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= P) return;
  for (int i = 0; i < nb; ++i) {
    y[static_cast<int64_t>(i) * P + p] = packed_row(
        data, x, oid, s_off, n_off, K, nb, R_pad, P, ldx, halo, i, p);
  }
}

template <typename TD, typename TV>
__global__ void __launch_bounds__(kThreads)
    packed_fused_kernel(const TD* __restrict__ data,
                        const TV* __restrict__ x,
                        const int* __restrict__ oid,
                        const int* __restrict__ offsets, int n_off, int K,
                        int nb, int R_pad, int64_t P, int64_t ldx,
                        int64_t halo, const TV* __restrict__ b,
                        const TV* __restrict__ d,
                        const TV* __restrict__ dinv, double c1, double c2,
                        int mode, TV* __restrict__ out0,
                        TV* __restrict__ out1) {
  extern __shared__ int s_off[];
  stage_offsets(offsets, n_off, s_off);
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= P) return;
  // the recurrence scalars act in the vector type, as in the plain version
  const TV c1v = static_cast<TV>(c1);
  const TV c2v = static_cast<TV>(c2);
  for (int i = 0; i < nb; ++i) {
    const int64_t idx = static_cast<int64_t>(i) * P + p;
    const TV y = packed_row(data, x, oid, s_off, n_off, K, nb, R_pad, P, ldx,
                            halo, i, p);
    const TV r = b[idx] - y;
    if (mode == RESIDUAL) {
      out0[idx] = r;
      continue;
    }
    TV dn = c2v * (dinv[idx] * r);
    if (mode == STEP) dn = c1v * d[idx] + dn;
    out0[idx] = x[static_cast<int64_t>(i) * ldx + halo + p] + dn;
    out1[idx] = dn;
  }
}

inline unsigned int n_blocks(int64_t P) {
  return static_cast<unsigned int>((P + kThreads - 1) / kThreads);
}

template <typename TD, typename TV>
int launch_matvec(const void* data, const void* x, const int* oid,
                  const int* offsets, int n_off, int K, int nb, int R_pad,
                  int64_t P, int64_t ldx, int64_t halo, void* y,
                  cudaStream_t s) {
  packed_matvec_kernel<TD, TV>
      <<<n_blocks(P), kThreads, n_off * sizeof(int), s>>>(
          static_cast<const TD*>(data), static_cast<const TV*>(x), oid,
          offsets, n_off, K, nb, R_pad, P, ldx, halo, static_cast<TV*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TV>
int launch_fused(const void* data, const void* x, const int* oid,
                 const int* offsets, int n_off, int K, int nb, int R_pad,
                 int64_t P, int64_t ldx, int64_t halo, const void* b,
                 const void* d, const void* dinv, double c1, double c2,
                 int mode, void* out0, void* out1, cudaStream_t s) {
  packed_fused_kernel<TD, TV>
      <<<n_blocks(P), kThreads, n_off * sizeof(int), s>>>(
          static_cast<const TD*>(data), static_cast<const TV*>(x), oid,
          offsets, n_off, K, nb, R_pad, P, ldx, halo,
          static_cast<const TV*>(b),
          static_cast<const TV*>(d), static_cast<const TV*>(dinv), c1, c2,
          mode, static_cast<TV*>(out0), static_cast<TV*>(out1));
  return static_cast<int>(cudaGetLastError());
}

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

}  // namespace

extern "C" int pd_packed_matvec(const void* data, int data_dt, const void* x,
                                int vec_dt, const int* oid,
                                const int* offsets, int n_off, int K, int nb,
                                int R_pad, long long P, void* y,
                                void* stream) {
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
