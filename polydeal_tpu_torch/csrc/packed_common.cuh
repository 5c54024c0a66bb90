// What the packed kernels share: K6 (packed SpMV) and K7 (the fused
// Chebyshev step / residual on it), and their halo entries, over the packed
// layout of BlockPacked.data_i / oid.  csrc/packed.cu instantiates them for
// f32 and f64 vectors, csrc/packed_bf16.cu K6 for bf16 vectors, each in
// its own translation unit (ops/_build.py runs one nvcc per source, all at
// once), so that neither build grows with the other.
//
// Layout (shared with the JAX package, so one array feeds either):
//   data_i [nb * R_pad, P]: row i*R_pad + k*nb + j multiplies x[j, p + off]
//     with off = offsets[oid[k, p]]; rows k*nb + j >= K*nb of each i-slab
//     are padding (R_pad = K*nb rounded up to 16) and never read.
//   oid [K, P] int32: the offset index slot k holds at lane p; -1 (no
//     block; the stored block is zero) adds nothing.
//   offsets [n_off] int32; x is [nb, ldx]: lane p's column for offset o is
//     halo + p + o, zero outside [0, ldx) (the unsharded entries pass
//     ldx = P, halo = 0); b, d, dinv, outputs [nb, P] row-major.
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
// Types: the product accumulates in AccOf<TV>: the vector type for f32 and
// f64 vectors, f32 for bf16 ones (the JAX kernel's acc_t, packed.py:209),
// and each output is rounded to the vector type once.  Index arithmetic is
// 64-bit.

#pragma once

#include "banded_common.cuh"

namespace {

enum Mode { RESIDUAL = 0, STEP0 = 1, STEP = 2 };

constexpr int kPackedThreads = 256;
constexpr int kMaxOffsets = 48 * 1024 / sizeof(int);

template <typename TV>
struct AccOf {
  using type = TV;
};
template <>
struct AccOf<__nv_bfloat16> {
  using type = float;
};

// Stages the offset table in shared memory; every thread of the block
// must call it, before any returns.
__device__ __forceinline__ void stage_offsets(const int* __restrict__ offsets,
                                              int n_off, int* s_off) {
  for (int t = threadIdx.x; t < n_off; t += blockDim.x) s_off[t] = offsets[t];
  __syncthreads();
}

// y[i, p] for one output row i and one lane p, in the accumulator type: x's
// column for offset o is halo + p + o in rows of ldx entries, zero outside
// them.
template <typename TD, typename TV, typename A = typename AccOf<TV>::type>
__device__ __forceinline__ A packed_row(const TD* __restrict__ data,
                                        const TV* __restrict__ x,
                                        const int* __restrict__ oid,
                                        const int* s_off, int n_off, int K,
                                        int nb, int R_pad, int64_t P,
                                        int64_t ldx, int64_t halo, int i,
                                        int64_t p) {
  A acc = A(0);
  const TD* slab = data + static_cast<int64_t>(i) * R_pad * P + p;
  for (int k = 0; k < K; ++k) {
    const int o = __ldg(oid + static_cast<int64_t>(k) * P + p);
    if (o < 0 || o >= n_off) continue;  // no block in this slot
    const int64_t c = halo + p + s_off[o];
    if (c < 0 || c >= ldx) continue;  // x is zero outside its row
    const TD* rows = slab + static_cast<int64_t>(k) * nb * P;
    for (int j = 0; j < nb; ++j) {
      acc += as<A>(rows[static_cast<int64_t>(j) * P]) *
             as<A>(x[static_cast<int64_t>(j) * ldx + c]);
    }
  }
  return acc;
}

template <typename TD, typename TV>
__global__ void __launch_bounds__(kPackedThreads)
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
    y[static_cast<int64_t>(i) * P + p] = as<TV>(packed_row(
        data, x, oid, s_off, n_off, K, nb, R_pad, P, ldx, halo, i, p));
  }
}

// K7: f32 and f64 vectors only (a bf16 sweep runs the composed smoother).
template <typename TD, typename TV>
__global__ void __launch_bounds__(kPackedThreads)
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

template <typename TD, typename TV>
int launch_matvec(const void* data, const void* x, const int* oid,
                  const int* offsets, int n_off, int K, int nb, int R_pad,
                  int64_t P, int64_t ldx, int64_t halo, void* y,
                  cudaStream_t s) {
  packed_matvec_kernel<TD, TV>
      <<<n_blocks(P, kPackedThreads), kPackedThreads, n_off * sizeof(int),
         s>>>(static_cast<const TD*>(data), static_cast<const TV*>(x), oid,
              offsets, n_off, K, nb, R_pad, P, ldx, halo,
              static_cast<TV*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TV>
int launch_fused(const void* data, const void* x, const int* oid,
                 const int* offsets, int n_off, int K, int nb, int R_pad,
                 int64_t P, int64_t ldx, int64_t halo, const void* b,
                 const void* d, const void* dinv, double c1, double c2,
                 int mode, void* out0, void* out1, cudaStream_t s) {
  packed_fused_kernel<TD, TV>
      <<<n_blocks(P, kPackedThreads), kPackedThreads, n_off * sizeof(int),
         s>>>(static_cast<const TD*>(data), static_cast<const TV*>(x), oid,
              offsets, n_off, K, nb, R_pad, P, ldx, halo,
              static_cast<const TV*>(b), static_cast<const TV*>(d),
              static_cast<const TV*>(dinv), c1, c2, mode,
              static_cast<TV*>(out0), static_cast<TV*>(out1));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6 with bf16 x (csrc/packed_bf16.cu): the packed SpMV on an f32 or bf16
// band, accumulating in f32 and storing y in bf16; -1 for another band
// type, -2 when the offset table does not fit the default shared memory.
// The C entries of csrc/packed.cu forward bf16 vectors here.
int packed_matvec_bf16(const void* data, int data_dt, const void* x,
                       const int* oid, const int* offsets, int n_off, int K,
                       int nb, int R_pad, int64_t P, int64_t ldx,
                       int64_t halo, void* y, cudaStream_t s);
