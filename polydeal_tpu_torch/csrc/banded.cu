// Fused Chebyshev step / residual (K2) for Hopper (sm_90a), over the
// i-major band layout of BlockBanded.data_i.  K1, the i-major product, is
// csrc/banded_matvec.cu; K0, the o-major product, plain and fused, is
// csrc/banded_omajor.cu.
//
// Replaces the TPU Pallas kernel
//   K2  polydeal_tpu/ops/fused_cheb.py  _banded_fused_impl
// The halo entry
// (pd_banded_fused_halo) runs K2 on one shard's lane slab, in place of the
// JAX package's sharded entry points
//   polydeal_tpu/ops/fused_cheb.py  banded_cheb_step_t_halo,
//                                   banded_residual_t_halo
// x is then x_ext [nb, ldx = P + 2 T], whose T lanes on each side are the
// neighbouring shards' (every |off| <= T): lane p reads column T + p + off
// of rows ldx apart, and the update's own x at column T + p.  The kernel
// takes x's row stride ldx and the halo width as runtime arguments (the
// unsharded entry passes ldx = P, halo = 0), so the halo adds no template
// instantiation; one test, 0 <= halo + p + off < ldx, gives both the zero
// outside [0, P) and the slab window.
//
// Layout: csrc/banded_common.cuh; x, b, d, dinv, outputs: [nb, P]
// row-major.
//
//   K2 step0:  d' = c2 * dinv * (b - y);          x' = x + d'
//   K2 step:   d' = c1 * d + c2 * dinv * (b - y); x' = x + d'
//   K2 resid:  r  = b - y
// with y = A x as K1 computes it.
//
// What bounds K2: memory.  Each call streams the band once,
// nb * n_off * nb * P elements (58.7 MB in bf16 at the flagship fine level:
// nb=4, n_off=7, P=262144), against 2*nb*n_off*nb*P flops -- well under
// one flop per byte.  K2 keeps many bytes in flight with few instructions:
// each thread owns W adjacent lanes and all nb output rows and runs the
// register-blocked product loop of banded_common.cuh (band_accumulate:
// 16-byte streaming band loads in batches, each x window loaded once a
// thread); b, d, dinv and the outputs move in 16-byte accesses as well.
// Where P is not a multiple of W, an operand is not 16-byte aligned or
// P/W threads would leave the card short of work (the 32768-lane level),
// each thread takes one lane (W = 1).  Accumulation runs in the vector
// type (f64 for an f64 solve).  Row offsets use 64-bit arithmetic.  The
// TPU mechanics (lane tiles, funnel shifts, padded x and pre-rolled far
// copies, SMEM scalars) have no counterpart.
//
// Plain C interface for ctypes (built by polydeal_tpu_torch/ops/_build.py):
// each entry point launches on the given stream and returns
// cudaGetLastError() (0 on success), -1 for an unsupported dtype pair, -3
// for an unknown mode or -4 for nb < 1.  K2 and K2 halo at an nb without
// a specialised build (banded_common.cuh's PD_NB_DISPATCH) run the
// runtime-nb kernel of csrc/banded_any_nb.cu.

#include "banded_common.cuh"

namespace {

// the fused modes of the C interface
enum Mode { RESIDUAL = 0, STEP0 = 1, STEP = 2 };

constexpr int kFusedThreads = 128;
// K2 takes one lane per thread where W lanes per thread would leave fewer
// threads than this (128 blocks of 128)
constexpr int64_t kWideMinThreads = 16384;

// Each thread owns W whole lanes from p0 and all NB output rows: the
// launch guarantees that P, ldx and halo are multiples of W and that the
// operands are 16-byte aligned, so no load is partial and the main loop
// has no bounds test but the zero outside x's rows.
template <typename TD, typename TV, int NB, int W>
__global__ void __launch_bounds__(kFusedThreads)
    banded_fused_kernel(const TD* __restrict__ data,
                        const TV* __restrict__ x,
                        const int* __restrict__ offsets, int n_off,
                        int R_pad, int64_t P, int64_t ldx, int64_t halo,
                        const TV* __restrict__ b,
                        const TV* __restrict__ d,
                        const TV* __restrict__ dinv, double c1, double c2,
                        int mode, TV* __restrict__ out0,
                        TV* __restrict__ out1) {
  const int64_t p0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * W;
  if (p0 >= P) return;
  TV acc[NB][W];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
#pragma unroll
    for (int w = 0; w < W; ++w) acc[i][w] = TV(0);
  }
  band_accumulate<TD, TV, NB, W>(data, x, offsets, 0, n_off, R_pad, P, ldx,
                                 halo, p0, acc);
  // the recurrence scalars act in the vector type, as in the plain version
  const TV c1v = static_cast<TV>(c1);
  const TV c2v = static_cast<TV>(c2);
  if (mode == RESIDUAL) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int64_t idx = static_cast<int64_t>(i) * P + p0;
      TV r[W];
      load_wide<false, W>(b + idx, r);
#pragma unroll
      for (int w = 0; w < W; ++w) r[w] -= acc[i][w];
      store_wide<W>(out0 + idx, r);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int64_t idx = static_cast<int64_t>(i) * P + p0;
    TV bv[W], dv[W], iv[W], xn[W], dn[W];
    load_wide<false, W>(b + idx, bv);
    load_wide<false, W>(dinv + idx, iv);
    // the update's own x sits at column halo + p0 of x's row i
    load_wide<false, W>(x + static_cast<int64_t>(i) * ldx + halo + p0, xn);
    if (mode == STEP) load_wide<false, W>(d + idx, dv);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      dn[w] = c2v * (iv[w] * (bv[w] - acc[i][w]));
      if (mode == STEP) dn[w] = c1v * dv[w] + dn[w];
      xn[w] += dn[w];
    }
    store_wide<W>(out0 + idx, xn);
    store_wide<W>(out1 + idx, dn);
  }
}

template <typename TD, typename TV, int NB, int W>
void launch_fused_w(const void* data, const void* x, const int* offsets,
                    int n_off, int R_pad, int64_t P, int64_t ldx,
                    int64_t halo, const void* b, const void* d,
                    const void* dinv, double c1, double c2, int mode,
                    void* out0, void* out1, cudaStream_t s) {
  banded_fused_kernel<TD, TV, NB, W>
      <<<n_blocks(P / W, kFusedThreads), kFusedThreads, 0, s>>>(
          static_cast<const TD*>(data), static_cast<const TV*>(x), offsets,
          n_off, R_pad, P, ldx, halo, static_cast<const TV*>(b),
          static_cast<const TV*>(d), static_cast<const TV*>(dinv), c1, c2,
          mode, static_cast<TV*>(out0), static_cast<TV*>(out1));
}

template <typename TD, typename TV, int NB>
int launch_fused_nb(const void* data, const void* x, const int* offsets,
                    int n_off, int R_pad, int64_t P, int64_t ldx,
                    int64_t halo, const void* b, const void* d,
                    const void* dinv, double c1, double c2, int mode,
                    void* out0, void* out1, cudaStream_t s) {
  constexpr int W = wide_lanes<TD, TV, NB>();
  // W lanes a thread where they fill the card, divide P and x's row
  // stride and halo, and every operand is 16-byte aligned; else one lane a
  // thread (the scalar path)
  if (W > 1 && P / W >= kWideMinThreads && P % W == 0 && ldx % W == 0 &&
      halo % W == 0 && aligned16(data) && aligned16(x) && aligned16(b) &&
      aligned16(d) && aligned16(dinv) && aligned16(out0) &&
      aligned16(out1)) {
    launch_fused_w<TD, TV, NB, W>(data, x, offsets, n_off, R_pad, P, ldx,
                                  halo, b, d, dinv, c1, c2, mode, out0, out1,
                                  s);
  } else {
    launch_fused_w<TD, TV, NB, 1>(data, x, offsets, n_off, R_pad, P, ldx,
                                  halo, b, d, dinv, c1, c2, mode, out0, out1,
                                  s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TV>
int launch_fused(const void* data, const void* x, const int* offsets,
                 int n_off, int nb, int R_pad, int64_t P, int64_t ldx,
                 int64_t halo, const void* b, const void* d,
                 const void* dinv, double c1, double c2, int mode,
                 void* out0, void* out1, cudaStream_t s) {
  if (mode < RESIDUAL || mode > STEP) return -3;
  if (nb < 1) return -4;
  PD_NB_DISPATCH(launch_fused_nb, pd_any_nb::fused, TD, TV, nb, data, x,
                 offsets, n_off, R_pad, P, ldx, halo, b, d, dinv, c1, c2,
                 mode, out0, out1, s);
}

}  // namespace

extern "C" int pd_banded_fused(const void* data, int data_dt, const void* x,
                               int vec_dt, const int* offsets, int n_off,
                               int nb, int R_pad, long long P, const void* b,
                               const void* d, const void* dinv, double c1,
                               double c2, int mode, void* out0, void* out1,
                               void* stream) {
  PD_DISPATCH(launch_fused, data_dt, vec_dt, data, x, offsets, n_off, nb,
              R_pad, static_cast<int64_t>(P), static_cast<int64_t>(P), 0, b,
              d, dinv, c1, c2, mode, out0, out1,
              static_cast<cudaStream_t>(stream));
}

// K2 on a shard's slab, x_ext [nb, ldx] with ldx = P + 2 halo, lane p
// reading column halo + p + off.
extern "C" int pd_banded_fused_halo(const void* data, int data_dt,
                                    const void* x, int vec_dt,
                                    const int* offsets, int n_off, int nb,
                                    int R_pad, long long P, long long ldx,
                                    long long halo, const void* b,
                                    const void* d, const void* dinv,
                                    double c1, double c2, int mode,
                                    void* out0, void* out1, void* stream) {
  PD_DISPATCH(launch_fused, data_dt, vec_dt, data, x, offsets, n_off, nb,
              R_pad, static_cast<int64_t>(P), static_cast<int64_t>(ldx),
              static_cast<int64_t>(halo), b, d, dinv, c1, c2, mode, out0,
              out1, static_cast<cudaStream_t>(stream));
}
