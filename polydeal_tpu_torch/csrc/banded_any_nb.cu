// K1 and K2 at any block size nb, for Hopper (sm_90a): the build that
// PD_NB_DISPATCH (csrc/banded_common.cuh) takes for an nb without a
// specialised one (KERNEL_NB = 3, 4, 6, 10, 20: csrc/banded_matvec.cu and
// csrc/banded.cu), with nb a runtime argument.  TensorDGQ's blocks (4, 9,
// 16 in 2D; 8, 27, 64 in 3D), P_k's beyond p = 3 (15, 21 in 2D; 35 in 3D)
// and the field blocks of the coupled models (12, 30, ...) run here.
//
// Replaces the TPU Pallas kernels, at those nb,
//   K1  polydeal_tpu/ops/banded.py      _banded_matvec_imajor_impl
//   K2  polydeal_tpu/ops/fused_cheb.py  _banded_fused_impl
// and their sharded entries (banded_matvec_t_halo, banded_cheb_step_t_halo,
// banded_residual_t_halo) on one shard's lane slab: x is x_ext [nb, ldx]
// read at column halo + p + off, as in the specialised builds.
//
//   y[i,p] = sum_k sum_j data_i[i*R_pad + k*nb + j, p] * x[j, p+off_k]
// then, for K2, the Chebyshev step or the residual on y, pointwise in
// (i, p) (modes as in csrc/banded.cu).
//
// What bounds it: memory, as the specialised builds (the band is read
// once, two flops an element).  The specialised kernels keep all nb rows
// of a lane in registers; at runtime nb a thread keeps a chunk of kRows
// output rows instead: block row y of the grid holds rows [kRows y,
// kRows y + kRows) of W adjacent lanes, acc[kRows][W] in registers.  For
// each offset k and column j the thread loads its rows' band segments
// (16-byte streaming loads, at most kRows of them, all issued before the
// first is used) and x[j, p + off_k .. + W) once, and feeds every row of
// its chunk with it.  Each band element is read once; x is read once a
// row chunk (ceil(nb / kRows) times, from L2).  W follows K2's rule: wide
// where P, ldx and halo are multiples of it, every operand is 16-byte
// aligned and the wide grid still has kWideMinThreads threads, else one
// lane a thread.  Each row sums over k, then j, in order, with no atomics:
// two launches give the same bits.  Accumulation runs in the vector type
// (f64 for an f64 solve).  Row offsets use 64-bit arithmetic.
//
// Reached only through the C entries of csrc/banded_matvec.cu (K1, K1
// halo, K1's plan) and csrc/banded.cu (K2, K2 halo).

#include "banded_common.cuh"

namespace {

// the modes of the C interface (csrc/banded.cu's enum Mode), PRODUCT being
// K1's plain y = A x
enum Mode { RESIDUAL = 0, STEP0 = 1, STEP = 2, PRODUCT = 3 };

constexpr int kRows = 8;       // output rows a thread
constexpr int kThreads = 128;  // threads a block
// one lane a thread where W lanes a thread would leave fewer threads than
// this (128 blocks of 128)
constexpr int64_t kWideMinThreads = 16384;

template <typename TD, typename TV, int W>
__global__ void __launch_bounds__(kThreads)
    any_nb_kernel(const TD* __restrict__ data, const TV* __restrict__ x,
                  const int* __restrict__ offsets, int n_off, int nb,
                  int R_pad, int64_t P, int64_t ldx, int64_t halo,
                  const TV* __restrict__ b, const TV* __restrict__ d,
                  const TV* __restrict__ dinv, double c1, double c2,
                  int mode, TV* __restrict__ out0, TV* __restrict__ out1) {
  const int64_t p0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * W;
  if (p0 >= P) return;
  const int i0 = static_cast<int>(blockIdx.y) * kRows;
  const int rows = nb - i0 < kRows ? nb - i0 : kRows;
  TV acc[kRows][W];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int w = 0; w < W; ++w) acc[r][w] = TV(0);
  }
  for (int k = 0; k < n_off; ++k) {
    const int off = __ldg(offsets + k);
    const int64_t q0 = halo + p0 + off;  // x's column of lane p0
    // with ldx % W == 0 a window at a multiple of W lies wholly inside or
    // wholly outside [0, ldx)
    const bool x_al = off % W == 0;
    const bool x_in = q0 >= 0 && q0 < ldx;
    // band row (i0 + r) * R_pad + k * nb + j at lanes p0 ..
    const TD* slab =
        data + (static_cast<int64_t>(i0) * R_pad + static_cast<int64_t>(k) *
                                                       nb) * P + p0;
    for (int j = 0; j < nb; ++j) {
      TD a[kRows][W];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          load_wide<true, W>(
              slab + (static_cast<int64_t>(r) * R_pad + j) * P, a[r]);
        }
      }
      TV xv[W];
      const TV* xr = x + static_cast<int64_t>(j) * ldx + q0;
      if (x_al) {
        if (x_in) {
          load_wide<false, W>(xr, xv);
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) xv[w] = TV(0);
        }
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int64_t q = q0 + w;
          xv[w] = q >= 0 && q < ldx ? __ldg(xr + w) : TV(0);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
#pragma unroll
          for (int w = 0; w < W; ++w) acc[r][w] += as<TV>(a[r][w]) * xv[w];
        }
      }
    }
  }
  // the recurrence scalars act in the vector type, as in the plain version
  const TV c1v = static_cast<TV>(c1);
  const TV c2v = static_cast<TV>(c2);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= rows) break;
    const int i = i0 + r;
    const int64_t idx = static_cast<int64_t>(i) * P + p0;
    if (mode == PRODUCT) {
      store_wide<W>(out0 + idx, acc[r]);
      continue;
    }
    TV bv[W];
    load_wide<false, W>(b + idx, bv);
    if (mode == RESIDUAL) {
#pragma unroll
      for (int w = 0; w < W; ++w) bv[w] -= acc[r][w];
      store_wide<W>(out0 + idx, bv);
      continue;
    }
    TV dv[W], iv[W], xn[W], dn[W];
    load_wide<false, W>(dinv + idx, iv);
    // the update's own x sits at column halo + p0 of x's row i
    load_wide<false, W>(x + static_cast<int64_t>(i) * ldx + halo + p0, xn);
    if (mode == STEP) load_wide<false, W>(d + idx, dv);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      dn[w] = c2v * (iv[w] * (bv[w] - acc[r][w]));
      if (mode == STEP) dn[w] = c1v * dv[w] + dn[w];
      xn[w] += dn[w];
    }
    store_wide<W>(out0 + idx, xn);
    store_wide<W>(out1 + idx, dn);
  }
}

// W lanes a thread where it divides P, ldx and halo, every operand given
// is 16-byte aligned and the wide grid keeps kWideMinThreads threads; else
// one lane a thread
template <typename TD, typename TV>
int lanes_of(int nb, const void* data, const void* x, int64_t P,
             int64_t ldx, int64_t halo, const void* b, const void* d,
             const void* dinv, const void* out0, const void* out1) {
  constexpr int kWide = wide_lanes<TD, TV, kRows>();
  const int64_t chunks = (nb + kRows - 1) / kRows;
  auto ok = [](const void* p) { return p == nullptr || aligned16(p); };
  const bool wide = kWide > 1 && P / kWide * chunks >= kWideMinThreads &&
                    P % kWide == 0 && ldx % kWide == 0 &&
                    halo % kWide == 0 && aligned16(data) && aligned16(x) &&
                    ok(b) && ok(d) && ok(dinv) && ok(out0) && ok(out1);
  return wide ? kWide : 1;
}

dim3 grid_of(int nb, int64_t P, int W) {
  return dim3(n_blocks((P + W - 1) / W, kThreads),
              static_cast<unsigned int>((nb + kRows - 1) / kRows));
}

template <typename TD, typename TV>
int launch(int nb, const void* data, const void* x, const int* offsets,
           int n_off, int R_pad, int64_t P, int64_t ldx, int64_t halo,
           const void* b, const void* d, const void* dinv, double c1,
           double c2, int mode, void* out0, void* out1, cudaStream_t st) {
  constexpr int kWide = wide_lanes<TD, TV, kRows>();
  const int W =
      lanes_of<TD, TV>(nb, data, x, P, ldx, halo, b, d, dinv, out0, out1);
  decltype(&any_nb_kernel<TD, TV, 1>) kernel =
      W == kWide ? &any_nb_kernel<TD, TV, kWide> : &any_nb_kernel<TD, TV, 1>;
  kernel<<<grid_of(nb, P, W), kThreads, 0, st>>>(
      static_cast<const TD*>(data), static_cast<const TV*>(x), offsets,
      n_off, nb, R_pad, P, ldx, halo, static_cast<const TV*>(b),
      static_cast<const TV*>(d), static_cast<const TV*>(dinv), c1, c2, mode,
      static_cast<TV*>(out0), static_cast<TV*>(out1));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace pd_any_nb {

template <typename TD, typename TV>
int matvec(int nb, const void* data, const void* x, const int* offsets,
           int n_off, int R_pad, int64_t P, int64_t ldx, int64_t halo,
           void* y, cudaStream_t st) {
  return launch<TD, TV>(nb, data, x, offsets, n_off, R_pad, P, ldx, halo,
                        nullptr, nullptr, nullptr, 0.0, 0.0, PRODUCT, y,
                        nullptr, st);
}

template <typename TD, typename TV>
int fused(int nb, const void* data, const void* x, const int* offsets,
          int n_off, int R_pad, int64_t P, int64_t ldx, int64_t halo,
          const void* b, const void* d, const void* dinv, double c1,
          double c2, int mode, void* out0, void* out1, cudaStream_t st) {
  return launch<TD, TV>(nb, data, x, offsets, n_off, R_pad, P, ldx, halo, b,
                        d, dinv, c1, c2, mode, out0, out1, st);
}

template <typename TD, typename TV>
int plan(int nb, const void* data, const void* x, const void* y, int n_off,
         int64_t P, int64_t ldx, int64_t halo, long long* out) {
  (void)n_off;
  const int W = lanes_of<TD, TV>(nb, data, x, P, ldx, halo, nullptr,
                                 nullptr, nullptr, y, nullptr);
  const dim3 g = grid_of(nb, P, W);
  out[0] = W;
  out[1] = 1;  // one offset group: each thread sums every offset
  out[2] = kThreads;
  out[3] = static_cast<long long>(g.x) * g.y;
  out[4] = 0;
  out[5] = kRows;
  return 0;
}

#define PD_ANY_NB_INSTANCE(TD, TV)                                          \
  template int matvec<TD, TV>(int, const void*, const void*, const int*,    \
                              int, int, int64_t, int64_t, int64_t, void*,   \
                              cudaStream_t);                                \
  template int fused<TD, TV>(int, const void*, const void*, const int*, int, \
                             int, int64_t, int64_t, int64_t, const void*,   \
                             const void*, const void*, double, double, int, \
                             void*, void*, cudaStream_t);                   \
  template int plan<TD, TV>(int, const void*, const void*, const void*, int, \
                            int64_t, int64_t, int64_t, long long*);

// the (data, vector) dtype pairs of PD_DISPATCH
PD_ANY_NB_INSTANCE(float, float)
PD_ANY_NB_INSTANCE(__nv_bfloat16, float)
PD_ANY_NB_INSTANCE(double, double)
PD_ANY_NB_INSTANCE(float, double)
PD_ANY_NB_INSTANCE(__nv_bfloat16, double)

#undef PD_ANY_NB_INSTANCE

}  // namespace pd_any_nb
