// Banded block SpMV (K1) and fused Chebyshev step / residual (K2) for
// Hopper (sm_90a), over the i-major band layout of BlockBanded.data_i; and
// the o-major banded SpMV (K0), plain or fused with the same Chebyshev
// step / residual, over BlockBanded.data.
//
// Replaces the TPU Pallas kernels
//   K1  polydeal_tpu/ops/banded.py      _banded_matvec_imajor_impl
//   K2  polydeal_tpu/ops/fused_cheb.py  _banded_fused_impl
//   K0  polydeal_tpu/ops/banded.py      _banded_matvec_impl
// Fused K0 computes K2's function on the o-major layout, where the JAX
// package runs the product and the update unfused.  The halo entries
// (pd_banded_matvec_halo, pd_banded_fused_halo) run K1 and K2 on one
// shard's lane slab, in place of the JAX package's sharded entry points
//   polydeal_tpu/ops/banded.py      banded_matvec_t_halo
//   polydeal_tpu/ops/fused_cheb.py  banded_cheb_step_t_halo,
//                                   banded_residual_t_halo
// x is then x_ext [nb, ldx = P + 2 T], whose T lanes on each side are the
// neighbouring shards' (every |off| <= T): lane p reads column T + p + off
// of rows ldx apart, and the update's own x at column T + p.  The kernels
// take x's row stride ldx and the halo width as runtime arguments (the
// unsharded entries pass ldx = P, halo = 0), so the halo adds no template
// instantiation; one test, 0 <= halo + p + off < ldx, gives both the zero
// outside [0, P) and the slab window.
//
// Layout (shared with the JAX package, so one array feeds either):
//   data_i [nb * R_pad, P], row i*R_pad + k*nb + j multiplies x[j, p + off_k];
//   rows k*nb + j >= n_off*nb of each i-slab are padding and never read.
//   x, b, d, dinv, outputs: [nb, P] row-major.  x is zero outside [0, P).
//
//   K1:        y[i,p] = sum_k sum_j data_i[i*R_pad + k*nb + j, p] * x[j, p+off_k]
//   K2 step0:  d' = c2 * dinv * (b - y);          x' = x + d'
//   K2 step:   d' = c1 * d + c2 * dinv * (b - y); x' = x + d'
//   K2 resid:  r  = b - y
//
// What bounds K1 and K2: memory.  Each call streams the band once,
// nb * n_off * nb * P elements (58.7 MB in bf16 at the flagship fine level:
// nb=4, n_off=7, P=262144), against 2*nb*n_off*nb*P flops -- well under
// one flop per byte.  K1 runs one thread per lane p, so every load of
// data_i[row, p] and of x[j, p+off] is coalesced along p across a warp, and
// re-reads x nb times per lane (once per output row i) from L2.
//
// K2 is redesigned to keep more bytes in flight with fewer instructions:
// each thread owns W adjacent lanes and all nb output rows (templated on
// nb, W accumulators per row in registers).  The loop runs k, j outer and
// i inner, so each x[j, p+off_k] is loaded once per thread and feeds all nb
// rows; each band row segment is one 16-byte load (W = 8 bf16, 4 f32 or 2
// f64 lanes; fewer where nb*W accumulators would outgrow ~96 registers)
// with the streaming cache hint, so one warp instruction moves 512 bytes
// of band instead of 64.  The band segments of a batch of columns j (up to
// 256 bytes a thread: all of an offset's at nb=4) are loaded with no test
// in between, so all are in flight before the first is used (a branch
// between two loads holds the second back until the first is consumed).
// x at p+off_k is a wide load where off_k is a multiple of W (the window
// then lies wholly inside or outside [0, P)) and a bounds-checked scalar
// load otherwise; b, d, dinv and the outputs move in 16-byte accesses as
// well.  Each row sums over k, then j: the order of K1 and of the plain
// version.  Where P is not a multiple of W, an operand
// is not 16-byte aligned or P/W threads would leave the card short of work
// (the 32768-lane level), each thread takes one lane (W = 1).
// Accumulation runs in the vector type (f64 for an f64 solve).  Row offsets
// use 64-bit arithmetic.  The TPU mechanics (lane tiles, funnel shifts,
// padded x and pre-rolled far copies, SMEM scalars) have no counterpart.
//
// K0, the o-major layout: data [n_off, nb, nb, P], element (o, i, j, p) at
// ((o*nb + i)*nb + j)*P + p, multiplies x[j, p + off_o];
//   y[i,p] = sum_o sum_j data[o,i,j,p] * x[j, p+off_o], x zero outside [0,P),
// then, fused, K2's three modes on y.  Accumulation follows the Pallas
// kernel's contract: f32 for bf16 or f32 data, f64 for f64 data; y enters
// the update in the vector type, as in the plain version.  It serves the
// small multigrid levels (64 to 4,096 lanes), where the band is 0.1-2 MB
// and a launch costs more than its bytes: what bounds it there is the
// number of launches, so the product and the Chebyshev update are one
// launch per smoothing step (else a product and about six elementwise
// launches).  One thread per output (i, p): a
// grid of (lane blocks, nb), nb times the threads of one lane per thread,
// each reading its own nb*n_off band elements once, coalesced along p, and
// its own b, d, dinv and x at (i, p) once; x[j, p+off_o] through a
// bounds-checked load.  The offset table is staged in shared memory.
//
// Plain C interface for ctypes (built by polydeal_tpu_torch/ops/_build.py):
// each entry point launches on the given stream and returns
// cudaGetLastError() (0 on success), -1 for an unsupported dtype pair, -2
// for an nb K2 has no build for, or -3 for an unknown mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

enum DType { F32 = 0, F64 = 1, BF16 = 2 };
// RESIDUAL, STEP0 and STEP are the fused modes of the C interface; PRODUCT
// (y = A x) is K0's plain product
enum Mode { RESIDUAL = 0, STEP0 = 1, STEP = 2, PRODUCT = 3 };

constexpr int kThreads = 256;        // K1
constexpr int kFusedThreads = 128;   // K2
constexpr int kOmajorThreads = 128;  // K0, plain and fused
// K2 takes one lane per thread where W lanes per thread would leave fewer
// threads than this (128 blocks of 128)
constexpr int64_t kWideMinThreads = 16384;

template <typename TV, typename TD>
__device__ __forceinline__ TV as(TD v) {
  return static_cast<TV>(v);
}

template <>
__device__ __forceinline__ float as<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <>
__device__ __forceinline__ double as<double, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return static_cast<double>(__bfloat162float(v));
}

template <typename TV, typename TD>
__device__ __forceinline__ TV load_as(const TD* p) {
  return as<TV>(*p);
}

// y[i, p] for one output row i and one lane p (K1).  Lane p's column for
// offset o is halo + p + o in x's rows of ldx entries, zero outside them.
template <typename TD, typename TV>
__device__ __forceinline__ TV band_row(const TD* __restrict__ data,
                                       const TV* __restrict__ x,
                                       const int* __restrict__ offsets,
                                       int n_off, int nb, int R_pad,
                                       int64_t P, int64_t ldx, int64_t halo,
                                       int i, int64_t p) {
  TV acc = TV(0);
  const TD* slab = data + static_cast<int64_t>(i) * R_pad * P + p;
  for (int k = 0; k < n_off; ++k) {
    const int64_t c = halo + p + __ldg(offsets + k);
    if (c < 0 || c >= ldx) continue;  // x is zero outside its row
    const TD* rows = slab + static_cast<int64_t>(k) * nb * P;
    for (int j = 0; j < nb; ++j) {
      acc += load_as<TV>(rows + static_cast<int64_t>(j) * P) *
             x[static_cast<int64_t>(j) * ldx + c];
    }
  }
  return acc;
}

template <typename TD, typename TV>
__global__ void __launch_bounds__(kThreads)
    banded_matvec_imajor_kernel(const TD* __restrict__ data,
                                const TV* __restrict__ x,
                                const int* __restrict__ offsets, int n_off,
                                int nb, int R_pad, int64_t P, int64_t ldx,
                                int64_t halo, TV* __restrict__ y) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= P) return;
  for (int i = 0; i < nb; ++i) {
    y[static_cast<int64_t>(i) * P + p] =
        band_row(data, x, offsets, n_off, nb, R_pad, P, ldx, halo, i, p);
  }
}

// ---- K2: W lanes and nb rows per thread ----------------------------------

template <int B>
struct RawOf;
template <>
struct RawOf<2> {
  using type = unsigned short;
};
template <>
struct RawOf<4> {
  using type = unsigned int;
};
template <>
struct RawOf<8> {
  using type = uint2;
};
template <>
struct RawOf<16> {
  using type = uint4;
};

// Lanes per thread of K2's wide path: one 16-byte band load per row, halved
// while the nb*W accumulators would take more than ~96 registers.
template <typename TD, typename TV, int NB>
__host__ __device__ constexpr int wide_lanes() {
  int w = 16 / static_cast<int>(sizeof(TD));
  while (w > 1 && NB * w * static_cast<int>(sizeof(TV)) > 96 * 4) w /= 2;
  return w;
}

// Columns j per load batch: the batch's band segments (all nb rows) take at
// most 256 bytes a thread, so every load of a batch is in flight before
// its first use.
template <typename TD, int NB, int W>
__host__ __device__ constexpr int batch_cols() {
  int jb = 256 / (NB * W * static_cast<int>(sizeof(TD)));
  return jb < 1 ? 1 : (jb > NB ? NB : jb);
}

// W consecutive values at src (aligned to the load size) in loads of up to
// 16 bytes.  kStream marks data read once (cache-streaming hint).
template <bool kStream, int W, typename T>
__device__ __forceinline__ void load_wide(const T* __restrict__ src,
                                          T (&dst)[W]) {
  constexpr int kBytes = W * sizeof(T) < 16 ? W * sizeof(T) : 16;
  constexpr int kPer = kBytes / sizeof(T);
  using R = typename RawOf<kBytes>::type;
#pragma unroll
  for (int c = 0; c < W; c += kPer) {
    const R* s = reinterpret_cast<const R*>(src + c);
    const R r = kStream ? __ldcs(s) : __ldg(s);
    memcpy(&dst[c], &r, kBytes);
  }
}

template <int W, typename T>
__device__ __forceinline__ void store_wide(T* __restrict__ dst,
                                           const T (&src)[W]) {
  constexpr int kBytes = W * sizeof(T) < 16 ? W * sizeof(T) : 16;
  constexpr int kPer = kBytes / sizeof(T);
  using R = typename RawOf<kBytes>::type;
#pragma unroll
  for (int c = 0; c < W; c += kPer) {
    R r;
    memcpy(&r, &src[c], kBytes);
    *reinterpret_cast<R*>(dst + c) = r;
  }
}

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
  constexpr int JB = batch_cols<TD, NB, W>();
  const int64_t p0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * W;
  if (p0 >= P) return;
  TV acc[NB][W];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
#pragma unroll
    for (int w = 0; w < W; ++w) acc[i][w] = TV(0);
  }
  for (int k = 0; k < n_off; ++k) {
    const int off = __ldg(offsets + k);
    const int64_t q0 = halo + p0 + off;  // x's column of lane p0
    // with ldx % W == 0 a window at a multiple of W lies wholly inside or
    // wholly outside [0, ldx)
    const bool x_al = off % W == 0;
    const bool x_in = q0 >= 0 && q0 < ldx;
    const TD* slab = data + static_cast<int64_t>(k) * NB * P + p0;
#pragma unroll
    for (int j0 = 0; j0 < NB; j0 += JB) {
      // the batch's band segments, rows (i, k, j), all loaded first
      TD a[JB][NB][W];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          if (j0 + jj < NB) {
            load_wide<true, W>(
                slab + (static_cast<int64_t>(i) * R_pad + j0 + jj) * P,
                a[jj][i]);
          }
        }
      }
      // then x[j, q0 .. q0 + W): wide where aligned, else lane by lane
      TV xv[JB][W];
      if (x_al) {
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          if (j0 + jj >= NB) continue;
          if (x_in) {
            load_wide<false, W>(x + static_cast<int64_t>(j0 + jj) * ldx + q0,
                                xv[jj]);
          } else {
#pragma unroll
            for (int w = 0; w < W; ++w) xv[jj][w] = TV(0);
          }
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          if (j0 + jj >= NB) continue;
          const TV* xr = x + static_cast<int64_t>(j0 + jj) * ldx + q0;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const int64_t q = q0 + w;
            xv[jj][w] = q >= 0 && q < ldx ? __ldg(xr + w) : TV(0);
          }
        }
      }
      // each row sums over k, then j, as K1 and the plain version do
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        if (j0 + jj >= NB) continue;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            acc[i][w] += as<TV>(a[jj][i][w]) * xv[jj][w];
          }
        }
      }
    }
  }
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

// ---- K0 ------------------------------------------------------------------

// K0's accumulator: f64 for f64 data, f32 otherwise
template <typename TD>
struct AccOf {
  using type = float;
};

template <>
struct AccOf<double> {
  using type = double;
};

template <typename TD, typename TV>
__global__ void __launch_bounds__(kOmajorThreads)
    banded_omajor_kernel(const TD* __restrict__ data,
                         const TV* __restrict__ x,
                         const int* __restrict__ offsets, int n_off, int nb,
                         int64_t P, const TV* __restrict__ b,
                         const TV* __restrict__ d,
                         const TV* __restrict__ dinv, double c1, double c2,
                         int mode, TV* __restrict__ out0,
                         TV* __restrict__ out1) {
  using TA = typename AccOf<TD>::type;
  extern __shared__ int s_off[];
  for (int k = threadIdx.x; k < n_off; k += blockDim.x) {
    s_off[k] = offsets[k];
  }
  __syncthreads();
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= P) return;
  const int i = blockIdx.y;
  TA acc = TA(0);
  for (int o = 0; o < n_off; ++o) {
    const int64_t q = p + s_off[o];
    if (q < 0 || q >= P) continue;  // x is zero outside [0, P)
    const TD* rows = data + (static_cast<int64_t>(o) * nb + i) * nb * P + p;
    for (int j = 0; j < nb; ++j) {
      acc += load_as<TA>(rows + static_cast<int64_t>(j) * P) *
             static_cast<TA>(x[static_cast<int64_t>(j) * P + q]);
    }
  }
  const int64_t idx = static_cast<int64_t>(i) * P + p;
  const TV y = static_cast<TV>(acc);
  if (mode == PRODUCT) {
    out0[idx] = y;
    return;
  }
  const TV r = b[idx] - y;
  if (mode == RESIDUAL) {
    out0[idx] = r;
    return;
  }
  // the recurrence scalars act in the vector type, as in the plain version
  TV dn = static_cast<TV>(c2) * (dinv[idx] * r);
  if (mode == STEP) dn = static_cast<TV>(c1) * d[idx] + dn;
  out0[idx] = x[idx] + dn;
  out1[idx] = dn;
}

inline unsigned int n_blocks(int64_t n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TD, typename TV>
int launch_matvec(const void* data, const void* x, const int* offsets,
                  int n_off, int nb, int R_pad, int64_t P, int64_t ldx,
                  int64_t halo, void* y, cudaStream_t s) {
  banded_matvec_imajor_kernel<TD, TV><<<n_blocks(P, kThreads), kThreads, 0,
                                        s>>>(
      static_cast<const TD*>(data), static_cast<const TV*>(x), offsets, n_off,
      nb, R_pad, P, ldx, halo, static_cast<TV*>(y));
  return static_cast<int>(cudaGetLastError());
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
  switch (nb) {  // nb = (p + dim choose dim) for dim 2-3, p 1-3
#define PD_NB(N)                                                          \
  case N:                                                                 \
    return launch_fused_nb<TD, TV, N>(data, x, offsets, n_off, R_pad, P,  \
                                      ldx, halo, b, d, dinv, c1, c2,      \
                                      mode, out0, out1, s);
    PD_NB(3)
    PD_NB(4)
    PD_NB(6)
    PD_NB(10)
    PD_NB(20)
#undef PD_NB
  }
  return -2;
}

template <typename TD, typename TV>
int launch_omajor(const void* data, const void* x, const int* offsets,
                  int n_off, int nb, int64_t P, const void* b, const void* d,
                  const void* dinv, double c1, double c2, int mode,
                  void* out0, void* out1, cudaStream_t s) {
  const dim3 grid(n_blocks(P, kOmajorThreads), static_cast<unsigned int>(nb));
  const size_t smem = static_cast<size_t>(n_off) * sizeof(int);
  banded_omajor_kernel<TD, TV><<<grid, kOmajorThreads, smem, s>>>(
      static_cast<const TD*>(data), static_cast<const TV*>(x), offsets, n_off,
      nb, P, static_cast<const TV*>(b), static_cast<const TV*>(d),
      static_cast<const TV*>(dinv), c1, c2, mode, static_cast<TV*>(out0),
      static_cast<TV*>(out1));
  return static_cast<int>(cudaGetLastError());
}

// Calls F<TD, TV>(args...) for the supported (data, vector) dtype pairs.
#define PD_DISPATCH(F, data_dt, vec_dt, ...)                             \
  if (vec_dt == F32) {                                                   \
    if (data_dt == F32) return F<float, float>(__VA_ARGS__);             \
    if (data_dt == BF16) return F<__nv_bfloat16, float>(__VA_ARGS__);    \
  } else if (vec_dt == F64) {                                            \
    if (data_dt == F64) return F<double, double>(__VA_ARGS__);           \
    if (data_dt == F32) return F<float, double>(__VA_ARGS__);            \
    if (data_dt == BF16) return F<__nv_bfloat16, double>(__VA_ARGS__);   \
  }                                                                      \
  return -1

}  // namespace

extern "C" int pd_banded_matvec(const void* data, int data_dt, const void* x,
                                int vec_dt, const int* offsets, int n_off,
                                int nb, int R_pad, long long P, void* y,
                                void* stream) {
  PD_DISPATCH(launch_matvec, data_dt, vec_dt, data, x, offsets, n_off, nb,
              R_pad, static_cast<int64_t>(P), static_cast<int64_t>(P), 0, y,
              static_cast<cudaStream_t>(stream));
}

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

// The halo entries: K1 and K2 on a shard's slab, x_ext [nb, ldx] with
// ldx = P + 2 halo, lane p reading column halo + p + off.
extern "C" int pd_banded_matvec_halo(const void* data, int data_dt,
                                     const void* x, int vec_dt,
                                     const int* offsets, int n_off, int nb,
                                     int R_pad, long long P, long long ldx,
                                     long long halo, void* y, void* stream) {
  PD_DISPATCH(launch_matvec, data_dt, vec_dt, data, x, offsets, n_off, nb,
              R_pad, static_cast<int64_t>(P), static_cast<int64_t>(ldx),
              static_cast<int64_t>(halo), y,
              static_cast<cudaStream_t>(stream));
}

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

extern "C" int pd_banded_matvec_omajor(const void* data, int data_dt,
                                       const void* x, int vec_dt,
                                       const int* offsets, int n_off, int nb,
                                       long long P, void* y, void* stream) {
  PD_DISPATCH(launch_omajor, data_dt, vec_dt, data, x, offsets, n_off, nb,
              static_cast<int64_t>(P), nullptr, nullptr, nullptr, 0.0, 0.0,
              PRODUCT, y, nullptr, static_cast<cudaStream_t>(stream));
}

extern "C" int pd_banded_fused_omajor(const void* data, int data_dt,
                                      const void* x, int vec_dt,
                                      const int* offsets, int n_off, int nb,
                                      long long P, const void* b,
                                      const void* d, const void* dinv,
                                      double c1, double c2, int mode,
                                      void* out0, void* out1, void* stream) {
  if (mode < RESIDUAL || mode > STEP) return -3;
  PD_DISPATCH(launch_omajor, data_dt, vec_dt, data, x, offsets, n_off, nb,
              static_cast<int64_t>(P), b, d, dinv, c1, c2, mode, out0, out1,
              static_cast<cudaStream_t>(stream));
}
