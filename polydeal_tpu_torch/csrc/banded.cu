// Banded block SpMV (K1) and fused Chebyshev step / residual (K2) for
// Hopper (sm_90a), over the i-major band layout of BlockBanded.data_i;
// and the o-major banded SpMV (K0) over BlockBanded.data.
//
// Replaces the TPU Pallas kernels
//   K1  polydeal_tpu/ops/banded.py      _banded_matvec_imajor_impl
//   K2  polydeal_tpu/ops/fused_cheb.py  _banded_fused_impl
//   K0  polydeal_tpu/ops/banded.py      _banded_matvec_impl
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
// What bounds it: memory.  Each call streams the band once,
// nb * n_off * nb * P elements (117 MB in f32 at the flagship fine level:
// nb=4, n_off=7, P=262144), against 2*nb*n_off*nb*P flops -- well under
// one flop per byte.  The design does only what that needs: one thread per
// lane p, so every load of data_i[row, p] and of x[j, p+off] is coalesced
// along p across a warp, and the band is read exactly once.  x is re-read
// nb times per row (once per output row i); it is nb*P elements (4 MB at
// the fine level) and stays in L2.  The TPU mechanics (lane tiles, funnel
// shifts, padded x and pre-rolled far copies, SMEM scalars) have no
// counterpart: a shifted window is a bounds-checked load.  K2 is K1's loop
// with the smoother update in the epilogue, so the smoother's vectors are
// read once and y never goes to device memory.
//
// Types: data bf16, f32 or f64; vectors f32 or f64.  Accumulation runs in
// the vector type (f64 for an f64 solve).  Row offsets use 64-bit
// arithmetic (row * P exceeds 2^31 beyond ~1.6e7 lanes x rows).
//
// K0, the o-major layout: data [n_off, nb, nb, P], element (o, i, j, p) at
// ((o*nb + i)*nb + j)*P + p, multiplies x[j, p + off_o];
//   y[i,p] = sum_o sum_j data[o,i,j,p] * x[j, p+off_o], x zero outside [0,P).
// Accumulation follows the Pallas kernel's contract: f32 for bf16 or f32
// data, f64 for f64 data; y is written in the vector type.  Bound by memory
// like K1 (the band is read once), but the path that runs it is the small
// multigrid levels (64 to 4,096 lanes), where one thread per lane would
// leave the card nearly empty (16 blocks at 4,096 lanes).  So each thread
// computes one output (i, p): a grid of (lane blocks, nb), nb times the
// threads of K1, each reading its own nb*n_off band elements once, coalesced
// along p, and x[j, p+off_o] through a bounds-checked load (a far offset is
// one more load, served by L1/L2).  The offset table is staged in shared
// memory.  The Pallas kernel's lane tiles, halo padding, funnel shifts and
// x resident in VMEM have no counterpart.
//
// Plain C interface for ctypes (built by polydeal_tpu_torch/ops/_build.py):
// each entry point launches on the given stream and returns
// cudaGetLastError() (0 on success), or -1 for an unsupported dtype pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { F32 = 0, F64 = 1, BF16 = 2 };
enum Mode { RESIDUAL = 0, STEP0 = 1, STEP = 2 };

constexpr int kThreads = 256;

template <typename TV, typename TD>
__device__ __forceinline__ TV load_as(const TD* p) {
  return static_cast<TV>(*p);
}

template <>
__device__ __forceinline__ float load_as<float, __nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <>
__device__ __forceinline__ double load_as<double, __nv_bfloat16>(
    const __nv_bfloat16* p) {
  return static_cast<double>(__bfloat162float(*p));
}

// y[i, p] for one output row i and one lane p.
template <typename TD, typename TV>
__device__ __forceinline__ TV band_row(const TD* __restrict__ data,
                                       const TV* __restrict__ x,
                                       const int* __restrict__ offsets,
                                       int n_off, int nb, int R_pad,
                                       int64_t P, int i, int64_t p) {
  TV acc = TV(0);
  const TD* slab = data + static_cast<int64_t>(i) * R_pad * P + p;
  for (int k = 0; k < n_off; ++k) {
    const int64_t q = p + __ldg(offsets + k);
    if (q < 0 || q >= P) continue;  // x is zero outside [0, P)
    const TD* rows = slab + static_cast<int64_t>(k) * nb * P;
    for (int j = 0; j < nb; ++j) {
      acc += load_as<TV>(rows + static_cast<int64_t>(j) * P) *
             x[static_cast<int64_t>(j) * P + q];
    }
  }
  return acc;
}

template <typename TD, typename TV>
__global__ void __launch_bounds__(kThreads)
    banded_matvec_imajor_kernel(const TD* __restrict__ data,
                                const TV* __restrict__ x,
                                const int* __restrict__ offsets, int n_off,
                                int nb, int R_pad, int64_t P,
                                TV* __restrict__ y) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= P) return;
  for (int i = 0; i < nb; ++i) {
    y[static_cast<int64_t>(i) * P + p] =
        band_row(data, x, offsets, n_off, nb, R_pad, P, i, p);
  }
}

template <typename TD, typename TV>
__global__ void __launch_bounds__(kThreads)
    banded_fused_kernel(const TD* __restrict__ data,
                        const TV* __restrict__ x,
                        const int* __restrict__ offsets, int n_off, int nb,
                        int R_pad, int64_t P, const TV* __restrict__ b,
                        const TV* __restrict__ d, const TV* __restrict__ dinv,
                        double c1, double c2, int mode,
                        TV* __restrict__ out0, TV* __restrict__ out1) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= P) return;
  // the recurrence scalars act in the vector type, as in the plain version
  const TV c1v = static_cast<TV>(c1);
  const TV c2v = static_cast<TV>(c2);
  for (int i = 0; i < nb; ++i) {
    const int64_t idx = static_cast<int64_t>(i) * P + p;
    const TV y = band_row(data, x, offsets, n_off, nb, R_pad, P, i, p);
    const TV r = b[idx] - y;
    if (mode == RESIDUAL) {
      out0[idx] = r;
      continue;
    }
    TV dn = c2v * (dinv[idx] * r);
    if (mode == STEP) dn = c1v * d[idx] + dn;
    out0[idx] = x[idx] + dn;
    out1[idx] = dn;
  }
}

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
__global__ void __launch_bounds__(kThreads)
    banded_matvec_omajor_kernel(const TD* __restrict__ data,
                                const TV* __restrict__ x,
                                const int* __restrict__ offsets, int n_off,
                                int nb, int64_t P, TV* __restrict__ y) {
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
  y[static_cast<int64_t>(i) * P + p] = static_cast<TV>(acc);
}

inline unsigned int n_blocks(int64_t P) {
  return static_cast<unsigned int>((P + kThreads - 1) / kThreads);
}

template <typename TD, typename TV>
int launch_matvec(const void* data, const void* x, const int* offsets,
                  int n_off, int nb, int R_pad, int64_t P, void* y,
                  cudaStream_t s) {
  banded_matvec_imajor_kernel<TD, TV><<<n_blocks(P), kThreads, 0, s>>>(
      static_cast<const TD*>(data), static_cast<const TV*>(x), offsets, n_off,
      nb, R_pad, P, static_cast<TV*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TV>
int launch_fused(const void* data, const void* x, const int* offsets,
                 int n_off, int nb, int R_pad, int64_t P, const void* b,
                 const void* d, const void* dinv, double c1, double c2,
                 int mode, void* out0, void* out1, cudaStream_t s) {
  banded_fused_kernel<TD, TV><<<n_blocks(P), kThreads, 0, s>>>(
      static_cast<const TD*>(data), static_cast<const TV*>(x), offsets, n_off,
      nb, R_pad, P, static_cast<const TV*>(b), static_cast<const TV*>(d),
      static_cast<const TV*>(dinv), c1, c2, mode, static_cast<TV*>(out0),
      static_cast<TV*>(out1));
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TV>
int launch_omajor(const void* data, const void* x, const int* offsets,
                  int n_off, int nb, int64_t P, void* y, cudaStream_t s) {
  const dim3 grid(n_blocks(P), static_cast<unsigned int>(nb));
  const size_t smem = static_cast<size_t>(n_off) * sizeof(int);
  banded_matvec_omajor_kernel<TD, TV><<<grid, kThreads, smem, s>>>(
      static_cast<const TD*>(data), static_cast<const TV*>(x), offsets, n_off,
      nb, P, static_cast<TV*>(y));
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
              R_pad, static_cast<int64_t>(P), y,
              static_cast<cudaStream_t>(stream));
}

extern "C" int pd_banded_matvec_omajor(const void* data, int data_dt,
                                       const void* x, int vec_dt,
                                       const int* offsets, int n_off, int nb,
                                       long long P, void* y, void* stream) {
  PD_DISPATCH(launch_omajor, data_dt, vec_dt, data, x, offsets, n_off, nb,
              static_cast<int64_t>(P), y, static_cast<cudaStream_t>(stream));
}

extern "C" int pd_banded_fused(const void* data, int data_dt, const void* x,
                               int vec_dt, const int* offsets, int n_off,
                               int nb, int R_pad, long long P, const void* b,
                               const void* d, const void* dinv, double c1,
                               double c2, int mode, void* out0, void* out1,
                               void* stream) {
  PD_DISPATCH(launch_fused, data_dt, vec_dt, data, x, offsets, n_off, nb,
              R_pad, static_cast<int64_t>(P), b, d, dinv, c1, c2, mode, out0,
              out1, static_cast<cudaStream_t>(stream));
}
