// K0, the o-major banded SpMV, plain or fused with the Chebyshev step /
// residual, for Hopper (sm_90a), over BlockBanded.data.
//
// Replaces the TPU Pallas kernel
//   K0  polydeal_tpu/ops/banded.py  _banded_matvec_impl
// and, fused, computes K2's function (polydeal_tpu/ops/fused_cheb.py
// _banded_fused_impl) on the o-major layout, where the JAX package runs
// the product and the update unfused.
//
// Layout: data [n_off, nb, nb, P], element (o, i, j, p) at
// ((o*nb + i)*nb + j)*P + p, multiplies x[j, p + off_o];
//   y[i,p] = sum_o sum_j data[o,i,j,p] * x[j, p+off_o], x zero outside [0,P),
// then, fused, csrc/banded.cu's modes on y:
//   step0:  d' = c2 * dinv * (b - y);          x' = x + d'
//   step:   d' = c1 * d + c2 * dinv * (b - y); x' = x + d'
//   resid:  r  = b - y
// Accumulation follows the Pallas kernel's contract: f32 for bf16 or f32
// data, f64 for f64 data (x converted to it); y enters the update in the
// vector type, as in the plain version.
//
// What bounds it.  K0 serves every banded level without the i-major copy:
// the levels under 32768 lanes, the coupled models' field blocks and the
// COO path's bands.  Most are small (the coupled 1024-lane fine bands,
// 0.4-6 MB; the 4096-lane levels, 2-13 MB) and stay in L2 across the
// replays of a captured solve: a launch there takes microseconds, and what
// bounds it is the chain of dependent memory round trips each thread
// waits for, on a grid of a few thousand threads.  The first kernel (one
// output a thread, loops over a runtime nb and n_off) issued its loads a
// few at a time: 6 us on the oseen nb=6 band against a 0.5 us byte bound.
// The largest (nb 15-35 at 4096-16384 lanes, 20-140 MB) are bound by
// bytes, as K2 is.
//
// Design.  One thread computes one output (i, p), lanes along threadIdx.x,
// so every band and vector access coalesces along p; it sums o ascending,
// then j ascending, one FMA a product: the order and rounding of the first
// kernel's loop, so the bits are the same.  By the plan's path:
// * BATCHED (banded_batched_omajor_kernel), at nb in K0_NB (3, 4, 6, 8,
//   12, 15, 21) on a band of few outputs nb P (ops/banded.K0_WIDE_OUTPUTS),
//   bound by round trips: a build with nb a compile-time constant issues
//   its epilogue's loads (b, d, dinv and x at (i, p)) first, so that they
//   arrive during the product, and takes the offsets in batches of OB
//   (kBatchRegs registers of loaded values, at most kMaxBatch offsets),
//   every band and x load of a batch issued before its first FMA, so that
//   a batch costs one round trip: the coupled 1024-lane bands load every
//   offset in one batch (nb 3, 6) or in three (nb 12).  An offset past
//   n_off or a column outside [0, P) loads nothing (predicated loads) and
//   adds fma(0, 0, acc), which leaves the sum as it is.  Blocks of 32 to
//   kMaxThreads lanes spread a 1024-lane band over the card (nb = 6: 192
//   blocks of 32);
// * LOOP (banded_omajor_kernel), on a band of many outputs (bound by
//   bytes) and at any other nb (27, 35: TensorDGQ Q2, P_4): the first
//   kernel, unchanged (the offset table staged in shared memory, runtime
//   loops over o and j).  Many light threads keep the loads of a large
//   band in flight: a BATCHED launch there, at 128-168 registers a
//   thread, read up to ~40% slower on the 2D monodomain's 16384-lane
//   level, and re-expressions of the loop 5-50% slower than the loop
//   itself (tools/profile_k0.py).
// The plan (path, threads a block, offsets a batch) is ops/banded.
// omajor_plan's, which every launch passes; the grid is (lane blocks of
// threads, nb).
//
// Plain C interface for ctypes (built by polydeal_tpu_torch/ops/_build.py):
// each entry launches on the given stream and returns cudaGetLastError() (0
// on success), -1 for an unsupported dtype pair, -2 for a plan this library
// cannot run (BATCHED at an nb without its build or with another batch
// than its build's, LOOP with a batch other than 1, threads not a power of
// two in [32, kMaxThreads]), -3 for an unknown mode or -4 for nb < 1.
// pd_empty_kernel launches a kernel that does nothing, on the grid a K0
// launch takes: the launch floor beside K0's byte bound.

#include "banded_common.cuh"

namespace {

// RESIDUAL, STEP0 and STEP are the fused modes (csrc/banded.cu's enum);
// PRODUCT is the plain y = A x
enum Mode { RESIDUAL = 0, STEP0 = 1, STEP = 2, PRODUCT = 3 };

// the plan's paths
enum Path { LOOP = 0, BATCHED = 1 };

// registers of loaded values a batch (160 and 192 read oseen's nb = 6
// band 2-5% and the 2D monodomain's nb = 15 levels 5-30% slower)
constexpr int kBatchRegs = 128;
constexpr int kMaxBatch = 8;  // offsets a batch at most
constexpr int kMaxThreads = 128;
constexpr int kMinThreads = 32;

// K0's accumulator: f64 for f64 data, f32 otherwise
template <typename TD>
struct AccOf {
  using type = float;
};

template <>
struct AccOf<double> {
  using type = double;
};

// registers one (band entry, x value) pair of a batch takes
template <typename TD>
__host__ __device__ constexpr int pair_regs() {
  return sizeof(TD) == 8 ? 4 : 2;
}

// offsets a batch of the build at nb
template <typename TD>
__host__ __device__ constexpr int offset_batch(int nb) {
  const int ob = kBatchRegs / (nb * pair_regs<TD>());
  return ob < 1 ? 1 : (ob > kMaxBatch ? kMaxBatch : ob);
}

// acc += sum over o, then j, of data[o,i,j,p] x[j,p+off_o] at nb = NB:
// the offsets in batches of OB, every load of a batch (predicated: an
// offset past n_off or a column outside [0, P) loads nothing) ahead of its
// first FMA, which adds fma(0, 0, acc) for such a slot
template <typename TD, typename TV, int NB>
__device__ __forceinline__ void sum_batched(
    const TD* __restrict__ data, const TV* __restrict__ x,
    const int* __restrict__ offsets, int n_off, int64_t P, int i, int64_t p,
    typename AccOf<TD>::type& acc) {
  using TA = typename AccOf<TD>::type;
  constexpr int OB = offset_batch<TD>(NB);
  const TD* row = data + static_cast<int64_t>(i) * NB * P + p;
  const int64_t o_stride = static_cast<int64_t>(NB) * NB * P;
  for (int o0 = 0; o0 < n_off; o0 += OB) {
    TD a[OB][NB];
    TA xa[OB][NB];
    bool in[OB];
#pragma unroll
    for (int t = 0; t < OB; ++t) {
      const bool live = o0 + t < n_off;
      const int64_t q = p + (live ? offsets[o0 + t] : 0);
      in[t] = live && q >= 0 && q < P;
      const TD* ro = row + static_cast<int64_t>(o0 + t) * o_stride;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        a[t][j] = live ? ro[static_cast<int64_t>(j) * P] : TD(0.0f);
        xa[t][j] =
            in[t] ? static_cast<TA>(x[static_cast<int64_t>(j) * P + q])
                  : TA(0);
      }
    }
#pragma unroll
    for (int t = 0; t < OB; ++t) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        acc = fma(in[t] ? as<TA>(a[t][j]) : TA(0), xa[t][j], acc);
      }
    }
  }
}

// BATCHED: one output (i, p) a thread, i = blockIdx.y, at nb = NB
template <typename TD, typename TV, int NB>
__global__ void __launch_bounds__(kMaxThreads)
    banded_batched_omajor_kernel(
        const TD* __restrict__ data, const TV* __restrict__ x,
        const int* __restrict__ offsets, int n_off, int64_t P,
        const TV* __restrict__ b, const TV* __restrict__ d,
        const TV* __restrict__ dinv, double c1, double c2, int mode,
        TV* __restrict__ out0, TV* __restrict__ out1) {
  using TA = typename AccOf<TD>::type;
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int i = blockIdx.y;
  const int64_t idx = static_cast<int64_t>(i) * P + p;
  // the epilogue's operands first: in flight during the product
  TV bv = TV(0), dv = TV(0), iv = TV(0), xv = TV(0);
  if (mode != PRODUCT) bv = b[idx];
  if (mode == STEP0 || mode == STEP) {
    iv = dinv[idx];
    xv = x[idx];
  }
  if (mode == STEP) dv = d[idx];
  TA acc = TA(0);
  sum_batched<TD, TV, NB>(data, x, offsets, n_off, P, i, p, acc);
  const TV y = static_cast<TV>(acc);
  if (mode == PRODUCT) {
    out0[idx] = y;
    return;
  }
  const TV r = bv - y;
  if (mode == RESIDUAL) {
    out0[idx] = r;
    return;
  }
  // the recurrence scalars act in the vector type, as in the plain version
  TV dn = static_cast<TV>(c2) * (iv * r);
  if (mode == STEP) dn = static_cast<TV>(c1) * dv + dn;
  out0[idx] = xv + dn;
  out1[idx] = dn;
}

// LOOP: the first kernel.  One thread per output (i, p): a grid of (lane
// blocks, nb), the offset table staged in shared memory,
// runtime loops over o and j, x[j, p + off_o] through a bounds-checked
// offset.
template <typename TD, typename TV>
__global__ void __launch_bounds__(kMaxThreads)
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

__global__ void empty_kernel() {}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// the nb with a specialised build (ops/banded.K0_NB)
inline bool specialised(int nb) {
  switch (nb) {
    case 3: case 4: case 6: case 8: case 12: case 15: case 21:
      return true;
    default:
      return false;
  }
}

// whether this library runs the plan (path, threads, batch) at nb
template <typename TD>
bool runs(int nb, int path, int threads, int batch) {
  if (threads < kMinThreads || threads > kMaxThreads ||
      (threads & (threads - 1)) != 0) {
    return false;
  }
  if (path == LOOP) return batch == 1;
  return path == BATCHED && specialised(nb) && batch == offset_batch<TD>(nb);
}

template <typename TD, typename TV, int NB>
int launch_batched(dim3 grid, int threads, const void* data, const void* x,
                   const int* offsets, int n_off, int64_t P, const void* b,
                   const void* d, const void* dinv, double c1, double c2,
                   int mode, void* out0, void* out1, cudaStream_t s) {
  banded_batched_omajor_kernel<TD, TV, NB>
      <<<grid, threads, 0, s>>>(
          static_cast<const TD*>(data), static_cast<const TV*>(x), offsets,
          n_off, P, static_cast<const TV*>(b), static_cast<const TV*>(d),
          static_cast<const TV*>(dinv), c1, c2, mode, static_cast<TV*>(out0),
          static_cast<TV*>(out1));
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TV>
int launch_loop(dim3 grid, int threads, const void* data, const void* x,
                const int* offsets, int n_off, int nb, int64_t P,
                const void* b, const void* d, const void* dinv, double c1,
                double c2, int mode, void* out0, void* out1,
                cudaStream_t s) {
  const size_t smem = static_cast<size_t>(n_off) * sizeof(int);
  banded_omajor_kernel<TD, TV><<<grid, threads, smem, s>>>(
      static_cast<const TD*>(data), static_cast<const TV*>(x), offsets, n_off,
      nb, P, static_cast<const TV*>(b), static_cast<const TV*>(d),
      static_cast<const TV*>(dinv), c1, c2, mode, static_cast<TV*>(out0),
      static_cast<TV*>(out1));
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TV>
int launch(const void* data, const void* x, const int* offsets, int n_off,
           int nb, int64_t P, int path, int threads, int batch,
           const void* b, const void* d, const void* dinv, double c1,
           double c2, int mode, void* out0, void* out1, cudaStream_t s) {
  if (mode < RESIDUAL || mode > PRODUCT) return -3;
  if (nb < 1) return -4;
  if (!runs<TD>(nb, path, threads, batch)) return -2;
  if (P <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(static_cast<unsigned>(cdiv(P, threads)),
                  static_cast<unsigned>(nb));
#define PD_K0_CASE(N)                                                    \
  case N:                                                                \
    return launch_batched<TD, TV, N>(grid, threads, data, x, offsets,    \
                                     n_off, P, b, d, dinv, c1, c2, mode, \
                                     out0, out1, s);
  if (path == BATCHED) {
    switch (nb) {
      PD_K0_CASE(3)
      PD_K0_CASE(4)
      PD_K0_CASE(6)
      PD_K0_CASE(8)
      PD_K0_CASE(12)
      PD_K0_CASE(15)
      PD_K0_CASE(21)
    }
  }
#undef PD_K0_CASE
  return launch_loop<TD, TV>(grid, threads, data, x, offsets, n_off, nb, P,
                             b, d, dinv, c1, c2, mode, out0, out1, s);
}

}  // namespace

// path, threads, batch: the launch's plan (ops/banded.omajor_plan)
extern "C" int pd_banded_matvec_omajor(const void* data, int data_dt,
                                       const void* x, int vec_dt,
                                       const int* offsets, int n_off, int nb,
                                       long long P, int path, int threads,
                                       int batch, void* y, void* stream) {
  PD_DISPATCH(launch, data_dt, vec_dt, data, x, offsets, n_off, nb,
              static_cast<int64_t>(P), path, threads, batch, nullptr,
              nullptr, nullptr, 0.0, 0.0, PRODUCT, y, nullptr,
              static_cast<cudaStream_t>(stream));
}

extern "C" int pd_banded_fused_omajor(const void* data, int data_dt,
                                      const void* x, int vec_dt,
                                      const int* offsets, int n_off, int nb,
                                      long long P, int path, int threads,
                                      int batch, const void* b,
                                      const void* d, const void* dinv,
                                      double c1, double c2, int mode,
                                      void* out0, void* out1, void* stream) {
  if (mode < RESIDUAL || mode > STEP) return -3;
  PD_DISPATCH(launch, data_dt, vec_dt, data, x, offsets, n_off, nb,
              static_cast<int64_t>(P), path, threads, batch, b, d, dinv, c1,
              c2, mode, out0, out1, static_cast<cudaStream_t>(stream));
}

extern "C" int pd_empty_kernel(long long blocks, int threads, void* stream) {
  empty_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
