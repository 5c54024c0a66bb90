// What the i-major band kernels share: K1 (csrc/banded_matvec.cu) and K2
// (csrc/banded.cu) read the same layout through the same register-blocked
// product loop, and K0 and K6/K7 (csrc/packed_common.cuh) the same
// conversions.
//
// Layout (shared with the JAX package, so one array feeds either):
//   data_i [nb * R_pad, P], row i*R_pad + k*nb + j multiplies x[j, p + off_k];
//   rows k*nb + j >= n_off*nb of each i-slab are padding and never read.
//   x is [nb, ldx]: lane p's column for offset o is halo + p + o, zero
//   outside [0, ldx) (the unsharded entries pass ldx = P, halo = 0).
//
// The product loop (band_accumulate): each thread owns W adjacent lanes
// from p0 and all NB output rows, W accumulators a row in registers.  It
// runs k, j outer and i inner, so each x[j, p0+off_k .. +W) is loaded once
// a thread and feeds all NB rows; each band row segment is one 16-byte
// load (W = 8 bf16, 4 f32 or 2 f64 lanes; fewer where NB*W accumulators
// would outgrow ~96 registers) with the streaming cache hint.  The band
// segments of a batch of columns j (up to 256 bytes a thread: all of an
// offset's at nb=4) are loaded with no test in between, so all are in
// flight before the first is used (a branch between two loads holds the
// second back until the first is consumed).  x at p0+off_k is a wide load
// where off_k is a multiple of W (the window then lies wholly inside or
// outside x's row, one test an offset) and a bounds-checked scalar load
// otherwise.  Each row sums over k, then j, in order.  The caller
// guarantees, for W > 1, that P, ldx and halo are multiples of W and that
// the operands are 16-byte aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

enum DType { F32 = 0, F64 = 1, BF16 = 2 };

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

// the store of an f32 sum into a bf16 output: rounded to nearest even, as
// torch's .to(torch.bfloat16)
template <>
__device__ __forceinline__ __nv_bfloat16 as<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TV, typename TD>
__device__ __forceinline__ TV load_as(const TD* p) {
  return as<TV>(*p);
}

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

// Lanes per thread of the wide path: one 16-byte band load per row, halved
// while the nb*W accumulators would take more than ~96 registers.
template <typename TD, typename TV, int NB>
__host__ __device__ constexpr int wide_lanes() {
  int w = 16 / static_cast<int>(sizeof(TD));
  while (w > 1 && NB * w * static_cast<int>(sizeof(TV)) > 96 * 4) w /= 2;
  return w;
}

// Columns j per load batch: the batch's band segments (all nb rows) take at
// most 256 bytes a thread as loaded, so every load of a batch is in flight
// before its first use, and at most 512 bytes (128 registers) converted to
// the accumulator type (this binds for bf16 bands with f64 vectors only).
template <typename TD, typename TV, int NB, int W>
__host__ __device__ constexpr int batch_cols() {
  int jb = 256 / (NB * W * static_cast<int>(sizeof(TD)));
  const int jv = 512 / (NB * W * static_cast<int>(sizeof(TV)));
  if (jv < jb) jb = jv;
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

// acc[i][w] += sum over k in [k_begin, k_end), then j, of
// data_i[i*R_pad + k*NB + j, p0 + w] * x[j, halo + p0 + w + off_k].
template <typename TD, typename TV, int NB, int W>
__device__ __forceinline__ void band_accumulate(
    const TD* __restrict__ data, const TV* __restrict__ x,
    const int* __restrict__ offsets, int k_begin, int k_end, int R_pad,
    int64_t P, int64_t ldx, int64_t halo, int64_t p0, TV (&acc)[NB][W]) {
  constexpr int JB = batch_cols<TD, TV, NB, W>();
  // the offset's batches are unrolled up to 10 (every nb but 20): beyond,
  // ptxas hoists later batches' loads and spills
  constexpr int kBatches = (NB + JB - 1) / JB;
  constexpr int kUnroll = kBatches <= 10 ? kBatches : 1;
  for (int k = k_begin; k < k_end; ++k) {
    const int off = __ldg(offsets + k);
    const int64_t q0 = halo + p0 + off;  // x's column of lane p0
    // with ldx % W == 0 a window at a multiple of W lies wholly inside or
    // wholly outside [0, ldx)
    const bool x_al = off % W == 0;
    const bool x_in = q0 >= 0 && q0 < ldx;
    const TD* slab = data + static_cast<int64_t>(k) * NB * P + p0;
#pragma unroll(kUnroll)
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
}

inline unsigned int n_blocks(int64_t n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Calls F<TD, TV>(args...) for the supported (data, vector) dtype pairs;
// -1 for any other.
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

// K1 and K2 at a runtime nb (csrc/banded_any_nb.cu), for every (data,
// vector) dtype pair of PD_DISPATCH: what PD_NB_DISPATCH calls for an nb
// without a specialised build.  Their arguments are those of the
// specialised launch, plan and fused-launch functions, nb first.
namespace pd_any_nb {

template <typename TD, typename TV>
int matvec(int nb, const void* data, const void* x, const int* offsets,
           int n_off, int R_pad, int64_t P, int64_t ldx, int64_t halo,
           void* y, cudaStream_t st);

template <typename TD, typename TV>
int fused(int nb, const void* data, const void* x, const int* offsets,
          int n_off, int R_pad, int64_t P, int64_t ldx, int64_t halo,
          const void* b, const void* d, const void* dinv, double c1,
          double c2, int mode, void* out0, void* out1, cudaStream_t st);

// plan[0..6] = W, S, threads a block, blocks, shared bytes, rows a thread
// R, row chunks a block
template <typename TD, typename TV>
int plan(int nb, const void* data, const void* x, const void* y, int n_off,
         int64_t P, int64_t ldx, int64_t halo, long long* out);

}  // namespace pd_any_nb

// Calls F<TD, TV, NB>(args...) for the block sizes K1 and K2 have a
// specialised build for, nb = (p + dim choose dim) for dim 2-3, p 1-3, and
// the runtime-nb build G<TD, TV>(nb, args...) for any other nb >= 1.
#define PD_NB_DISPATCH(F, G, TD, TV, nb, ...)       \
  switch (nb) {                                     \
    case 3:                                         \
      return F<TD, TV, 3>(__VA_ARGS__);             \
    case 4:                                         \
      return F<TD, TV, 4>(__VA_ARGS__);             \
    case 6:                                         \
      return F<TD, TV, 6>(__VA_ARGS__);             \
    case 10:                                        \
      return F<TD, TV, 10>(__VA_ARGS__);            \
    case 20:                                        \
      return F<TD, TV, 20>(__VA_ARGS__);            \
    default:                                        \
      return G<TD, TV>(nb, __VA_ARGS__);            \
  }
