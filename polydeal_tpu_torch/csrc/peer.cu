// Peer exchange kernels: the halo, the reduce and the gather of a solve
// sharded over several GPUs, each rank's kernels writing straight into the
// other ranks' device memory, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's sharded CG is one program on
// a device mesh whose collectives run inside its lax.while_loop: ppermute
// for the ring halo and the far tails (polydeal_tpu/parallel/banded.py
// :399-401, :472; parallel/sharding.py:329), psum for the dots and the
// restriction (banded.py:486; sharding.py:339, :373), all_gather for the
// coarse levels (banded.py:620; sharding.py:383, :387).  NCCL's send/recv,
// all_reduce and all-gather across ranks put event nodes and a kernel in
// the remote memory-sync domain into a captured program, and a CUDA
// graph whose conditional WHILE body holds them does not instantiate.
// These kernels are plain kernel nodes, so a sharded solve stays one
// device program (solvers/graphs.py) on every rank.
//
// The buffers.  Every rank allocates one device buffer with cudaMalloc
// (not torch's allocator, whose blocks cannot be opened elsewhere) and
// swaps its IPC handle with the others once, at setup
// (parallel/peer.py PeerGroup).  A buffer holds
//   [0, 256)    flags[s]: the epoch rank s last published to this rank;
//   [256, 512)  this rank's epoch counter (u64) and the put's arrivals
//               (u32), read and written only here;
//   [512, ...)  data[parity][source][slot bytes].
// Peers write rows and flags into it over NVLink; nobody reads a peer's
// buffer.
//
// An exchange is a put then a wait (or a reduce) on one stream, every rank
// running the same exchanges in the same order (the sharded solve is
// SPMD).  Its epoch e is the counter plus one: the put reads it, the put's
// last block to finish stores it, and the wait reads the stored value;
// no host takes part, so a WHILE body runs exchanges as it runs kernels.
//  * put: each block writes its part of the rows (gathered by an index
//    list, or a strided 2-D range) into the destinations' data[e & 1]
//    [this rank], then fences at system scope and counts itself in; the
//    last block then stores e to flags[this rank] of EVERY rank with a
//    release at system scope, whether it sent that rank rows or not.
//  * wait: one thread a block spins with an acquire at system scope until
//    every rank's flag here has reached e, then the block copies the
//    received rows from data[e & 1] into the consumer's tensors.
//  * reduce: the same wait, then each output element is the sum of the n
//    ranks' slots in rank order, 0, 1, ..., n - 1, each add rounded
//    alone (__fadd_rn / __dadd_rn: no FMA contraction), so every rank
//    gets the same bits, run after run.
// Why two parities are enough.  Since every put publishes to every rank
// and every wait waits for every rank, passing wait(e) means that every
// rank has finished put(e), and so its wait(e - 1) before it.  A rank
// writes data[e & 1] of epoch e + 2 only after its own wait(e + 1), when
// every rank has finished wait(e), the last reader of that parity.  The
// exchanges themselves are symmetric (the ring, the far-tail deltas,
// which come in pairs of +d and -d, the all-to-all of the reduce and the
// gather); the all-rank flags make that hold for any sequence of them.
// At one rank the ring goes to the rank itself, through the same code.
//
// A wait spins at most kTimeoutNs by %globaltimer (60 s); then it writes
// an error word (host-mapped, readable after the context is gone) and
// traps: ranks that ran different exchanges fail the run, never hang it.
//
// What bounds it.  A ring halo moves 2 T nb values each way: at most a
// few hundred KB over NVLink (450 GB/s each way) and one round trip of
// the flag, so a launch's floor and the link's latency, not its rate.
// The design keeps to that: one launch to put, one to wait, rows gathered
// in the put (no staging copy), a grid of at most 64 blocks of 256
// threads striding over the rows.
//
// Plain C interface for ctypes (built by polydeal_tpu_torch/ops/_build.py).
// Every entry returns the cudaError_t of the call that failed (0 on
// success), -2 for arguments it does not take.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxRanks = 16;
constexpr int kMaxSegs = 16;
constexpr long long kFlagsOff = 0;
constexpr long long kCtrlOff = 256;
constexpr long long kDataOff = 512;
constexpr unsigned long long kTimeoutNs = 60ull * 1000000000ull;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 64;

struct PutSeg {
  const char* src;
  const long long* idx;    // rows of the A dimension, or null
  long long A, B, sa, sb;  // element (a, b) at src[row(a) * sa + b * sb]
  long long dst_off;       // bytes into the destination's slot for us
  int dst;
};

struct PutArgs {
  char* peers[kMaxRanks];  // every rank's buffer as this process maps it
  char* base;              // this rank's buffer
  PutSeg seg[kMaxSegs];
  long long slot;
  int nseg, n, rank;
};

struct WaitSeg {
  long long off;  // bytes into the source's slot
  char* dst;
  long long bytes;
  int src, unit;  // unit: the bytes a thread moves at once
};

struct WaitArgs {
  char* base;
  unsigned long long* err;
  WaitSeg seg[kMaxSegs];
  long long slot;
  int nseg, n, rank;
};

struct ReduceArgs {
  char* base;
  unsigned long long* err;
  void* out;
  long long off, count, slot;  // off, count: elements
  int n, rank;
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long epoch_of(const char* base) {
  return *reinterpret_cast<const volatile unsigned long long*>(base +
                                                               kCtrlOff);
}

// one thread a block waits for every rank's flag to reach e
__device__ void await_epoch(const char* base, unsigned long long* err,
                            int n, int rank, unsigned long long e) {
  if (threadIdx.x == 0) {
    const unsigned long long* flags =
        reinterpret_cast<const unsigned long long*>(base + kFlagsOff);
    const unsigned long long t0 = globaltimer();
    for (int r = 0; r < n; ++r) {
      unsigned long long f;
      while ((f = ld_acquire_sys(flags + r)) < e) {
        if (globaltimer() - t0 > kTimeoutNs) {
          err[1] = e;
          err[2] = r;
          err[3] = f;
          err[4] = rank;
          err[0] = 1;
          __threadfence_system();
          __trap();
        }
      }
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) put_kernel(PutArgs a) {
  char* ctrl = a.base + kCtrlOff;
  const unsigned long long e = epoch_of(a.base) + 1;
  const long long parity = e & 1;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int s = 0; s < a.nseg; ++s) {
    const PutSeg g = a.seg[s];
    const T* src = reinterpret_cast<const T*>(g.src);
    T* dst = reinterpret_cast<T*>(a.peers[g.dst] + kDataOff +
                                  (parity * a.n + a.rank) * a.slot +
                                  g.dst_off);
    const long long total = g.A * g.B;
    for (long long k = tid; k < total; k += stride) {
      const long long i = k / g.B, j = k - i * g.B;
      const long long row = g.idx != nullptr ? g.idx[i] : i;
      dst[k] = src[row * g.sa + j * g.sb];
    }
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int* arrivals = reinterpret_cast<unsigned int*>(ctrl + 8);
    if (atomicAdd(arrivals, 1u) == gridDim.x - 1) {
      *arrivals = 0;
      *reinterpret_cast<unsigned long long*>(ctrl) = e;
      __threadfence_system();
      for (int r = 0; r < a.n; ++r)
        st_release_sys(reinterpret_cast<unsigned long long*>(
                           a.peers[r] + kFlagsOff) + a.rank, e);
    }
  }
}

template <typename U>
__device__ __forceinline__ void copy_units(const char* src, char* dst,
                                           long long bytes, long long tid,
                                           long long stride) {
  const U* s = reinterpret_cast<const U*>(src);
  U* d = reinterpret_cast<U*>(dst);
  const long long m = bytes / (long long)sizeof(U);
  for (long long k = tid; k < m; k += stride) d[k] = __ldcg(s + k);
}

__global__ void __launch_bounds__(kThreads) wait_kernel(WaitArgs a) {
  const unsigned long long e = epoch_of(a.base);
  await_epoch(a.base, a.err, a.n, a.rank, e);
  const long long parity = e & 1;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int s = 0; s < a.nseg; ++s) {
    const WaitSeg g = a.seg[s];
    const char* src =
        a.base + kDataOff + (parity * a.n + g.src) * a.slot + g.off;
    switch (g.unit) {
      case 16: copy_units<uint4>(src, g.dst, g.bytes, tid, stride); break;
      case 8:
        copy_units<unsigned long long>(src, g.dst, g.bytes, tid, stride);
        break;
      case 4:
        copy_units<unsigned int>(src, g.dst, g.bytes, tid, stride);
        break;
      case 2:
        copy_units<unsigned short>(src, g.dst, g.bytes, tid, stride);
        break;
      default:
        copy_units<unsigned char>(src, g.dst, g.bytes, tid, stride);
    }
  }
}

__device__ __forceinline__ float add_rn(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ double add_rn(double x, double y) {
  return __dadd_rn(x, y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) reduce_kernel(ReduceArgs a) {
  const unsigned long long e = epoch_of(a.base);
  await_epoch(a.base, a.err, a.n, a.rank, e);
  const char* data = a.base + kDataOff + (e & 1) * a.n * a.slot;
  T* out = static_cast<T*>(a.out);
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = tid; k < a.count; k += stride) {
    T acc = __ldcg(reinterpret_cast<const T*>(data) + a.off + k);
    for (int r = 1; r < a.n; ++r)
      acc = add_rn(acc, __ldcg(reinterpret_cast<const T*>(data + r * a.slot) +
                               a.off + k));
    out[k] = acc;
  }
}

int blocks_for(long long work) {
  long long b = (work + 4 * kThreads - 1) / (4 * kThreads);
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

int status(cudaError_t e) {
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

int launched() { return status(cudaGetLastError()); }

int unit_of(const void* a, const void* b, long long bytes) {
  const unsigned long long m =
      reinterpret_cast<unsigned long long>(a) |
      reinterpret_cast<unsigned long long>(b) |
      static_cast<unsigned long long>(bytes);
  for (int u = 16; u > 1; u /= 2)
    if (m % u == 0) return u;
  return 1;
}

template <typename T>
int launch_put(const PutArgs& a, long long work, cudaStream_t st) {
  put_kernel<T><<<blocks_for(work), kThreads, 0, st>>>(a);
  return launched();
}

int put(const PutArgs& a, int esize, cudaStream_t st) {
  long long work = 0;
  for (int s = 0; s < a.nseg; ++s) work += a.seg[s].A * a.seg[s].B;
  switch (esize) {
    case 1: return launch_put<unsigned char>(a, work, st);
    case 2: return launch_put<unsigned short>(a, work, st);
    case 4: return launch_put<unsigned int>(a, work, st);
    case 8: return launch_put<unsigned long long>(a, work, st);
    case 16: return launch_put<uint4>(a, work, st);
    default: return -2;
  }
}

bool fill_common(PutArgs* a, const void* peers, void* base, int rank, int n,
                 long long slot) {
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n || slot <= 0)
    return false;
  std::memcpy(a->peers, peers, sizeof(char*) * n);
  a->base = static_cast<char*>(base);
  a->slot = slot;
  a->n = n;
  a->rank = rank;
  return true;
}

}  // namespace

extern "C" {

// the error words a trapped wait leaves: [0] 1, [1] its epoch, [2] the
// rank it waited for, [3] that rank's flag, [4] this rank
int pd_peer_host_alloc(long long bytes, void** host, void** dev) {
  *host = nullptr;
  *dev = nullptr;
  cudaError_t e = cudaHostAlloc(host, bytes, cudaHostAllocMapped);
  if (e != cudaSuccess) return status(e);
  std::memset(*host, 0, bytes);
  return status(cudaHostGetDevicePointer(dev, *host, 0));
}

int pd_peer_host_free(void* host) { return status(cudaFreeHost(host)); }

// a zeroed device buffer of `bytes` (the flags, the counter, the data)
int pd_peer_alloc(long long bytes, void** ptr) {
  *ptr = nullptr;
  cudaError_t e = cudaMalloc(ptr, bytes);
  if (e != cudaSuccess) return status(e);
  e = cudaMemset(*ptr, 0, bytes);
  if (e != cudaSuccess) return status(e);
  return status(cudaDeviceSynchronize());
}

int pd_peer_free(void* ptr) { return status(cudaFree(ptr)); }

// the buffer's IPC handle (64 bytes) into `handle`
int pd_peer_handle(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) std::memcpy(handle, &h, sizeof(h));
  return status(e);
}

int pd_peer_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

// another process's buffer from its handle, mapped into this one
int pd_peer_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  *ptr = nullptr;
  return status(cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int pd_peer_close(void* ptr) { return status(cudaIpcCloseMemHandle(ptr)); }

// put: `segs` holds nseg rows of 8 long longs (src, idx or 0, A, B, sa, sb,
// destination rank, byte offset in its slot); `peers` n buffer pointers;
// elements of `esize` bytes
int pd_peer_put(const void* peers, void* base, int rank, int n,
                long long slot, int esize, const long long* segs, int nseg,
                void* stream) {
  PutArgs a = {};
  if (!fill_common(&a, peers, base, rank, n, slot) || nseg < 0 ||
      nseg > kMaxSegs)
    return -2;
  a.nseg = nseg;
  for (int s = 0; s < nseg; ++s) {
    const long long* r = segs + 8 * s;
    PutSeg& g = a.seg[s];
    g.src = reinterpret_cast<const char*>(r[0]);
    g.idx = reinterpret_cast<const long long*>(r[1]);
    g.A = r[2];
    g.B = r[3];
    g.sa = r[4];
    g.sb = r[5];
    g.dst = static_cast<int>(r[6]);
    g.dst_off = r[7];
    if (g.dst < 0 || g.dst >= n || g.A < 0 || g.B < 1 || g.dst_off < 0 ||
        g.dst_off + g.A * g.B * esize > slot)
      return -2;
  }
  return put(a, esize, static_cast<cudaStream_t>(stream));
}

// all-gather's put: `bytes` of `src` into slot [this rank] of every rank
int pd_peer_all_gather(const void* peers, void* base, int rank, int n,
                       long long slot, const void* src, long long bytes,
                       void* stream) {
  PutArgs a = {};
  if (!fill_common(&a, peers, base, rank, n, slot) || bytes < 1 ||
      bytes > slot)
    return -2;
  const int unit = unit_of(src, nullptr, bytes);
  a.nseg = n;
  for (int r = 0; r < n; ++r) {
    PutSeg& g = a.seg[r];
    g.src = static_cast<const char*>(src);
    g.idx = nullptr;
    g.A = 1;
    g.B = bytes / unit;
    g.sa = 0;
    g.sb = 1;
    g.dst = r;
    g.dst_off = 0;
  }
  return put(a, unit, static_cast<cudaStream_t>(stream));
}

// wait: `segs` holds nseg rows of 4 long longs (source rank, byte offset in
// its slot, destination pointer, bytes); `err` the host-mapped error words
int pd_peer_wait(void* base, void* err, int rank, int n, long long slot,
                 const long long* segs, int nseg, void* stream) {
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n || nseg < 0 ||
      nseg > kMaxSegs)
    return -2;
  WaitArgs a = {};
  a.base = static_cast<char*>(base);
  a.err = static_cast<unsigned long long*>(err);
  a.slot = slot;
  a.nseg = nseg;
  a.n = n;
  a.rank = rank;
  long long work = 1;
  for (int s = 0; s < nseg; ++s) {
    const long long* r = segs + 4 * s;
    WaitSeg& g = a.seg[s];
    g.src = static_cast<int>(r[0]);
    g.off = r[1];
    g.dst = reinterpret_cast<char*>(r[2]);
    g.bytes = r[3];
    if (g.src < 0 || g.src >= n || g.off < 0 || g.bytes < 0 ||
        g.off + g.bytes > slot)
      return -2;
    g.unit = unit_of(a.base + kDataOff + g.src * slot + g.off, g.dst,
                     g.bytes);
    if (slot % g.unit != 0) g.unit = unit_of(nullptr, g.dst, g.bytes);
    const long long m = g.bytes / g.unit;
    if (m > work) work = m;
  }
  wait_kernel<<<blocks_for(work), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return launched();
}

// reduce: out[k] = sum over ranks r = 0 .. n-1, in that order, of element
// off + k of slot [r]; dtype 0 f32, 1 f64
int pd_peer_reduce(void* base, void* err, int rank, int n, long long slot,
                   int dtype, void* out, long long off, long long count,
                   void* stream) {
  const long long es = dtype == 0 ? 4 : 8;
  if (n < 1 || n > kMaxRanks || rank < 0 || rank >= n || off < 0 ||
      count < 1 || (off + count) * es > slot || (dtype != 0 && dtype != 1))
    return -2;
  ReduceArgs a = {};
  a.base = static_cast<char*>(base);
  a.err = static_cast<unsigned long long*>(err);
  a.out = out;
  a.off = off;
  a.count = count;
  a.slot = slot;
  a.n = n;
  a.rank = rank;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    reduce_kernel<float><<<blocks_for(count), kThreads, 0, st>>>(a);
  else
    reduce_kernel<double><<<blocks_for(count), kThreads, 0, st>>>(a);
  return launched();
}

}  // extern "C"
