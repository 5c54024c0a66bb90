// Diagnostics of the device loops for tools/while_probe.py, which alone
// builds this file (nvcc, sm_90a) into its own library: the kernel
// library's loop entries (csrc/graph_loop.cu, included) and three
// entries no solver needs: set_condition launched on a stream (so that a
// torch capture records it), a graph's node types and its DOT print.
// Plain C interface for ctypes, as csrc/graph_loop.cu's.

#include "../polydeal_tpu_torch/csrc/graph_loop.cu"

namespace {

__global__ void probe_set_condition_kernel(cudaGraphConditionalHandle handle,
                                           const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

bool on_host(const void* p) {
  cudaPointerAttributes a;
  if (cudaPointerGetAttributes(&a, p) != cudaSuccess) {
    cudaGetLastError();
    return true;
  }
  return a.type == cudaMemoryTypeHost || a.type == cudaMemoryTypeUnregistered;
}

}  // namespace

extern "C" {

// set_condition launched on a stream (inside a torch capture: the kernel
// node lands in the captured graph)
int pd_set_condition(unsigned long long handle, const void* flag,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_set_condition_kernel<<<1, 1, 0, s>>>(
      handle, static_cast<const bool*>(flag));
  return static_cast<int>(cudaGetLastError());  // clears it too
}

// `graph` written to `path` as DOT (the nodes with their kernels' names
// and memory nodes' sizes)
int pd_graph_dot(void* graph, const char* path) {
  return status(cudaGraphDebugDotPrint(static_cast<cudaGraph_t>(graph), path,
                                       cudaGraphDebugDotFlagsVerbose));
}

// counts[t] += the nodes of type t (cudaGraphNodeType, t < 16) in `graph`,
// child graphs counted through (their own node not counted); and what a
// conditional body may refuse: counts[16] memcpy nodes with an end in host
// memory, counts[17] memset nodes of more than one row, counts[18] kernel
// nodes in another memory-sync domain than the default, counts[19]
// cooperative kernel nodes, counts[20] kernel nodes launched with a
// cluster shape
int pd_graph_node_types(void* graph, long long* counts) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess || n == 0) return status(e);
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  e = cudaGraphGetNodes(g, nodes, &n);
  for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (e != cudaSuccess) break;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t c = nullptr;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &c);
      if (e == cudaSuccess) e = static_cast<cudaError_t>(
          pd_graph_node_types(c, counts));
    } else if (static_cast<int>(t) < 16) {
      counts[static_cast<int>(t)] += 1;
    }
    if (e != cudaSuccess) break;
    if (t == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms m = {};
      if (cudaGraphMemcpyNodeGetParams(nodes[i], &m) == cudaSuccess &&
          (on_host(m.srcPtr.ptr) || on_host(m.dstPtr.ptr)))
        counts[16] += 1;
    } else if (t == cudaGraphNodeTypeMemset) {
      cudaMemsetParams m = {};
      if (cudaGraphMemsetNodeGetParams(nodes[i], &m) == cudaSuccess &&
          m.height > 1)
        counts[17] += 1;
    } else if (t == cudaGraphNodeTypeKernel) {
      cudaLaunchAttributeValue v = {};
      if (cudaGraphKernelNodeGetAttribute(
              nodes[i], cudaLaunchAttributeMemSyncDomain, &v) ==
              cudaSuccess &&
          v.memSyncDomain != cudaLaunchMemSyncDomainDefault)
        counts[18] += 1;
      v = {};
      if (cudaGraphKernelNodeGetAttribute(
              nodes[i], cudaLaunchAttributeCooperative, &v) == cudaSuccess &&
          v.cooperative)
        counts[19] += 1;
      v = {};
      if (cudaGraphKernelNodeGetAttribute(
              nodes[i], cudaLaunchAttributeClusterDimension, &v) ==
              cudaSuccess &&
          v.clusterDim.x * v.clusterDim.y * v.clusterDim.z > 1)
        counts[20] += 1;
      cudaGetLastError();
    }
  }
  delete[] nodes;
  return status(e);
}

}  // extern "C"
