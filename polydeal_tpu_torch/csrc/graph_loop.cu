// Device loops: CUDA graphs with conditional WHILE nodes, the counterpart
// of XLA's lax.while_loop (and lax.fori_loop / lax.scan around it), for
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package runs each solve as one XLA
// program whose while_loop evaluates its condition on the device
// (polydeal_tpu/solvers/cg.py cg_solve, solvers/gmres.py gmres_solve,
// parallel/sharding.py, parallel/banded.py; the monodomain's lax.scan over
// steps).  Here a loop is a conditional WHILE node of a CUDA graph whose
// body holds a program captured by torch (a child graph node) and then
// set_condition, a one-thread kernel that writes the loop's device flag
// (the state's `active` or `go`, a bool on the device) into the node's
// condition and adds one to the loop's count of tests, a device counter
// the caller reads with the loop's result.  The graph that holds the
// loop is built here node by node, instantiated once and launched as one
// unit on torch's current stream: the host waits once, at the end
// (solvers/graphs.py builds the programs).
//
// What bounds it.  set_condition reads one byte and one counter, writes
// the condition and the counter: a launch's floor, once a loop
// iteration, beside bodies of thousands of launches; it needs no design
// beyond being one thread.
//
// The condition handles are created with cudaGraphCondAssignDefault and a
// default of 0, so that every launch of the graph starts from 0 and the
// node's first test reads the value the set_condition before it wrote.
// A handle belongs to the graph that holds its node: the outermost
// graph, or, for a loop inside a loop (GMRES's steps inside its restart
// cycles), the outer loop's body graph.
//
// Plain C interface for ctypes (built by polydeal_tpu_torch/ops/_build.py).
// Graphs, nodes and executable graphs cross it as opaque pointers, a
// condition handle as an unsigned 64-bit integer.  Every entry returns the
// cudaError_t of the call that failed (0 on success); pd_cuda_error_name
// gives its text.  Nodes are added in a chain: each after `dep` (none when
// null), since every program here is a sequence.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* flag,
                                     unsigned long long* tests) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
  *tests += 1;  // one thread, and the loop's nodes run one at a time
}

int deps_of(void* dep, cudaGraphNode_t* d) {
  *d = static_cast<cudaGraphNode_t>(dep);
  return dep == nullptr ? 0 : 1;
}

// the error as an int, cleared from the runtime's last error so that the
// next kernel launch's cudaGetLastError() does not report it
int status(cudaError_t e) {
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

const char* pd_cuda_error_name(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int pd_graph_create(void** graph) {
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  *graph = g;
  return status(e);
}

int pd_graph_destroy(void* graph) {
  return status(cudaGraphDestroy(static_cast<cudaGraph_t>(graph)));
}

// a condition handle of `graph` (the graph that will hold its WHILE node),
// reset to 0 at every launch
int pd_graph_condition(void* graph, unsigned long long* handle) {
  cudaGraphConditionalHandle h = 0;
  cudaError_t e = cudaGraphConditionalHandleCreate(
      &h, static_cast<cudaGraph_t>(graph), 0, cudaGraphCondAssignDefault);
  *handle = static_cast<unsigned long long>(h);
  return status(e);
}

// a node that runs a copy of `child` (a graph captured by torch)
int pd_graph_add_child(void* graph, void* dep, void* child, void** node) {
  cudaGraphNode_t d, n = nullptr;
  int nd = deps_of(dep, &d);
  cudaError_t e = cudaGraphAddChildGraphNode(
      &n, static_cast<cudaGraph_t>(graph), nd ? &d : nullptr, nd,
      static_cast<cudaGraph_t>(child));
  *node = n;
  return status(e);
}

// a set_condition node: the condition of `handle` <- *flag, *tests += 1
// (`tests`: an int64 on the device)
int pd_graph_add_set_condition(void* graph, void* dep,
                               unsigned long long handle, const void* flag,
                               void* tests, void** node) {
  cudaGraphNode_t d, n = nullptr;
  int nd = deps_of(dep, &d);
  cudaGraphConditionalHandle h = handle;
  const bool* f = static_cast<const bool*>(flag);
  unsigned long long* t = static_cast<unsigned long long*>(tests);
  void* args[] = {&h, &f, &t};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(set_condition_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  cudaError_t e = cudaGraphAddKernelNode(
      &n, static_cast<cudaGraph_t>(graph), nd ? &d : nullptr, nd, &p);
  *node = n;
  return status(e);
}

// a WHILE node on `handle`; *body is its body graph, owned by the node
int pd_graph_add_while(void* graph, void* dep, unsigned long long handle,
                       void** node, void** body) {
  cudaGraphNode_t d, n = nullptr;
  int nd = deps_of(dep, &d);
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphAddNode(&n, static_cast<cudaGraph_t>(graph),
                                   nd ? &d : nullptr, nullptr, nd, &p);
#else
  cudaError_t e = cudaGraphAddNode(&n, static_cast<cudaGraph_t>(graph),
                                   nd ? &d : nullptr, nd, &p);
#endif
  *node = n;
  *body = e == cudaSuccess ? p.conditional.phGraph_out[0] : nullptr;
  return status(e);
}

int pd_graph_instantiate(void* graph, void** exec) {
  cudaGraphExec_t x = nullptr;
  cudaError_t e = cudaGraphInstantiate(&x, static_cast<cudaGraph_t>(graph),
                                       0);
  *exec = x;
  return status(e);
}

int pd_graph_launch(void* exec, void* stream) {
  return status(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                static_cast<cudaStream_t>(stream)));
}

int pd_graph_exec_destroy(void* exec) {
  return status(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

}  // extern "C"
