// Device-gated CUDA graphs for the level windows (core/window.py), built
// with the CUDA 12.4+ conditional-node API.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes; each entry point returns a
// cudaError_t (0 on success) for the Python side to raise on.
//
// A window's graph has two nodes:
//
//   set_condition  ->  IF(handle) { child graph: one captured level }
//
// set_condition copies the device bool the window owns (`go`) into the
// conditional handle, so each launch of the executable graph reads the
// flag as it stands when the launch reaches the device: a level runs when
// `go` is set and the launch does nothing more otherwise.  The level is the
// graph torch captured (torch.cuda.graph with keep_graph=True), added to the
// IF node's body as a child-graph node, which clones it; torch's graph
// object keeps the memory pool its temporaries live in.  The level writes
// the next `go` itself, so a window is the executable graph launched T times
// back to back on one stream, with nothing read on the host between them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

// Builds and instantiates set_condition -> IF(*pred) { body }.  `body` is
// a cudaGraph_t, cloned into the IF node's body graph (the caller keeps
// and frees its own).  On success *graph_out and *exec_out hold the graph
// and its executable (free both with blest_graph_destroy).
int blest_if_graph(const void* pred, void* body, void** graph_out,
                   void** exec_out) {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  cudaGraphNode_t set_node = nullptr;
  if (err == cudaSuccess) {
    const bool* p = static_cast<const bool*>(pred);
    void* args[] = {&handle, &p};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(set_condition);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.sharedMemBytes = 0;
    kp.kernelParams = args;
    kp.extra = nullptr;
    err = cudaGraphAddKernelNode(&set_node, graph, nullptr, 0, &kp);
  }
  cudaGraphNodeParams cp = {};
  cudaGraphNode_t cond_node = nullptr;
  if (err == cudaSuccess) {
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    err = cudaGraphAddNode(&cond_node, graph, &set_node, 1, &cp);
  }
  cudaGraphNode_t child = nullptr;
  if (err == cudaSuccess) {
    err = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0],
                                     nullptr, 0,
                                     static_cast<cudaGraph_t>(body));
  }
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
  if (err != cudaSuccess) {
    cudaGraphDestroy(graph);
    return static_cast<int>(err);
  }
  *graph_out = graph;
  *exec_out = exec;
  return 0;
}

// One launch of the executable on `stream`.
int blest_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(
      static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

int blest_graph_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec != nullptr) {
    err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  }
  if (graph != nullptr) {
    const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e2;
  }
  return static_cast<int>(err);
}

const char* blest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
