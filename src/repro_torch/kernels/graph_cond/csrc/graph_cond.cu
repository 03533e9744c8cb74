// Conditional CUDA graph nodes, CUDA C++: the counterpart of XLA's while
// loop with a trip count traced on the device, for a walk captured into a
// CUDA graph.
//
// The reference's plain KV walk (src/repro/core/attention.py _kv_walk) runs
// jax.lax.fori_loop(0, hi, ...) with hi computed on the device, so one
// compiled program costs what the fill needs. The port captures that walk
// into a CUDA graph with one IF node per block: block j's work is the
// node's body graph, and the node runs it only where the device bool
// live[j] (j < hi) holds at replay. graph_cond_begin_if, called while the
// stream `parent` captures a graph,
//   1. makes a conditional handle in the graph being captured,
//   2. launches set_if_kernel on `parent` (captured: at each replay it sets
//      the handle from *pred before the node runs),
//   3. adds the IF node after it, and moves `parent`'s capture past the
//      node (cudaStreamUpdateCaptureDependencies),
//   4. starts capturing the stream `body` into the node's body graph
//      (cudaStreamBeginCaptureToGraph).
// The caller then issues block j's work on `body` and calls
// graph_cond_end(body), which ends the body's capture; the parent's capture
// goes on after the node. A body whose predicate is false is not executed:
// its kernels do not launch.
//
// Needs CUDA 12.4 or newer in this library's runtime and in the driver
// (conditional nodes and cudaStreamBeginCaptureToGraph); an older one makes
// graph_cond_begin_if return its CUDA error, and the capture raises. The
// runtime's signatures of the capture-info, add-node and capture-
// dependency calls gained an edge-data argument in CUDA 13: both forms are
// here.
#include <cuda_runtime.h>

#include "consmax_common.cuh"

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* ndeps) {
#if CUDART_VERSION >= 13000
  const cudaGraphEdgeData* edges = nullptr;
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, &edges,
                                  ndeps);
#else
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, ndeps);
#endif
}

}  // namespace

extern "C" {

// CUDA versions as integers (12040 = 12.4): this library's runtime and the
// driver's.
int graph_cond_versions(int* runtime, int* driver) {
  *runtime = CUDART_VERSION;
  return cudaDriverGetVersion(driver);
}

// A stream of its own for the bodies' captures (non-blocking, on the
// current device). It also loads set_if_kernel's module: a capture must
// launch no kernel whose module is not loaded yet (lazy loading).
int graph_cond_stream_create(void** out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, set_if_kernel);
  if (err != cudaSuccess) return err;
  cudaStream_t s = nullptr;
  err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return err;
}

// Begin an IF node on the capturing stream `parent` whose body is captured
// on `body` (a stream not capturing) until graph_cond_end(body). `pred`: a
// device bool read at each replay. Returns a CUDA error code (0: success;
// cudaErrorIllegalState when `parent` is not capturing).
int graph_cond_begin_if(void* parent, void* body, const void* pred) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = capture_info(ps, &status, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, ps>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(ps, &status, &graph, &deps, &ndeps);  // the setter
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(ps, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeGlobal);
}

// End the body capture graph_cond_begin_if started on `body`.
int graph_cond_end(void* body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}

}  // extern "C"
