// CUDA-graph IF nodes for the port's captured loops (utils/capture.py
// run_if), through the CUDA runtime: the torch the port runs on may have no
// API for conditional nodes.
//
// elfi_if_begin, on a stream being captured: a conditional handle on the
// graph the stream captures into, a one-thread kernel that sets the handle
// from a device bool (the predicate, read at each replay), an IF node
// after it, the stream's later work made to depend on that node, and the
// body stream set to capture into the node's body graph.  The caller
// queues the body on the body stream, then elfi_if_end ends its capture.
//
// One body stream serves every depth of nesting.  An IF node begun on the
// body stream itself (a node inside a body) ends the stream's capture of
// the enclosing body and hands back that body graph and the new node;
// elfi_if_end resumes the enclosing body's capture after the node.  So
// one stream a device does, where a stream a depth would give each depth
// its own cuBLAS workspace in torch (32 MiB a stream on an H100).
// Nothing here allocates device memory.

#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "conditional graph nodes need the CUDA 12.4 runtime or later"
#endif

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

// 0 or the first CUDA error (the capture is then left as the failed call
// left it; the caller ends the whole capture and raises).  Where `stream`
// is `body`, *resume_graph and *resume_node receive the enclosing body's
// graph and the new node, else nullptr.
int elfi_if_begin(cudaStream_t stream, const bool* pred, cudaStream_t body,
                  cudaGraph_t* resume_graph, cudaGraphNode_t* resume_node) {
  *resume_graph = nullptr;
  *resume_node = nullptr;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr,
                                             &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, stream>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the dependencies now end in the kernel's node
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(
      stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  if (stream == body) {
    cudaGraph_t enclosing;
    err = cudaStreamEndCapture(body, &enclosing);
    if (err != cudaSuccess) return err;
    *resume_graph = enclosing;
    *resume_node = node;
  }
  return cudaStreamBeginCaptureToGraph(
      body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeGlobal);
}

// Ends the body's capture; with a `resume_graph`, the body stream captures
// into it again, after `resume_node`.
int elfi_if_end(cudaStream_t body, cudaGraph_t resume_graph,
                cudaGraphNode_t resume_node) {
  cudaGraph_t graph;   // the node's body graph, which the node owns
  cudaError_t err = cudaStreamEndCapture(body, &graph);
  if (err != cudaSuccess || resume_graph == nullptr) return err;
  return cudaStreamBeginCaptureToGraph(body, resume_graph, &resume_node,
                                       nullptr, 1,
                                       cudaStreamCaptureModeGlobal);
}

// A non-blocking stream on `device` for IF nodes' bodies, or nullptr.
cudaStream_t elfi_if_stream(int device) {
  int prev;
  if (cudaGetDevice(&prev) != cudaSuccess) return nullptr;
  if (cudaSetDevice(device) != cudaSuccess) return nullptr;
  cudaStream_t stream = nullptr;
  if (cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) !=
      cudaSuccess)
    stream = nullptr;
  cudaSetDevice(prev);
  return stream;
}

const char* elfi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
