// Conditional nodes for CUDA graphs captured by PyTorch (sm_90a).
//
// Not a port of a TPU kernel: the machinery that lets a captured CUDA
// graph hold the CRUSH retry ladder (crush/interp_batch.py): its rounds
// after the first are the body of a WHILE node whose condition (a lane
// still retries, and rounds are left) a reduction writes on the device,
// so a replay decides every round on the card and the host reads
// nothing.  PyTorch's own binding of conditional nodes
// (CUDAGraph.begin_capture_to_if_node) is missing from some releases;
// this library asks the CUDA runtime directly (CUDA 12.4 or later, as
// the nodes need), on the stream PyTorch is capturing.
//
// The epoch loop (recovery/superstep.py) puts a whole chunk of epochs in
// one graph: a WHILE node over the steps, IF nodes for the liveness tick
// and the dirty branch, SWITCH nodes for the tape rows' edits and the
// compaction ladder's rungs, each nested in the others' bodies.
//
// graph_cond_add(stream, pred, pred_is_index, type, size, bodies, &handle):
//   on `stream`, which is capturing, creates a conditional handle in the
//   graph being captured, captures the kernel that sets it (IF and WHILE:
//   *pred != 0 from a bool; SWITCH: the int32 *pred, where a value past
//   the last body runs none), adds a conditional node of `type` (0 IF,
//   1 WHILE, 2 SWITCH) with `size` bodies after it (an IF's second body
//   is its else), makes the node the stream's only dependency, and
//   returns the bodies' graphs.  IF with an else and SWITCH need CUDA
//   12.8; IF and WHILE with one body 12.4.
// graph_body_begin(body_stream, body, mode): starts capturing one body
//   graph on `body_stream` (in `mode`, the main capture's
//   cudaStreamCaptureMode); graph_cond_end ends it.
// graph_cond_set(stream, handle, pred): captures set_cond_kernel on
//   `stream` (the body's last node: the condition of the next pass).
// graph_cond_end(body_stream, body, &nodes): ends the body's capture and
//   counts the nodes it holds (a nested conditional node counts one; its
//   own body is counted when it ends).
// graph_capture_nodes(stream, &nodes): the nodes of the graph being
//   captured on `stream`, at its top level.
// graph_stream_create(&stream): a non-blocking stream of the current
//   device for a body's capture, one a nesting depth (PyTorch's stream
//   pool hands its 32 streams round, so a deep nest would meet a stream
//   that is still capturing).
// graph_runtime(&runtime, &driver): the runtime this library was built
//   with and the driver's version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_cond_kernel(cudaGraphConditionalHandle handle, const uint8_t* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

__global__ void set_index_kernel(cudaGraphConditionalHandle handle, const int32_t* index) {
  // a negative index runs no body, as one past the last does
  cudaGraphSetConditional(handle, static_cast<unsigned int>(*index));
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess : cudaErrorStreamCaptureImplicit;
}

}  // namespace

extern "C" {

const char* graph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int graph_runtime(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDriverGetVersion(driver);
}

int graph_stream_create(void** stream) {
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *stream = s;
  return (int)err;
}

int graph_cond_add(void* stream, const void* pred, int pred_is_index, int type, int size,
                   void** bodies_out, unsigned long long* handle_out) {
  cudaGetLastError();
#if CUDART_VERSION < 12040
  return (int)cudaErrorNotSupported;
#else
  cudaGraphConditionalNodeType kind;
  switch (type) {
    case 0: kind = cudaGraphCondTypeIf; break;
    case 1: kind = cudaGraphCondTypeWhile; break;
#if CUDART_VERSION >= 12080
    case 2: kind = cudaGraphCondTypeSwitch; break;
#endif
    default: return (int)cudaErrorNotSupported;
  }
#if CUDART_VERSION < 12080
  if (size != 1) return (int)cudaErrorNotSupported;
#endif
  if (size < 1 || (type == 1 && size != 1) || (type == 0 && size > 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  if (pred_is_index) {
    set_index_kernel<<<1, 1, 0, s>>>(handle, static_cast<const int32_t*>(pred));
  } else {
    set_cond_kernel<<<1, 1, 0, s>>>(handle, static_cast<const uint8_t*>(pred));
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = capture_info(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind;
  params.conditional.size = static_cast<unsigned int>(size);
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < size; ++i) bodies_out[i] = params.conditional.phGraph_out[i];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  *handle_out = handle;
  return 0;
#endif
}

int graph_body_begin(void* body_stream, void* body, int mode) {
  return (int)cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                            static_cast<cudaGraph_t>(body), nullptr, nullptr,
                                            0, static_cast<cudaStreamCaptureMode>(mode));
}

int graph_cond_set(void* stream, unsigned long long handle, const void* pred) {
  cudaGetLastError();
#if CUDART_VERSION < 12040
  return (int)cudaErrorNotSupported;
#else
  set_cond_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), static_cast<const uint8_t*>(pred));
  return (int)cudaGetLastError();
#endif
}

int graph_cond_end(void* body_stream, void* body, long long* nodes) {
  cudaGraph_t captured;
  cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &captured);
  if (err != cudaSuccess) return (int)err;
  size_t n = 0;
  err = cudaGraphGetNodes(static_cast<cudaGraph_t>(body), nullptr, &n);
  *nodes = (long long)n;
  return (int)err;
}

int graph_capture_nodes(void* stream, long long* nodes) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream), &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  *nodes = (long long)n;
  return (int)err;
}

}  // extern "C"
