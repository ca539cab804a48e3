// Host code only: read the CUDA graph that a stream is capturing, for the
// stage maps of magics_tpu_torch/profiling.py.
//
// A capture on one stream builds a chain: each operation becomes a node
// that depends on the one before. A stage mark reads the capture's current
// node (the one the next operation will follow), which adds nothing to the
// graph and costs one query. At the capture's end one walk back along the
// chain from its last node turns the marks into counts of nodes: of device
// operations, the operations a profiler sees a replay run. (Measured on an
// H100 with CUDA 12.9 at 175,058 nodes: the walk 0.04 s; reading every
// node's type 0.02 s more; cudaGraphGetEdges 3.1 s; the node count
// cudaGraphGetNodes gives 6.7 ms a call, once here and never a mark.)

#include <cuda_runtime.h>

namespace {

// The capture on `stream`: its graph and current nodes. False where the
// stream is not capturing.
bool capture_info(void* stream, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                  size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                                             nullptr, graph, deps, nullptr, n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                                             nullptr, graph, deps, n);
#endif
  if (err != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return status == cudaStreamCaptureStatusActive;
}

// The first node `node` depends on, or null where it depends on none. A
// chain's nodes have one dependency each; whether the walk from the last
// node through these reaches every node is checked by its length.
bool first_dependency(cudaGraphNode_t node, cudaGraphNode_t* before) {
  size_t n = 1;
  *before = nullptr;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaGraphNodeGetDependencies(node, before, nullptr, &n);
#else
  cudaError_t err = cudaGraphNodeGetDependencies(node, before, &n);
#endif
  if (err != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  if (n == 0) *before = nullptr;
  return true;
}

}  // namespace

// Start this library's CUDA runtime on the current card (a capture refuses
// what a runtime does when it starts). Returns 0, or -1 on failure.
extern "C" int graph_nodes_start() {
  if (cudaFree(nullptr) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return 0;
}

// The current node of the capture on `stream` in `*tail` (null before the
// first operation). Returns 0; -1 where the stream is not capturing, -2
// where the capture has more than one current node (it forked).
extern "C" int graph_capture_tail(void* stream, void** tail) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  if (!capture_info(stream, &graph, &deps, &n)) return -1;
  if (n > 1) return -2;
  *tail = n ? static_cast<void*>(deps[0]) : nullptr;
  return 0;
}

// For each of the `count` nodes in `tails` (from graph_capture_tail), the
// number of nodes of the capture up to and including it, in `positions` (0
// for a null tail). Returns the capture's nodes in all; -1 where the stream
// is not capturing, -2 where they do not lie on one path back from its
// current node (the capture is not one chain), -3 where the tails are not
// on it in the order they were read.
//
// Each node of a stream's capture is a device operation (a kernel, copy or
// fill): reading the nodes' types would double the pass, so the caller
// holds the count against a profiled replay's operations instead.
extern "C" long long graph_capture_positions(void* stream, void* const* tails,
                                             long long count, long long* positions) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  if (!capture_info(stream, &graph, &deps, &n)) return -1;
  if (n > 1) return -2;
  // walk back from the current node, meeting the tails in the reverse of
  // the order they were read; a tail's count is known once the walk's is
  long long walked = 0, k = count - 1;
  for (cudaGraphNode_t node = n ? deps[0] : nullptr; node != nullptr; ++walked) {
    for (; k >= 0 && tails[k] == static_cast<void*>(node); --k) positions[k] = walked;
    if (!first_dependency(node, &node)) return -2;
  }
  for (; k >= 0 && tails[k] == nullptr; --k) positions[k] = walked;
  if (k >= 0) return -3;
  size_t total = 0;
  if (cudaGraphGetNodes(graph, nullptr, &total) != cudaSuccess) {
    cudaGetLastError();
    return -2;
  }
  if (static_cast<long long>(total) != walked) return -2;
  for (long long i = 0; i < count; ++i) positions[i] = walked - positions[i];
  return walked;
}
