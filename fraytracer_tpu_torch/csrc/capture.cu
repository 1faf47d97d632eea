// The op nodes of a CUDA graph under stream capture: the counter behind
// the layer tables of utils/profiling.py.
//
// A frame, step or spectral frame is captured from one stream, so its
// nodes form a chain and a replay runs its kernels, memcpys and memsets on
// the device in the order they were captured.  Counting those nodes when
// a span opens and closes inside the capture says which of a replay's
// device ops the span issued.  Host code only: no kernel, nothing added to
// the graph.
#include <cuda_runtime.h>

#include <vector>

// The kind of an op node ('k' kernel, 'c' memcpy, 's' memset), 0 for the
// nodes a replay runs no device op for (events, empty and host nodes).
static char op_kind(cudaGraphNodeType type) {
  switch (type) {
    case cudaGraphNodeTypeKernel: return 'k';
    case cudaGraphNodeTypeMemcpy: return 'c';
    case cudaGraphNodeTypeMemset: return 's';
    default: return 0;
  }
}

// *n_ops: the op nodes of the graph being captured on `stream`, now;
// with `kinds`, the kind of each of the first `cap` of them in the
// graph's node order.  cudaErrorIllegalState when the stream is not
// capturing.
extern "C" int ft_capture_ops(void* stream, char* kinds, int cap,
                              long long* n_ops) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err =
      cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, &id, &graph);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr)
    return (int)cudaErrorIllegalState;
  size_t n = 0;
  if ((err = cudaGraphGetNodes(graph, nullptr, &n)) != cudaSuccess)
    return (int)err;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n && (err = cudaGraphGetNodes(graph, nodes.data(), &n)) != cudaSuccess)
    return (int)err;
  long long ops = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    if ((err = cudaGraphNodeGetType(nodes[i], &type)) != cudaSuccess)
      return (int)err;
    const char k = op_kind(type);
    if (!k) continue;
    if (kinds && ops < cap) kinds[ops] = k;
    ++ops;
  }
  *n_ops = ops;
  return (int)cudaSuccess;
}
