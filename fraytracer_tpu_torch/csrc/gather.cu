// K4: block gather, out[i] = x[block_idx[i]] over fixed-size blocks.
//
// Replaces: fraytracer_tpu/ops/pallas/gather.py::block_gather (body
// _copy_kernel, wrapper flat_block_gather), the TPU's scalar-prefetched
// (8, 128)-block reorder used by the material-repair block tier
// (ops/shade.py::resolve_material) and queue compaction.
//
// What bounds it on an H100: device-memory bandwidth; it moves bytes and
// computes nothing.
//
// Design: one thread block per output block.  The block loads its own
// source index (there is no scalar prefetch on this card) and copies the
// source block with 16-byte loads and stores, neighbouring threads on
// neighbouring addresses.  A block is `block_words` 16-byte words: 256 for
// a (8, 128) block of 4-byte elements, k times that for [N, k] payloads
// gathered in one launch.  An index outside [0, n_in) writes zeros and
// reads nothing.
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256)
block_gather_kernel(const int4* __restrict__ x, const int* __restrict__ idx,
                    int n_in, int block_words, int4* __restrict__ out) {
  const int b = blockIdx.x;
  const int src = __ldg(idx + b);
  const bool ok = src >= 0 && src < n_in;
  const int4* s = x + (size_t)(ok ? src : 0) * block_words;
  int4* o = out + (size_t)b * block_words;
  for (int w = threadIdx.x; w < block_words; w += blockDim.x) {
    o[w] = ok ? __ldg(s + w) : make_int4(0, 0, 0, 0);
  }
}

extern "C" int ft_block_gather(const void* x, const int* idx, int n_in,
                               int n_out, int block_words, void* out,
                               void* stream) {
  if (n_out > 0) {
    block_gather_kernel<<<n_out, 256, 0, (cudaStream_t)stream>>>(
        (const int4*)x, idx, n_in, block_words, (int4*)out);
  }
  return (int)cudaGetLastError();
}
