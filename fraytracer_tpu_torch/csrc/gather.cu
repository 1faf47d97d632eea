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
// Design: a grid of (output blocks, ceil(block_words / 256)) thread blocks,
// one 16-byte word a thread and no loop, neighbouring threads on
// neighbouring addresses.  A block is `block_words` 16-byte words: 256 for
// a (8, 128) block of 4-byte elements, k times that for [N, k] payloads
// gathered in one launch.  At the repair tier's shape (16 blocks of 12 KB)
// one thread block per output block would put 16 thread blocks on 132
// SMs; this grid spreads the copy over 48, and a large gather (queue
// compaction: thousands of blocks) keeps full coalesced traffic either
// way.  Each warp loads its block's source index (one broadcast load;
// there is no scalar prefetch on this card).  An index outside [0, n_in)
// writes zeros and reads nothing.
#include <cuda_runtime.h>

#define FT_GATHER_THREADS 256

__global__ void __launch_bounds__(FT_GATHER_THREADS)
block_gather_kernel(const int4* __restrict__ x, const int* __restrict__ idx,
                    int n_in, int block_words, int4* __restrict__ out) {
  const int b = blockIdx.x;
  const int w = blockIdx.y * FT_GATHER_THREADS + threadIdx.x;
  if (w >= block_words) return;
  const int src = __ldg(idx + b);
  const bool ok = src >= 0 && src < n_in;
  out[(size_t)b * block_words + w] =
      ok ? __ldg(x + (size_t)src * block_words + w) : make_int4(0, 0, 0, 0);
}

extern "C" int ft_block_gather(const void* x, const int* idx, int n_in,
                               int n_out, int block_words, void* out,
                               void* stream) {
  if (n_out > 0 && block_words > 0) {
    const dim3 grid(n_out, (block_words + FT_GATHER_THREADS - 1) /
                               FT_GATHER_THREADS);
    block_gather_kernel<<<grid, FT_GATHER_THREADS, 0, (cudaStream_t)stream>>>(
        (const int4*)x, idx, n_in, block_words, (int4*)out);
  }
  return (int)cudaGetLastError();
}
