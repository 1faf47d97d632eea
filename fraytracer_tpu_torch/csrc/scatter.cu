// The transpose of a row gather: out[idx[i], c] += g[i, c]
// (ops/cuda/scatter.py).
//
// Replaces: no TPU kernel.  The backward of the port's row gathers
// (ops/sdf.py::leaf_distance's parameter rows, ::take_rows' material rows)
// was autograd's index_add_: one device-memory atomic add a lane and
// column.  Lanes gather a few rows (the two clip and cut spheres take 4 M
// adds onto one cache line at 1024^2, the 1,000 tori 8 M onto 32 KB), so
// the adds of one address serialize in L2 (11.7 ms of a 1024^2 fit step
// on an H100).
//
// What bounds it on an H100: bytes.  It reads g (n x W values, any two
// strides) and idx (n int64) once and writes a K x W table.
//
// Design: one thread a lane, blocks of FT_SCATTER_THREADS, each block a
// contiguous slab of lanes (neighbouring pixels hit the same rows).  A lane
// whose gradient row is all zero adds nothing (+0.0 changes no sum that
// starts at +0.0; lanes of another kind in leaf_distance read a row but
// carry a zero gradient).  A warp groups its other lanes by row
// (__match_any_sync), sums each column over a group with shuffles (one
// round a doubling of the group, at most five), and the group's lowest
// lane adds the sum once.  Where the K x W table fits a block's shared
// memory (SMEM; the host picks the path, scatter.py::scatter_path, within
// the 48 KB a launch takes without opting in), those adds go to a copy of
// the table in shared memory, zeroed first, and the block then adds each
// non-zero entry of its copy to the output once; a larger table (GLOBAL)
// takes the warps' adds in device memory directly.  No host read and no synchronization: a CUDA graph
// captures the launch.  The sums are float32, in another order than
// index_add_'s.
#include <cuda_runtime.h>
#include <stdint.h>

#define FT_SCATTER_THREADS 256
#define FT_SCATTER_BLOCKS_PER_SM 4

namespace {

// x summed over the lanes of `peers` (this lane among them), in the
// group's lowest lane; `on` false: this lane takes no part (and no other
// lane's group holds it).  Every lane of the warp calls it.
__device__ __forceinline__ float peer_sum(unsigned peers, int lane, bool on,
                                          float x) {
  // this lane's rank in its group, and the members above it
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = on ? peers & (0xfffffffeu << lane) : 0u;
  while (__any_sync(0xffffffffu, rest)) {
    const int next = __ffs(rest);
    const float t = __shfl_sync(0xffffffffu, x, (next - 1) & 31);
    if (next) x += t;
    // the odd ranks of this round have been read: drop them
    rest &= ~__ballot_sync(0xffffffffu, rank & 1);
    rank >>= 1;
  }
  return x;
}

}  // namespace

template <bool SMEM>
__global__ void __launch_bounds__(FT_SCATTER_THREADS)
rows_scatter_kernel(const float* __restrict__ g, long long s_lane,
                    long long s_col, const long long* __restrict__ idx,
                    long long n, int K, int W, long long slab,
                    float* __restrict__ out) {
  extern __shared__ float ft_scatter_smem[];
  float* acc = SMEM ? ft_scatter_smem : out;
  const int kw = K * W;
  if (SMEM) {
    for (int e = threadIdx.x; e < kw; e += blockDim.x) acc[e] = 0.0f;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long lo = (long long)blockIdx.x * slab;
  const long long hi = lo + slab < n ? lo + slab : n;
  // the bound is the warp's first lane: every lane of a warp loops alike
  for (long long i0 = lo + (threadIdx.x & ~31); i0 < hi;
       i0 += blockDim.x) {
    const long long i = i0 + lane;
    const float* gi = g + i * s_lane;
    int row = -1;
    if (i < hi) {
      bool nz = false;
      for (int c = 0; c < W; ++c) nz |= gi[c * s_col] != 0.0f;
      if (nz) row = (int)idx[i];
    }
    const bool on = row >= 0;
    const unsigned peers = __match_any_sync(0xffffffffu, row);
    const bool leader = on && (peers & ((1u << lane) - 1u)) == 0u;
    for (int c = 0; c < W; ++c) {
      const float x = peer_sum(peers, lane, on, on ? gi[c * s_col] : 0.0f);
      if (leader && x != 0.0f) atomicAdd(acc + row * W + c, x);
    }
  }
  if (SMEM) {
    __syncthreads();
    for (int e = threadIdx.x; e < kw; e += blockDim.x) {
      const float v = acc[e];
      if (v != 0.0f) atomicAdd(out + e, v);
    }
  }
}

// g: n x W floats (element strides s_lane, s_col), idx: n int64 rows in
// [0, K), out: a zeroed contiguous K x W table; smem: the shared-memory
// path (a table past the launch's shared memory fails the launch).
extern "C" int ft_rows_scatter(const float* g, long long s_lane,
                               long long s_col, const long long* idx,
                               long long n, int K, int W, int smem,
                               float* out, void* stream) {
  if (n <= 0 || K <= 0 || W <= 0) return (int)cudaGetLastError();
  const size_t bytes = (size_t)K * W * sizeof(float);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const long long want = (n + FT_SCATTER_THREADS - 1) / FT_SCATTER_THREADS;
  const long long cap = (long long)sms * FT_SCATTER_BLOCKS_PER_SM;
  const long long grid = want < cap ? want : cap;
  // whole warps a slab
  const long long slab = ((n + grid - 1) / grid + 31) / 32 * 32;
  const cudaStream_t st = (cudaStream_t)stream;
  if (smem)
    rows_scatter_kernel<true><<<(unsigned)grid, FT_SCATTER_THREADS, bytes,
                                st>>>(g, s_lane, s_col, idx, n, K, W, slab,
                                      out);
  else
    rows_scatter_kernel<false><<<(unsigned)grid, FT_SCATTER_THREADS, 0,
                                 st>>>(g, s_lane, s_col, idx, n, K, W, slab,
                                       out);
  return (int)cudaGetLastError();
}
