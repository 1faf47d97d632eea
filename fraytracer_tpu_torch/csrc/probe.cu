// W and P1-P4: the bench warm-up kernel and the four feature probes.
//
// Replaces:
//   W   bench.py::_warm_kernel                      o = x * 2 on one (8, 128)
//       f32 tile; timed as the backend warm-up of a bench process.
//   P1  tools/probe_pallas_features.py::smem_block  grid G; each step's
//       (1, M, P) table slice in scalar memory; o = x * cand[g, 0, 3].
//   P2  ::smem_block_2d       the same with the table as [G*M, P], reading
//       [3, 1] of the step's (M, P) block.
//   P3  ::dyn_fori_scalar_loop  t_hi = max(x) over the tile; the window
//       [w_lo, w_hi) = first / last+1 key < t_hi; acc = min over the window
//       of |x - cand[c, 0]| + cand[c, 1], 1e30 when the window is empty.
//   P4  ::while_with_inner_fori  while max(t) < 10 and i < 50:
//       n = min(i + 1, 4); t += sum_{c<n} cand[c, 0] * 0.01 + 0.5.
//
// What bounds them on an H100: the launch.  Each moves 8-32 KiB and does a
// few thousand operations, microseconds below a launch's own cost.
//
// Design: one thread block per grid step g, one thread per element of the
// step's (8, 128) tile (1024 threads).  The TPU's scalar-memory table slice
// becomes the block's shared memory (M*P floats, staged by the block
// itself); a vector reduction that yields a scalar becomes a block
// reduction (warp shuffles, then one warp over the per-warp partials); the
// dynamic fori / while loops are block-uniform loops whose bounds come from
// those reductions.  P3 and P4 also run with the table read through __ldg
// from device memory, as the march kernel reads its candidate tables
// (ft_sdf.cuh::culled_pair), so the two placements can be timed side by
// side.
#include <cuda_runtime.h>

#define FT_PROBE_THREADS 1024

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max_i(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide max of one float per thread; every thread gets the result.
// `part` holds one float per warp; safe to call repeatedly.
__device__ float block_max(float v, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();  // the previous call's readers are done with `part`
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float r = lane < n_warps ? part[lane] : -3.0e38f;
  return warp_max(r);
}

// Stage the step's table slice (n floats) in shared memory.
__device__ void stage(const float* __restrict__ src, float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
  __syncthreads();
}

__global__ void __launch_bounds__(FT_PROBE_THREADS)
warm_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] * 2.0f;
}

__global__ void empty_kernel() {}

// P1 / P2: the scalar at (row, col) of the step's staged (M, P) slice.
__global__ void __launch_bounds__(FT_PROBE_THREADS)
smem_scalar_kernel(const float* __restrict__ cand, const float* __restrict__ x,
                   float* __restrict__ o, int m, int p, int row, int col) {
  extern __shared__ float tab[];
  const int g = blockIdx.x;
  stage(cand + (size_t)g * m * p, tab, m * p);
  const float s = tab[row * p + col];
  const size_t i = (size_t)g * FT_PROBE_THREADS + threadIdx.x;
  o[i] = x[i] * s;
}

// P3: window bounds from block reductions, then a block-uniform loop.
template <bool SMEM>
__global__ void __launch_bounds__(FT_PROBE_THREADS)
dyn_loop_kernel(const float* __restrict__ cand, const float* __restrict__ keys,
                const float* __restrict__ x, float* __restrict__ o, int m,
                int p) {
  extern __shared__ float tab[];
  __shared__ float part[32];
  __shared__ int win[2];
  const int g = blockIdx.x;
  const float* src = cand + (size_t)g * m * p;
  if (SMEM) stage(src, tab, m * p);
  const size_t i = (size_t)g * FT_PROBE_THREADS + threadIdx.x;
  const float xv = x[i];
  const float t_hi = block_max(xv, part);
  // first and last+1 index whose key lies below t_hi
  int lo = m, hi = 0;
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    if (__ldg(keys + (size_t)g * m + c) < t_hi) {
      lo = min(lo, c);
      hi = max(hi, c + 1);
    }
  }
  lo = warp_min_i(lo);
  hi = warp_max_i(hi);
  if (threadIdx.x == 0) { win[0] = m; win[1] = 0; }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&win[0], lo);
    atomicMax(&win[1], hi);
  }
  __syncthreads();
  const int w_lo = win[0], w_hi = win[1];
  float acc = 1e30f;
  for (int c = w_lo; c < w_hi; ++c) {
    const float s0 = SMEM ? tab[c * p] : __ldg(src + c * p);
    const float s1 = SMEM ? tab[c * p + 1] : __ldg(src + c * p + 1);
    acc = fminf(acc, fabsf(xv - s0) + s1);
  }
  o[i] = acc;
}

// P4: a block-uniform while whose condition is a block reduction each
// trip, around a dynamic inner loop.
template <bool SMEM>
__global__ void __launch_bounds__(FT_PROBE_THREADS)
while_kernel(const float* __restrict__ cand, const float* __restrict__ x,
             float* __restrict__ o, int* __restrict__ trips, int m, int p) {
  extern __shared__ float tab[];
  __shared__ float part[32];
  const int g = blockIdx.x;
  const float* src = cand + (size_t)g * m * p;
  if (SMEM) stage(src, tab, m * p);
  const size_t i = (size_t)g * FT_PROBE_THREADS + threadIdx.x;
  float t = x[i];
  int it = 0;
  while (it < 50 && block_max(t, part) < 10.0f) {
    const int n = min(it + 1, 4);
    float d = 0.0f;
    for (int c = 0; c < n; ++c) {
      const float s0 = SMEM ? tab[c * p] : __ldg(src + c * p);
      d = d + s0 * 0.01f;
    }
    t = t + d + 0.5f;
    ++it;
  }
  o[i] = t;
  if (threadIdx.x == 0) trips[g] = it;
}

extern "C" int ft_warm(const float* x, float* o, int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + FT_PROBE_THREADS - 1) / FT_PROBE_THREADS;
    warm_kernel<<<blocks, FT_PROBE_THREADS, 0, (cudaStream_t)stream>>>(x, o,
                                                                      n);
  }
  return (int)cudaGetLastError();
}

extern "C" int ft_probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int ft_probe_smem_scalar(const float* cand, const float* x,
                                    float* o, int g, int m, int p, int row,
                                    int col, void* stream) {
  if (g > 0) {
    smem_scalar_kernel<<<g, FT_PROBE_THREADS, (size_t)m * p * sizeof(float),
                         (cudaStream_t)stream>>>(cand, x, o, m, p, row, col);
  }
  return (int)cudaGetLastError();
}

extern "C" int ft_probe_dyn_loop(const float* cand, const float* keys,
                                 const float* x, float* o, int g, int m,
                                 int p, int use_smem, void* stream) {
  if (g > 0) {
    const size_t sh = (size_t)m * p * sizeof(float);
    if (use_smem) {
      dyn_loop_kernel<true><<<g, FT_PROBE_THREADS, sh,
                              (cudaStream_t)stream>>>(cand, keys, x, o, m, p);
    } else {
      dyn_loop_kernel<false><<<g, FT_PROBE_THREADS, 0,
                               (cudaStream_t)stream>>>(cand, keys, x, o, m,
                                                       p);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int ft_probe_while(const float* cand, const float* x, float* o,
                              int* trips, int g, int m, int p, int use_smem,
                              void* stream) {
  if (g > 0) {
    const size_t sh = (size_t)m * p * sizeof(float);
    if (use_smem) {
      while_kernel<true><<<g, FT_PROBE_THREADS, sh, (cudaStream_t)stream>>>(
          cand, x, o, trips, m, p);
    } else {
      while_kernel<false><<<g, FT_PROBE_THREADS, 0, (cudaStream_t)stream>>>(
          cand, x, o, trips, m, p);
    }
  }
  return (int)cudaGetLastError();
}
