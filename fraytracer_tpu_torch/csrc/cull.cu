// The table build of the culled march sites: per-tile cones, candidate
// selection and table fill (ops/cuda/cull_kernel.py).
//
// Replaces: no TPU kernel.  The JAX package builds these tables with jnp
// ops before its pallas_call (fraytracer_tpu/ops/pallas/march_kernel.py
// :_tile_cones :415, :_cand_mask :539, :_cone_candidates :588,
// pallas_march_raw :1857-1977), and so did the port
// (ops/cuda/cull.py::build_pair_tables_plain, which stays the plain
// version): about 257 PyTorch ops a site, each a pass over [4096 sub-tiles,
// 1000 members] temporaries.
//
// What bounds it on an H100: bytes.  A site of the 1024^2 frame reads 1M
// lanes x 9 floats (36 MB), tests 4,096 sub-cones x 1,000 members (a few
// flops a test, members read from L2) and writes 1,024 x m table rows of
// 48 bytes (12.6 MB at m 256).
//
// Design: two launches a site, whatever its number of pairs.
// - cull_cones_kernel: one block of 256 threads a tile, a thread holding
//   one lane of each of the FT_SUBF sub-tiles (lanes read once, coalesced,
//   36 loads in flight a thread; small blocks keep several tiles an SM in
//   flight, so one tile's reductions overlap another's loads).  Warp
//   shuffles and shared memory reduce the first statistics (sums of
//   origins and directions, active lanes, t range, epsilon) of each
//   sub-tile, the tile's from its sub-tiles'; then every lane projects
//   itself on its sub-tile's cone and on the tile's, and a second
//   reduction gives the rest (lateral spread, cosines, axial reach,
//   converging tangents).  The lanes' oa / ca in the tile's frame are
//   written in the same pass, and block 0 clears the site's overflow
//   flag.
// - cull_select_kernel: one block of FT_SEL_THREADS a (tile, pair), the
//   pairs of a site on gridDim.y.  Members are tested in row order, FT_SEL_
//   THREADS at a time, against the four sub-cones (ORed; the axial and the
//   near test before the lateral one, which takes a root and a division);
//   a ballot and a scan over the warps compact the candidates with their
//   axial keys (in the tile cone's frame) into a buffer, row order kept.  A bitonic sort
//   on (key, row) over the next power of two of the count orders them:
//   ties go to the lower row, the order of a stable sort.  The members
//   that are not candidates follow in row order (the ballot words give
//   each its place), as the plain version's stable sort leaves them.  Then
//   the block writes its m table rows (float4 stores, torus axes
//   normalized), idx, the chunk keys (8 neighbouring lanes, shuffles), the
//   suffix minima (one warp's reverse scan), misc and the count, and
//   raises the overflow flag where count > m.  The buffer lives in shared
//   memory, sized by the host from the group (2 x next_pow2(g) + ballot
//   words and their prefix + chunks); a group too large for a block's
//   shared memory takes the same code over a slice of device memory the
//   host allocates (the large path).
//
// The arithmetic is the plain version's, operation for operation: the
// products and sums that PyTorch rounds one by one are written with
// __fmul_rn / __fadd_rn, so that nvcc does not contract them into FMAs.
// Only the order of the sums over a tile's lanes differs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ft_sdf.cuh"

namespace {

// the fields of one cone, as TileCones orders them
enum {
  C_APEX = 0, C_AXIS = 3, C_COS_HALF = 6, C_COS_LO, C_T_MIN, C_MAX_LEN,
  C_MARGIN, C_ANY, C_OFF_LO, C_OFF_HI, C_EPS_MAX, C_AX_LO, C_AX_HI,
  C_TAN_CONV, C_TAN_NEG
};

// a cones block: a thread a lane of each sub-tile
constexpr int kConeThreads = FT_TILE / FT_SUBF;
constexpr int kConeWarps = kConeThreads / 32;
constexpr int kSelWarps = FT_SEL_THREADS / 32;
constexpr float kInf = INFINITY;

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
// PyTorch's sum over a trailing axis of 3 on the card: two threads of a
// reduction share an output, one adding elements 0 and 2, the other
// holding element 1, so (x0 + x2) + x1
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return fa(fa(fm(ax, bx), fm(az, bz)), fm(ay, by));
}
// types.norm: sqrt(sum(v * v) + 1e-20)
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(fa(dot3(x, y, z, x, y, z), 1e-20f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FT_FULL_MASK, v, o);
  return v;
}
// warp_min / warp_max: ft_sdf.cuh's (one redux instruction)

// ---------------------------------------------------------------------------
// cones
// ---------------------------------------------------------------------------

// first reduction: sums of origin (3) and direction (3), active lanes;
// min t_lo, max t_hi, max epsilon
enum { R_SO = 0, R_SD = 3, R_N = 6, R_TMIN, R_MAXLEN, R_EPS, R1 };
// second, a frame: max rho^2, min cos, min / max o_par, min / max axial
// reach, max converging tangents
enum { S_RHO2 = 0, S_COS, S_OLO, S_OHI, S_ALO, S_AHI, S_TANP, S_TANN, R2 };

// two partial values of pass 1's value k, or of pass 2's
__device__ __forceinline__ float combine1(int k, float a, float b) {
  return k < R_TMIN ? a + b : k == R_TMIN ? fminf(a, b) : fmaxf(a, b);
}
__device__ __forceinline__ float combine2(int k, float a, float b) {
  return k == S_COS || k == S_OLO || k == S_ALO ? fminf(a, b) : fmaxf(a, b);
}

}  // namespace

__global__ void __launch_bounds__(kConeThreads, 3)
cull_cones_kernel(const float* __restrict__ origin,
                  const float* __restrict__ dir,
                  const float* __restrict__ t0,
                  const float* __restrict__ length,
                  const float* __restrict__ eps, int n,
                  const float* __restrict__ apex_in,
                  float* __restrict__ cones, float* __restrict__ oa,
                  float* __restrict__ ca, uint8_t* overflow) {
  // warp partials: pass 1 a sub-tile's R1 values, pass 2 a sub-tile's R2
  // values and the tile's R2
  __shared__ float part[kConeWarps][FT_SUBF * R1];
  __shared__ float red1[FT_CONES * R1];   // pass 1 of each cone
  __shared__ float red2[FT_CONES * R2];   // pass 2 of each cone
  __shared__ float frame[FT_CONES][6];    // apex, axis
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // lane tid + s * kConeThreads of the tile is in sub-tile s
  const long long i0 = (long long)blockIdx.x * FT_TILE + tid;
  float o[FT_SUBF][3], d[FT_SUBF][3], lo[FT_SUBF], hi[FT_SUBF],
      ep[FT_SUBF];
  bool act[FT_SUBF];
#pragma unroll
  for (int s = 0; s < FT_SUBF; ++s) {
    const long long i = i0 + s * kConeThreads;
    const bool in = i < n;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[s][k] = in ? origin[3 * i + k] : 0.f;
      d[s][k] = in ? dir[3 * i + k] : 0.f;
    }
    lo[s] = in ? t0[i] : 0.f;
    const float len = in ? length[i] : 0.f;
    hi[s] = len > 0.f ? len : lo[s];
    ep[s] = in ? eps[i] : 0.f;
    act[s] = hi[s] > lo[s];
  }

  // pass 1: sums of origins and directions, active lanes, t range, eps
#pragma unroll
  for (int s = 0; s < FT_SUBF; ++s) {
    float r[R1];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r[R_SO + k] = warp_sum(act[s] ? o[s][k] : 0.f);
      r[R_SD + k] = warp_sum(act[s] ? d[s][k] : 0.f);
    }
    r[R_N] = warp_sum(act[s] ? 1.f : 0.f);
    r[R_TMIN] = warp_min(act[s] ? lo[s] : kInf);
    r[R_MAXLEN] = warp_max(act[s] ? hi[s] : 0.f);
    r[R_EPS] = warp_max(act[s] ? ep[s] : 0.f);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < R1; ++k) part[warp][s * R1 + k] = r[k];
    }
  }
  __syncthreads();
  // a thread a (sub-tile, value): over the warps; then the tile over its
  // sub-tiles
  if (tid < FT_SUBF * R1) {
    const int k = tid % R1;
    float x = part[0][tid];
    for (int w = 1; w < kConeWarps; ++w) x = combine1(k, x, part[w][tid]);
    red1[R1 + tid] = x;
  }
  __syncthreads();
  if (tid < R1) {
    float x = red1[R1 + tid];
    for (int s = 1; s < FT_SUBF; ++s) x = combine1(tid, x, red1[R1 * (1 + s) + tid]);
    red1[tid] = x;
  }
  __syncthreads();
  if (tid < FT_CONES) {
    // cone 0: the tile; cone c: sub-tile c - 1
    const float* r = red1 + tid * R1;
    float ap[3], ax[3];
    const float safe_n = fmaxf(r[R_N], 1.f);
    for (int k = 0; k < 3; ++k) {
      ap[k] = apex_in ? apex_in[k] : r[R_SO + k] / safe_n;
      // converging: from the light back toward the origins
      ax[k] = apex_in ? -r[R_SD + k] : r[R_SD + k];
    }
    const float nrm = sqrtf(dot3(ax[0], ax[1], ax[2], ax[0], ax[1], ax[2]));
    const float den = fmaxf(nrm, 1e-12f);
    for (int k = 0; k < 3; ++k) {
      frame[tid][k] = ap[k];
      frame[tid][3 + k] = nrm > 1e-12f ? ax[k] / den : (k == 2 ? 1.f : 0.f);
    }
  }
  __syncthreads();

  // pass 2: each lane in its sub-tile's frame and in the tile's
  float tile[R2] = {-kInf, kInf, kInf, -kInf, kInf, -kInf, -kInf, -kInf};
#pragma unroll
  for (int s = 0; s < FT_SUBF; ++s) {
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const float* fr = frame[f == 0 ? 0 : 1 + s];
      const float rx = fs(o[s][0], fr[0]), ry = fs(o[s][1], fr[1]),
                  rz = fs(o[s][2], fr[2]);
      const float opar = dot3(rx, ry, rz, fr[3], fr[4], fr[5]);
      const float rho2 =
          fmaxf(fs(dot3(rx, ry, rz, rx, ry, rz), fm(opar, opar)), 0.f);
      const float cosd = dot3(d[s][0], d[s][1], d[s][2], fr[3], fr[4], fr[5]);
      const float ax0 = fa(opar, fm(lo[s], cosd));
      const float ax1 = fa(opar, fm(hi[s], cosd));
      float v[R2];
      v[S_RHO2] = act[s] ? rho2 : 0.f;
      v[S_COS] = act[s] ? cosd : 1.f;
      v[S_OLO] = act[s] ? opar : FT_BIG;
      v[S_OHI] = act[s] ? opar : -FT_BIG;
      v[S_ALO] = act[s] ? fminf(ax0, ax1) : FT_BIG;
      v[S_AHI] = act[s] ? fmaxf(ax0, ax1) : -FT_BIG;
      v[S_TANP] = v[S_TANN] = 0.f;
      if (apex_in && act[s]) {
        const float lam = sqrtf(rho2);
        if (opar >= 0.f)
          v[S_TANP] = lam / fmaxf(opar, 1e-6f);
        else
          v[S_TANN] = lam / fmaxf(-opar, 1e-6f);
      }
      if (f == 0) {
        const long long i = i0 + s * kConeThreads;
        if (i < n) {
          oa[i] = opar;
          ca[i] = cosd;
        }
#pragma unroll
        for (int k = 0; k < R2; ++k) tile[k] = combine2(k, tile[k], v[k]);
      } else {
#pragma unroll
        for (int k = 0; k < R2; ++k) {
          const float x = k == S_COS || k == S_OLO || k == S_ALO
                              ? warp_min(v[k]) : warp_max(v[k]);
          if (lane == 0) part[warp][s * R2 + k] = x;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < R2; ++k) {
    const float x = k == S_COS || k == S_OLO || k == S_ALO
                        ? warp_min(tile[k]) : warp_max(tile[k]);
    if (lane == 0) part[warp][FT_SUBF * R2 + k] = x;
  }
  __syncthreads();
  if (tid < FT_CONES * R2) {
    const int k = tid % R2;
    float x = part[0][tid];
    for (int w = 1; w < kConeWarps; ++w) x = combine2(k, x, part[w][tid]);
    // slots: the sub-tiles' first, the tile's last; cones: the tile first
    red2[tid < FT_SUBF * R2 ? R2 + tid : k] = x;
  }
  __syncthreads();
  if (tid < FT_CONES) {
    const float* r1 = red1 + tid * R1;
    const float* v = red2 + tid * R2;
    const bool any = r1[R_N] > 0.f;
    const float eps_max = r1[R_EPS];
    float* c = cones + ((size_t)blockIdx.x * FT_CONES + tid) * FT_CONE_W;
    for (int k = 0; k < 6; ++k) c[k] = frame[tid][k];
    c[C_COS_HALF] = fminf(fmaxf(v[S_COS], 1e-3f), 1.f);
    c[C_COS_LO] = fminf(v[S_COS], 1.f);
    c[C_T_MIN] = any ? r1[R_TMIN] : 0.f;
    c[C_MAX_LEN] = r1[R_MAXLEN];
    c[C_MARGIN] = apex_in ? fa(fm(2.f, eps_max), 1e-3f)
                          : fa(fa(sqrtf(v[S_RHO2]), fm(2.f, eps_max)), 1e-3f);
    c[C_ANY] = any ? 1.f : 0.f;
    c[C_OFF_LO] = any ? v[S_OLO] : 0.f;
    c[C_OFF_HI] = any ? v[S_OHI] : 0.f;
    c[C_EPS_MAX] = eps_max;
    c[C_AX_LO] = any ? v[S_ALO] : 0.f;
    c[C_AX_HI] = any ? v[S_AHI] : 0.f;
    c[C_TAN_CONV] = apex_in ? v[S_TANP] : -1.f;
    c[C_TAN_NEG] = apex_in ? v[S_TANN] : 0.f;
    c[FT_CONE_W - 1] = 0.f;
  }
  if (overflow && blockIdx.x == 0 && tid == 0) *overflow = 0;
}

// ---------------------------------------------------------------------------
// select and fill
// ---------------------------------------------------------------------------

namespace {

// A member's bounding sphere (ops/sdf.py::_prim_bound_rows)
__device__ __forceinline__ void member_bound(int kind, const float* p,
                                             float c[3], float& rb) {
  switch (kind) {
    case K_CAPSULE:
    case K_CONE: {
      for (int k = 0; k < 3; ++k) c[k] = fm(0.5f, fa(p[k], p[3 + k]));
      const float len = norm3(fs(p[3], p[0]), fs(p[4], p[1]),
                              fs(p[5], p[2]));
      rb = kind == K_CAPSULE ? fa(p[6], fm(0.5f, len))
                             : fa(fm(0.5f, len), fmaxf(p[6], p[7]));
      return;
    }
    case K_TRIANGLE: {
      // x / 3.0: PyTorch multiplies by the float reciprocal of a scalar
      for (int k = 0; k < 3; ++k)
        c[k] = fm(fa(fa(p[k], p[3 + k]), p[6 + k]), 1.f / 3.f);
      float r = 0.f;
      for (int v = 2; v >= 0; --v) {
        const float e = norm3(fs(p[3 * v], c[0]), fs(p[3 * v + 1], c[1]),
                              fs(p[3 * v + 2], c[2]));
        r = v == 2 ? e : fmaxf(e, r);
      }
      rb = fa(r, p[9]);
      return;
    }
    case K_PLANE:
      c[0] = c[1] = c[2] = 0.f;
      rb = FT_BIG;
      return;
    default:  // sphere, torus, box: the centre first
      for (int k = 0; k < 3; ++k) c[k] = p[k];
      rb = kind == K_SPHERE ? p[3]
           : kind == K_TORUS ? fa(p[6], p[7])
                             : fa(norm3(p[3], p[4], p[5]), p[6]);
  }
}

// The conservative candidacy test of one cone (cull.py::_cand_mask): the
// same predicates, the cheap ones first.  C[C_SIN_HALF] holds the cone's
// sin_half, computed once a block.
constexpr int C_SIN_HALF = FT_CONE_W - 1;

__device__ __forceinline__ bool candidate(const float* C, const float c[3],
                                          float rb, bool conv) {
  if (C[C_ANY] == 0.f) return false;
  const float r = fa(rb, C[C_MARGIN]);
  const float vx = fs(c[0], C[0]), vy = fs(c[1], C[1]), vz = fs(c[2], C[2]);
  const float a = dot3(vx, vy, vz, C[3], C[4], C[5]);
  if (!(fa(a, r) >= C[C_AX_LO] && fs(a, r) <= C[C_AX_HI])) return false;
  const float v2 = dot3(vx, vy, vz, vx, vy, vz);
  if (v2 <= fm(r, r)) return true;  // near
  const float p = sqrtf(fmaxf(fs(v2, fm(a, a)), 0.f));
  float reach;
  if (conv) {
    reach = fmaxf(fm(fmaxf(fa(a, r), 0.f), C[C_TAN_CONV]),
                  fm(fmaxf(fs(r, a), 0.f), C[C_TAN_NEG]));
  } else {
    const float cl = C[C_COS_LO], ml = C[C_MAX_LEN];
    // t_reach <= ml, and rounded products and sums are monotone: past
    // the reach at ml the member is out, with no division
    if (p > fa(r, fm(C[C_SIN_HALF], ml))) return false;
    const float t_reach =
        cl > 0.f ? fminf(fmaxf(fs(fa(a, r), C[C_OFF_LO]) / fmaxf(cl, 1e-6f),
                               0.f),
                         ml)
                 : ml;
    reach = fm(C[C_SIN_HALF], t_reach);
  }
  return p <= fa(r, reach);
}

__device__ __forceinline__ int pow2_at_least(int x) {
  return x <= 1 ? 1 : 1 << (32 - __clz(x - 1));
}

// One table row: the parameters padded to FT_PSTRIDE (a torus's axis
// normalized, cull.py::_table_rows), the material and the global slot
__device__ __forceinline__ void write_row(const FtBuildPair& P, int row,
                                          float* out) {
  const float* p = P.params + (size_t)row * P.width;
  float v[FT_TABLE_W];
#pragma unroll
  for (int k = 0; k < FT_PSTRIDE; ++k) v[k] = k < P.width ? p[k] : 0.f;
  if (P.kind == K_TORUS) {
    const float nrm = norm3(v[3], v[4], v[5]);
    v[3] = v[3] / nrm;
    v[4] = v[4] / nrm;
    v[5] = v[5] / nrm;
  }
  v[FT_PSTRIDE] = P.ids[2 * row];
  v[FT_PSTRIDE + 1] = P.ids[2 * row + 1];
  float4* o4 = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int k = 0; k < FT_TABLE_W / 4; ++k)
    o4[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

}  // namespace

__global__ void __launch_bounds__(FT_SEL_THREADS)
cull_select_kernel(const FtBuild B) {
  extern __shared__ __align__(16) unsigned char ft_sel_smem[];
  __shared__ float cone[FT_CONES * FT_CONE_W];
  __shared__ int wsum[kSelWarps];
  __shared__ FtBuildPair P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  if (tid == 0) P = B.pairs[blockIdx.y];
  __syncthreads();
  const int g = P.g, m = P.m, chunks = m / FT_CAND_UNROLL;
  const int cap = pow2_at_least(g), words = (g + 31) >> 5;
  const bool conv = B.converging != 0;
  // the block's buffers (cull_kernel.py select_words)
  uint32_t* buf = P.scratch
      ? reinterpret_cast<uint32_t*>(P.scratch) + (size_t)tile * P.scratch_words
      : reinterpret_cast<uint32_t*>(ft_sel_smem);
  float* skey = reinterpret_cast<float*>(buf);
  int* srow = reinterpret_cast<int*>(buf + cap);
  uint32_t* mask = buf + 2 * cap;
  int* pre = reinterpret_cast<int*>(mask + words);
  float* hc = reinterpret_cast<float*>(pre + words);

  for (int k = tid; k < FT_CONES * FT_CONE_W; k += FT_SEL_THREADS)
    cone[k] = B.cones[(size_t)tile * FT_CONES * FT_CONE_W + k];
  __syncthreads();
  if (tid < FT_CONES) {
    float* C = cone + tid * FT_CONE_W;
    const float ch = C[C_COS_HALF];
    C[C_SIN_HALF] = sqrtf(fmaxf(fs(1.f, fm(ch, ch)), 0.f));
  }
  __syncthreads();

  // candidates in row order, with their keys in the tile cone's frame
  int count = 0;
  for (int r0 = 0; r0 < g; r0 += FT_SEL_THREADS) {
    const int r = r0 + tid;
    bool cand = false;
    float key = 0.f;
    if (r < g) {
      float c[3], rb;
      member_bound(P.kind, P.params + (size_t)r * P.width, c, rb);
#pragma unroll
      for (int s = 1; s < FT_CONES; ++s)
        cand = cand || candidate(cone + s * FT_CONE_W, c, rb, conv);
      key = dot3(fs(c[0], cone[0]), fs(c[1], cone[1]), fs(c[2], cone[2]),
                 cone[3], cone[4], cone[5]);
    }
    const uint32_t bal = __ballot_sync(FT_FULL_MASK, cand);
    if (lane == 0) {
      wsum[warp] = __popc(bal);
      const int w = (r0 >> 5) + warp;
      if (w < words) mask[w] = bal;
    }
    __syncthreads();
    int at = count, all = 0;
    for (int w = 0; w < kSelWarps; ++w) {
      at += w < warp ? wsum[w] : 0;
      all += wsum[w];
    }
    if (cand) {
      at += __popc(bal & ((1u << lane) - 1u));
      skey[at] = key;
      srow[at] = r;
    }
    count += all;
    __syncthreads();
  }

  // bitonic sort on (key, row) over the next power of two of the count
  const int p2 = pow2_at_least(count);
  for (int j = count + tid; j < p2; j += FT_SEL_THREADS) {
    skey[j] = kInf;
    srow[j] = 0x7fffffff;
  }
  __syncthreads();
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int x = tid; x < p2; x += FT_SEL_THREADS) {
        const int y = x ^ j;
        if (y > x) {
          const float kx = skey[x], ky = skey[y];
          const int rx = srow[x], ry = srow[y];
          const bool after = kx > ky || (kx == ky && rx > ry);
          if (after == ((x & k) == 0)) {
            skey[x] = ky;
            skey[y] = kx;
            srow[x] = ry;
            srow[y] = rx;
          }
        }
      }
      __syncthreads();
    }
  }

  // the members that are not candidates follow in row order, key +BIG
  const int filled = min(g, m);
  if (count < filled) {
    if (warp == 0) {
      int carry = 0;
      for (int w0 = 0; w0 < words; w0 += 32) {
        const int w = w0 + lane;
        const int c = w < words ? __popc(mask[w]) : 0;
        int x = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FT_FULL_MASK, x, o);
          if (lane >= o) x += y;
        }
        if (w < words) pre[w] = carry + x - c;
        carry += __shfl_sync(FT_FULL_MASK, x, 31);
      }
    }
    __syncthreads();
    for (int r = tid; r < g; r += FT_SEL_THREADS) {
      const uint32_t mw = mask[r >> 5];
      const int b = r & 31;
      if (!((mw >> b) & 1u)) {
        const int at = count + r - (pre[r >> 5] + __popc(mw & ((1u << b) - 1u)));
        if (at < filled) {
          skey[at] = FT_BIG;
          srow[at] = r;
        }
      }
    }
  }
  __syncthreads();

  // the tile's m rows: past the group, the last column again, keys +BIG
  const size_t t0 = (size_t)tile * m;
  float* keys = P.keys + (size_t)tile * 2 * chunks;
  for (int j0 = 0; j0 < m; j0 += FT_SEL_THREADS) {
    const int j = j0 + tid;
    float lo = FT_BIG, hi = FT_BIG;
    if (j < m) {
      const int row = srow[min(j, g - 1)];
      if (j < filled) {
        const float a = skey[j];
        float c[3], rb;
        member_bound(P.kind, P.params + (size_t)row * P.width, c, rb);
        lo = fa(fa(a, rb), 1e-3f);
        hi = fs(fs(a, rb), 1e-3f);
      }
      P.idx[t0 + j] = row;
      write_row(P, row, P.table + (t0 + j) * FT_TABLE_W);
    }
    // a chunk is FT_CAND_UNROLL neighbouring lanes
#pragma unroll
    for (int o = 1; o < FT_CAND_UNROLL; o <<= 1) {
      lo = fmaxf(lo, __shfl_xor_sync(FT_FULL_MASK, lo, o));
      hi = fminf(hi, __shfl_xor_sync(FT_FULL_MASK, hi, o));
    }
    if (j < m && (j & (FT_CAND_UNROLL - 1)) == 0) {
      const int c = j / FT_CAND_UNROLL;
      keys[c] = lo;
      keys[chunks + c] = hi;
      hc[c] = hi;
    }
  }
  __syncthreads();

  // suffix minima of the chunks' near edges: one warp, from the end
  if (warp == 0) {
    float carry = kInf;
    for (int e = chunks; e > 0; e -= 32) {
      const int c = e - 32 + lane;
      float x = c >= 0 ? hc[c] : kInf;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_down_sync(FT_FULL_MASK, x, o);
        if (lane + o < 32) x = fminf(x, y);
      }
      x = fminf(x, carry);
      if (c >= 0) P.hsuf[(size_t)tile * chunks + c] = x;
      carry = __shfl_sync(FT_FULL_MASK, x, 0);
    }
  }
  if (tid == 0) {
    const float eps_max = cone[C_EPS_MAX];
    float clamp = fmaxf(fm(8.f, eps_max), B.window_clamp);
    if (P.reach > 0.f) {
      // k * log(max(8k / max(eps_max, 1e-6), 1)); PyTorch divides a
      // scalar by a tensor as the tensor's reciprocal times the scalar
      const float q = fmaxf(fm(1.f / fmaxf(eps_max, 1e-6f), 8.f * P.reach),
                            1.f);
      clamp = fmaxf(clamp, fm(P.reach, logf(q)));
    }
    float* misc = P.misc + (size_t)tile * 4;
    misc[0] = (float)count;
    misc[1] = cone[C_COS_LO];
    misc[2] = clamp;
    misc[3] = fa(fm(8.f, eps_max), 1e-3f);
    P.count[tile] = count;
    if (B.overflow && count > m) *B.overflow = 1;
  }
}

extern "C" int ft_cull_cones(const float* origin, const float* dir,
                             const float* t0, const float* length,
                             const float* eps, int n, const float* apex,
                             float* cones, float* oa, float* ca,
                             uint8_t* overflow, void* stream) {
  const int grid = (n + FT_TILE - 1) / FT_TILE;
  if (grid > 0)
    cull_cones_kernel<<<grid, kConeThreads, 0, (cudaStream_t)stream>>>(
        origin, dir, t0, length, eps, n, apex, cones, oa, ca, overflow);
  return (int)cudaGetLastError();
}

extern "C" int ft_cull_select(const FtBuild* job, int grid, int smem_bytes,
                              void* stream) {
  if (grid > 0 && job->n_pairs > 0) {
    if (smem_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          cull_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    cull_select_kernel<<<dim3(grid, job->n_pairs), FT_SEL_THREADS, smem_bytes,
                         (cudaStream_t)stream>>>(*job);
  }
  return (int)cudaGetLastError();
}
