// The implicit backward of a slot-mode march, one thread a lane
// (ops/cuda/leaf_vjp.py).
//
// Replaces: no TPU kernel.  The JAX package differentiates the winning
// leaf through XLA's fusion of its custom VJP (fraytracer_tpu/ops/march.py
// _march_surf_bwd :777, _surf_bwd_tail :748); the port's plain version is
// the autograd composition ops/march.py::implicit_vjp, about 600
// second-order elementwise ops over every lane, each evaluating every
// kind's formula on all lanes.
//
// What it computes, for a hit lane with leaf code c != 0 (f = sign(c) d,
// d the leaf's distance, sg the march sign or 1; every quantity below is
// the one implicit_vjp differentiates):
//   x = o + t d, den = the guarded sg grad_x f(x) . d, w = -ct_t / den;
//   p = o + (t - eps) d, g = grad_x f(p), n = g / |g| (types.normalize's
//   1e-20 guard), v = (ct_n - n (n . ct_n)) / |g|;
//   bar theta = sg d_theta f(x) (w - d^T H(p) v / den) + d_theta(v . grad_x
//   f)(p), H the x-Hessian: the second term's chain through the hit
//   distance is the first factor's -d^T H v / den.
// Miss lanes and code-0 lanes give zero.  theta is the leaf's row as the
// forward kernels read it (march_kernel.py slot_param_rows: torus axes
// normalized); the host takes the normalization's vjp after the scatter.
//
// What bounds it on an H100: instruction issue on the hit lanes.  Per lane
// it reads about 55 bytes of residuals and a row of at most 40 (cached) and
// writes 10 floats and a row index; three evaluations of one leaf in
// forward-mode duals take a few thousand flops.
//
// Design: three evaluations of the lane's one leaf, the kind known at
// compile time (one dispatch a lane), through ft_sdf.cuh's distance
// functions: at x with Jet tangents (the row's P parameters, then the ray
// direction): f, d_theta f and the denominator; at p with Dual: g, hence
// v; at p with a Jet over that Jet, the outer tangent along v: d_theta(v .
// grad_x f) and d^T H v.  Each lane writes its row's cotangent to bar
// [FT_PSTRIDE, n] (one column a lane, so a warp's stores coalesce) and its
// global slot to idx; rows_scatter_kernel (csrc/scatter.cu) sums the lanes
// into the [K, FT_PSTRIDE] table.  No host read and no synchronization: a
// CUDA graph captures the launch.
#include "ft_sdf.cuh"

#define FT_VJP_THREADS 256
#define FT_MAX_KINDS 7

// the scene's kinds in slot order (slots are kind-major)
struct FtKindSlots {
  int n;
  int kind[FT_MAX_KINDS];
  int first[FT_MAX_KINDS];  // the kind's first global slot
};

namespace {

// One hit lane's row cotangent (comment at the top of this file).
// o, d: the ray; cn: ct_n; out: FT_PSTRIDE zeros, of which the lane sets
// the kind's width.
template <int KIND>
__device__ __forceinline__ void leaf_vjp_lane(
    const float* row, float sgn, float sg, const float* o, const float* d,
    float t, float eps, float ct_t, const float* cn, float min_denom,
    float* out) {
  constexpr int P = ft_kind_width(KIND);
  constexpr int N = P + 1;  // tangents: the row's parameters, then d
  using J = Jet<float, N>;
  using H = Jet<J, 1>;
  const SeedRow<N> seeded{row};
  // f, d_theta f and the derivative along d at x = o + t d (rounded as
  // implicit_vjp's o + t * d)
  J x[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x[k] = J{};
    x[k].v = __fadd_rn(o[k], __fmul_rn(t, d[k]));
    x[k].t[P] = d[k];
  }
  const J f = kind_dist<KIND>(seeded, x[0], x[1], x[2]) * sgn;
  const float den0 = sg * f.t[P];
  const float den = den0 == 0.f
                        ? min_denom
                        : copysignf(fmaxf(fabsf(den0), min_denom), den0);
  const float w = -ct_t / den;
  // the normal's point and gradient
  float p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    p[k] = __fadd_rn(o[k], __fmul_rn(__fsub_rn(t, eps), d[k]));
  const Dual g = kind_dual<KIND>(GRow{row}, p[0], p[1], p[2]) * sgn;
  const float len = sqrtf(g.t[0] * g.t[0] + g.t[1] * g.t[1] +
                          g.t[2] * g.t[2] + 1e-20f);
  const float nx = g.t[0] / len, ny = g.t[1] / len, nz = g.t[2] / len;
  const float nc = nx * cn[0] + ny * cn[1] + nz * cn[2];
  const float v[3] = {(cn[0] - nx * nc) / len, (cn[1] - ny * nc) / len,
                      (cn[2] - nz * nc) / len};
  // v . grad_x f at p and its tangents: the point's inner tangent d, its
  // outer tangent v
  H y[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    y[k] = H{};
    y[k].v.v = p[k];
    y[k].v.t[P] = d[k];
    y[k].t[0].v = v[k];
  }
  const J dv = (kind_dist<KIND>(seeded, y[0], y[1], y[2]) * sgn).t[0];
  const float a = sg * (w - dv.t[P] / den);
#pragma unroll
  for (int j = 0; j < P; ++j) out[j] = f.t[j] * a + dv.t[j];
}

}  // namespace

__global__ void __launch_bounds__(FT_VJP_THREADS)
leaf_vjp_kernel(const float* __restrict__ origin,
                const float* __restrict__ direction,
                const float* __restrict__ t, const float* __restrict__ epsilon,
                const bool* __restrict__ hit, const float* __restrict__ code,
                const float* __restrict__ sign,
                const float* __restrict__ ct_t,
                const float* __restrict__ ct_n, int n,
                const float* __restrict__ rows, FtKindSlots ks,
                float min_denom, float* __restrict__ bar,
                long long* __restrict__ idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float out[FT_PSTRIDE];
#pragma unroll
  for (int j = 0; j < FT_PSTRIDE; ++j) out[j] = 0.f;
  int slot = 0;
  const float c = code[i];
  if (hit[i] && c != 0.f) {
    slot = (int)fabsf(c) - 1;
    int kind = ks.kind[0];
    for (int q = 1; q < ks.n; ++q)
      if (slot >= ks.first[q]) kind = ks.kind[q];
    const float o[3] = {origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]};
    const float d[3] = {direction[3 * i], direction[3 * i + 1],
                        direction[3 * i + 2]};
    const float cn[3] = {ct_n[3 * i], ct_n[3 * i + 1], ct_n[3 * i + 2]};
    const float sgn = c > 0.f ? 1.f : -1.f;
    const float sg = sign ? sign[i] : 1.f;
    const float* row = rows + (long long)slot * FT_PSTRIDE;
    FT_KIND_SWITCH(kind, leaf_vjp_lane<K>(row, sgn, sg, o, d, t[i],
                                          epsilon[i], ct_t[i], cn, min_denom,
                                          out))
  }
#pragma unroll
  for (int j = 0; j < FT_PSTRIDE; ++j) bar[(long long)j * n + i] = out[j];
  idx[i] = slot;
}

// origin, direction, ct_n: n x 3; t, epsilon, code, ct_t, sign (or null):
// n; hit: n bools; rows: the scene's [K, FT_PSTRIDE] rows in slot order;
// kinds: 2 * n_kinds host ints (kind, first slot) in slot order; outputs
// bar [FT_PSTRIDE, n] and idx [n] (the lane's global slot, 0 on a lane
// that adds nothing).
extern "C" int ft_leaf_vjp(const float* origin, const float* direction,
                           const float* t, const float* epsilon,
                           const bool* hit, const float* code,
                           const float* sign, const float* ct_t,
                           const float* ct_n, int n, const float* rows,
                           const int* kinds, int n_kinds, float min_denom,
                           float* bar, long long* idx, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n_kinds < 1 || n_kinds > FT_MAX_KINDS)
    return (int)cudaErrorInvalidValue;
  FtKindSlots ks{};
  ks.n = n_kinds;
  for (int q = 0; q < n_kinds; ++q) {
    ks.kind[q] = kinds[2 * q];
    ks.first[q] = kinds[2 * q + 1];
  }
  const int grid = (n + FT_VJP_THREADS - 1) / FT_VJP_THREADS;
  leaf_vjp_kernel<<<grid, FT_VJP_THREADS, 0, (cudaStream_t)stream>>>(
      origin, direction, t, epsilon, hit, code, sign, ct_t, ct_n, n, rows, ks,
      min_denom, bar, idx);
  return (int)cudaGetLastError();
}
