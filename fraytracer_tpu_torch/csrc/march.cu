// K1 (march), K2 (occlusion) and K3 (surface pass, slot mode and AD mode):
// the sphere-trace kernels of the forward frame, dense and culled.
//
// Replaces: fraytracer_tpu/ops/pallas/march_kernel.py::_build_kernel, the
// three programs launched by pallas_march_raw — mode="march" (kernel,
// :1637), mode="occlusion" (same body, hit output only) and mode="surface"
// (surf_kernel :1606 with surface_eval_slot :1022 for plans of min/max
// alone, surface_eval :1304 for plans with a smooth union) — in their dense
// form (cull=False: every primitive each step) and their culled form
// (per-tile candidate tables: culled_pass :877-980 with _pair_window :641
// in K1/K2, culled_sp :1051-1144 and the normal sweep :1231-1269 in K3
// slot mode, culled_sp :1359-1456 in K3 AD mode).
//
// What bounds it on an H100: arithmetic and its instruction overhead.  A
// dense step of one ray evaluates every primitive (about 30 flops and 2
// square roots per torus, 1002 primitives on the benchmark scene); a
// culled step evaluates the dense rest plus the window chunks of its
// warp's tile table (tens of candidates).  Ray state (~40 bytes), the
// program and the tables (48 bytes a row, <= 25 MB at 1024^2) are read
// through the read-only cache; a warp reads the same row at once.
//
// Design, simple first:
// - one thread per ray over a 1-D grid; rays are flat [N] (origin and
//   direction [N, 3]); the grid masks the ragged end, and lanes past N
//   stay in the loop as inactive lanes (the window is warp-collective);
// - the scene is not compiled into the kernel: the host lowers the CSG
//   plan to a small program (groups of primitives with a min/max/sumexp
//   reduction + the tree in postfix) that every thread interprets with a
//   fixed-depth value stack (ft_sdf.cuh).  All threads of a warp read the
//   same primitive at the same time, so __ldg reads are broadcasts;
// - culled groups read the tile's candidate table (a tile = 1024 lanes =
//   one 32x32 screen block) through a window computed per warp: the TPU
//   kernel's window spans its whole tile, a warp's is narrower and keeps
//   the scan warp-uniform (no divergence, broadcast reads);
// - the march loop runs while any lane of the warp is active; a lane
//   evaluates once per iteration while active, so a cap of max_steps
//   iterations reproduces the TPU tile loop's i < max_steps per lane;
// - omega-relaxed stepping with the overstep revert and the
//   budget-crossing rule of march_kernel.py:1697-1722, exactly;
// - the surface pass evaluates the CSG-winning leaf once more with dual
//   numbers, so the normal is that leaf's exact gradient.
// Later work (ROADMAP): shared-memory staging of the tables and
// parameters, a warp-cooperative layout.
#include "ft_sdf.cuh"

// ---------------------------------------------------------------------------
// K1 / K2
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128)
march_kernel(const float* __restrict__ origin, const float* __restrict__ dir,
             const float* __restrict__ length, const float* __restrict__ eps,
             const float* __restrict__ t0, const float* __restrict__ sign,
             int n, FtProgram P, FtCull C, int max_steps, float omega,
             int occlusion,
             float* __restrict__ t_out, int* __restrict__ hit_out,
             float* __restrict__ d_out, int* __restrict__ steps_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float L = 0.f, t = 0.f, sgn = 1.f;
  Lane lane;
  lane.tile = (i & ~31) / FT_TILE;   // the warp's tile (its first lane < n)
  lane.oa = lane.ca = 0.f;
  lane.eps = 1.f;
  if (valid) {
    ox = origin[3 * i]; oy = origin[3 * i + 1]; oz = origin[3 * i + 2];
    dx = dir[3 * i]; dy = dir[3 * i + 1]; dz = dir[3 * i + 2];
    L = length[i];
    t = t0[i];
    lane.eps = eps[i];
    if (sign != nullptr) sgn = sign[i];
    if (C.n_pairs > 0) {
      lane.oa = C.oa[i];
      lane.ca = C.ca[i];
    }
  }
  const float e = lane.eps;
  bool active = valid && (L > 0.f) && (t < L);
  bool hit = false;
  float d_last = FT_BIG;
  int steps = 0;
  const bool relaxed = omega > 1.f;
  float d_start = FT_BIG, step_taken = 0.f;

  for (int it = 0; it < max_steps; ++it) {
    if (!__any_sync(FT_FULL_MASK, active)) break;
    lane.t = t;
    lane.active = active;
    // every lane of the warp evaluates (the culled window is collective).
    // Per-lane sign: -1 marches inside the solid toward its exit surface.
    // The windows stay sound for such a lane: the bound of a primitive
    // that contains the point contains it too, so that primitive is never
    // window-skipped, and the capped union min is the true (negative)
    // distance there.
    const float d = sgn * scene_distance(P, C, lane, ox + t * dx, oy + t * dy,
                                         oz + t * dz);
    if (!active) continue;
    ++steps;
    if (relaxed) {
      // overstep: the relaxed step left the union of the two safety
      // spheres -> revert to the conservative landing point
      const bool over = step_taken > d_start + d;
      const bool is_hit = !over && d < e;
      const float step_rel = omega * d;
      // a relaxed step that would cross the budget falls back to d
      const float step_new = (t + step_rel >= L) ? d : step_rel;
      const float adv = (over || is_hit) ? 0.f : step_new;
      const float t_new = over ? (t - step_taken) + d_start : t + adv;
      const bool still = over || (!is_hit && t_new < L);
      if ((still && !over) || is_hit) d_last = d;
      step_taken = over ? d_start : adv;
      d_start = over ? d_start : d;
      t = t_new;
      hit = hit || is_hit;
      active = still;
    } else {
      const bool is_hit = d < e;
      const float t_new = is_hit ? t : t + d;
      const bool still = !is_hit && t_new < L;
      if (still || is_hit) d_last = d;
      t = t_new;
      hit = hit || is_hit;
      active = still;
    }
  }
  if (!valid) return;
  hit_out[i] = hit ? 1 : 0;
  steps_out[i] = steps;
  if (!occlusion) {
    t_out[i] = t;
    d_out[i] = d_last;
  }
}

// ---------------------------------------------------------------------------
// K3: slot-mode surface pass (plans of min/max alone)
// ---------------------------------------------------------------------------

// argmin of the raw leaf distance over CSG-visible slots; equal distances
// go to the lower slot
struct MaterialArgmin {
  float md = FT_BIG;
  int mat = -1, mslot = 0x7fffffff;
  __device__ __forceinline__ void operator()(float d, int m, int slot) {
    if (m < 0) return;
    if (d < md || (d == md && slot < mslot)) {
      md = d;
      mat = m;
      mslot = slot;
    }
  }
};

// One lane of a surface pass: a miss lane writes normal (0, 0, 1),
// material -1, code 0 and returns false; a hit lane gets its backed-off
// point (SdfObject.fs:73) and its Lane (the surface scan needs no window).
__device__ __forceinline__ bool surface_lane(
    const float* origin, const float* dir, const float* tt, const float* eps,
    const int* hitm, int i, float* normal, int* midx_out, float* code_out,
    float& px, float& py, float& pz, Lane& lane) {
  if (!hitm[i]) {
    normal[3 * i] = 0.f;
    normal[3 * i + 1] = 0.f;
    normal[3 * i + 2] = 1.f;
    midx_out[i] = -1;
    code_out[i] = 0.f;
    return false;
  }
  const float ts = tt[i] - eps[i];
  px = origin[3 * i] + ts * dir[3 * i];
  py = origin[3 * i + 1] + ts * dir[3 * i + 1];
  pz = origin[3 * i + 2] + ts * dir[3 * i + 2];
  lane.tile = i / FT_TILE;
  lane.oa = lane.ca = lane.t = 0.f;
  lane.eps = eps[i];
  lane.active = true;
  return true;
}

__device__ __forceinline__ void write_normal(float* normal, int i, float gx,
                                             float gy, float gz) {
  const float inv = rsqrtf(gx * gx + gy * gy + gz * gz + 1e-20f);
  normal[3 * i] = gx * inv;
  normal[3 * i + 1] = gy * inv;
  normal[3 * i + 2] = gz * inv;
}

__global__ void __launch_bounds__(128)
surface_kernel(const float* __restrict__ origin, const float* __restrict__ dir,
               const float* __restrict__ tt, const float* __restrict__ eps,
               const int* __restrict__ hitm, int n, FtProgram P, FtCull C,
               float* __restrict__ normal, int* __restrict__ midx_out,
               float* __restrict__ code_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float px, py, pz;
  Lane lane;
  if (!surface_lane(origin, dir, tt, eps, hitm, i, normal, midx_out, code_out,
                    px, py, pz, lane)) {
    return;
  }
  MaterialArgmin material;
  const float code =
      eval_scene<DistCode>(P, C, lane, px, py, pz, material).code;

  // the winning leaf's exact gradient (forward-mode dual numbers)
  float gx = 0.f, gy = 0.f, gz = 0.f;
  if (code != 0.f) {
    const int slot = (int)fabsf(code) - 1;
    const int e = __ldg(P.slot_entry + slot);
    const Dual g = prim_dual(__ldg(P.ent_kind + e),
                             P.ent_params + (size_t)e * FT_PSTRIDE, px, py,
                             pz);
    const float sgn = code < 0.f ? -1.f : 1.f;  // subtract flips the b side
    gx = sgn * g.x;
    gy = sgn * g.y;
    gz = sgn * g.z;
  }
  write_normal(normal, i, gx, gy, gz);
  midx_out[i] = material.mat;
  code_out[i] = code;
}

// ---------------------------------------------------------------------------
// K3: AD-mode surface pass (plans with a smooth union)
// ---------------------------------------------------------------------------
//
// Replaces surface_eval (march_kernel.py:1304; its culled scan :1359-1456,
// the sumexp resolve :1520-1528, the tree fold ev_g :1530-1565) behind the
// surface pallas_call (:2076).  A smooth union blends its operands, so no
// single leaf owns the hit point: the scene is evaluated once with the
// stack value DistGrad = (distance, gradient).  A min/max group scans its
// members' float distances and evaluates the gradient of the first
// extremum alone (one dual-number evaluation per group and culled pair); a
// sumexp group needs every member's gradient and sums e and e * gradient,
// e = exp(-d / k), one loop whatever the group's size; the tree selects
// (union, intersect), negates the b side (subtract) or blends again
// (smooth union).  Culled pairs scan the tile's whole candidate list, as
// slot mode does (ft_sdf.cuh culled_pair).  The code output is 0 on every
// lane: no leaf.  expf, not __expf: the weights decide the blend.
//
// What bounds it on an H100: bytes.  A lane reads 44 bytes (origin,
// direction, t, epsilon, hit) and writes 20 (normal, material, code); its
// arithmetic — the dense entries, tens of table candidates on a hit lane
// and a few dual evaluations — is below that at the card's fp32 rate.  One
// thread per lane, miss lanes return at once; the value stack of 16
// DistGrad lives in local memory (see the build log for registers).
__global__ void __launch_bounds__(128)
surface_ad_kernel(const float* __restrict__ origin,
                  const float* __restrict__ dir, const float* __restrict__ tt,
                  const float* __restrict__ eps, const int* __restrict__ hitm,
                  int n, FtProgram P, FtCull C, float* __restrict__ normal,
                  int* __restrict__ midx_out, float* __restrict__ code_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float px, py, pz;
  Lane lane;
  if (!surface_lane(origin, dir, tt, eps, hitm, i, normal, midx_out, code_out,
                    px, py, pz, lane)) {
    return;
  }
  MaterialArgmin material;
  const DistGrad g = eval_scene<DistGrad>(P, C, lane, px, py, pz, material);
  write_normal(normal, i, g.x, g.y, g.z);
  midx_out[i] = material.mat;
  code_out[i] = 0.f;
}

// ---------------------------------------------------------------------------
// C entry points (bound with ctypes by ops/cuda/march_kernel.py)
// ---------------------------------------------------------------------------

static inline int blocks_for(int n, int threads) {
  return (n + threads - 1) / threads;
}

extern "C" int ft_march(const float* origin, const float* dir,
                        const float* length, const float* eps, const float* t0,
                        const float* sign, int n, const FtProgram* prog,
                        const FtCull* cull,
                        int max_steps, float omega, int occlusion,
                        float* t_out, int* hit_out, float* d_out,
                        int* steps_out, void* stream) {
  if (n > 0) {
    march_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        origin, dir, length, eps, t0, sign, n, *prog, *cull, max_steps, omega,
        occlusion, t_out, hit_out, d_out, steps_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int ft_surface(const float* origin, const float* dir,
                          const float* t, const float* eps, const int* hit,
                          int n, const FtProgram* prog, const FtCull* cull,
                          float* normal, int* midx, float* code,
                          void* stream) {
  if (n > 0) {
    surface_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        origin, dir, t, eps, hit, n, *prog, *cull, normal, midx, code);
  }
  return (int)cudaGetLastError();
}

extern "C" int ft_surface_ad(const float* origin, const float* dir,
                             const float* t, const float* eps, const int* hit,
                             int n, const FtProgram* prog, const FtCull* cull,
                             float* normal, int* midx, float* code,
                             void* stream) {
  if (n > 0) {
    surface_ad_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        origin, dir, t, eps, hit, n, *prog, *cull, normal, midx, code);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
