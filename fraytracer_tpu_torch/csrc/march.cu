// K1 (march), K2 (occlusion) and K3 (surface pass, slot mode): the dense
// sphere-trace kernels of the forward frame.
//
// Replaces: fraytracer_tpu/ops/pallas/march_kernel.py::_build_kernel, the
// three programs launched by pallas_march_raw — mode="march" (kernel,
// :1637), mode="occlusion" (same body, hit output only) and mode="surface"
// (surf_kernel :1606 with surface_eval_slot :1022), in their dense form
// (cull=False: no candidate tables, every primitive evaluated each step).
//
// What bounds it on an H100: arithmetic.  A step of one ray evaluates every
// primitive of the scene (about 30 flops and 2 square roots per torus), so
// a 1024^2 frame against 1000 tori is ~1e12 flops; the ray state (~40
// bytes) and the scene (40 bytes a primitive, 40 KB at 1000 tori) are
// tiny, and parameters are read through the read-only cache.
//
// Design, simple first:
// - one thread per ray over a 1-D grid; rays are flat [N] (origin and
//   direction [N, 3]); there is no padding, the grid masks the ragged end;
// - the scene is not compiled into the kernel: the host lowers the CSG
//   plan to a small program (groups of primitives with a min/max/sumexp
//   reduction + the tree in postfix) that every thread interprets with a
//   fixed-depth value stack (ft_sdf.cuh).  All threads of a warp read the
//   same primitive at the same time, so __ldg reads are broadcasts;
// - each lane stops at its own hit / budget / max_steps: a per-thread cap
//   of max_steps evaluations reproduces the TPU tile loop's i < max_steps,
//   since a lane there evaluates once per tile iteration while active;
// - omega-relaxed stepping with the overstep revert and the
//   budget-crossing rule of march_kernel.py:1697-1722, exactly;
// - the surface pass evaluates the CSG-winning leaf once more with dual
//   numbers, so the normal is that leaf's exact gradient.
// Later work (ROADMAP): candidate culling, shared-memory staging of the
// parameters, a warp-cooperative layout.
#include "ft_sdf.cuh"

// ---------------------------------------------------------------------------
// K1 / K2
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128)
march_kernel(const float* __restrict__ origin, const float* __restrict__ dir,
             const float* __restrict__ length, const float* __restrict__ eps,
             const float* __restrict__ t0, int n, FtProgram P, int max_steps,
             float omega, int occlusion, float* __restrict__ t_out,
             int* __restrict__ hit_out, float* __restrict__ d_out,
             int* __restrict__ steps_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = origin[3 * i], oy = origin[3 * i + 1], oz = origin[3 * i + 2];
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float L = length[i], e = eps[i];
  float t = t0[i];
  bool active = (L > 0.f) && (t < L);
  bool hit = false;
  float d_last = FT_BIG;
  int steps = 0;
  const bool relaxed = omega > 1.f;
  float d_start = FT_BIG, step_taken = 0.f;

  for (int it = 0; active && it < max_steps; ++it) {
    const float d = scene_distance(P, ox + t * dx, oy + t * dy, oz + t * dz);
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
  hit_out[i] = hit ? 1 : 0;
  steps_out[i] = steps;
  if (!occlusion) {
    t_out[i] = t;
    d_out[i] = d_last;
  }
}

// ---------------------------------------------------------------------------
// K3: slot-mode surface pass
// ---------------------------------------------------------------------------

// argmin of the raw leaf distance over CSG-visible slots; equal distances
// go to the lower slot
struct MaterialArgmin {
  const int* ent_mat;
  const int* ent_slot;
  float md = FT_BIG;
  int mat = -1, mslot = 0x7fffffff;
  __device__ __forceinline__ void operator()(float d, int e) {
    const int m = __ldg(ent_mat + e);
    if (m < 0) return;
    const int slot = __ldg(ent_slot + e);
    if (d < md || (d == md && slot < mslot)) {
      md = d;
      mat = m;
      mslot = slot;
    }
  }
};

__global__ void __launch_bounds__(128)
surface_kernel(const float* __restrict__ origin, const float* __restrict__ dir,
               const float* __restrict__ tt, const float* __restrict__ eps,
               const int* __restrict__ hitm, int n, FtProgram P,
               float* __restrict__ normal, int* __restrict__ midx_out,
               float* __restrict__ code_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!hitm[i]) {
    normal[3 * i] = 0.f;
    normal[3 * i + 1] = 0.f;
    normal[3 * i + 2] = 1.f;
    midx_out[i] = -1;
    code_out[i] = 0.f;
    return;
  }
  // backed-off point (SdfObject.fs:73)
  const float ts = tt[i] - eps[i];
  const float px = origin[3 * i] + ts * dir[3 * i];
  const float py = origin[3 * i + 1] + ts * dir[3 * i + 1];
  const float pz = origin[3 * i + 2] + ts * dir[3 * i + 2];

  MaterialArgmin material{P.ent_mat, P.ent_slot};
  const float code = eval_scene<DistCode>(P, px, py, pz, material).code;

  // the winning leaf's exact gradient (forward-mode dual numbers)
  float gx = 0.f, gy = 0.f, gz = 0.f;
  if (code != 0.f) {
    const int slot = (int)fabsf(code) - 1;
    const int e = __ldg(P.slot_entry + slot);
    const Dual g = prim_dist(__ldg(P.ent_kind + e),
                             P.ent_params + (size_t)e * FT_PSTRIDE,
                             Dual{px, 1.f, 0.f, 0.f}, Dual{py, 0.f, 1.f, 0.f},
                             Dual{pz, 0.f, 0.f, 1.f});
    const float sgn = code < 0.f ? -1.f : 1.f;  // subtract flips the b side
    gx = sgn * g.x;
    gy = sgn * g.y;
    gz = sgn * g.z;
  }
  const float inv = rsqrtf(gx * gx + gy * gy + gz * gz + 1e-20f);
  normal[3 * i] = gx * inv;
  normal[3 * i + 1] = gy * inv;
  normal[3 * i + 2] = gz * inv;
  midx_out[i] = material.mat;
  code_out[i] = code;
}

// ---------------------------------------------------------------------------
// C entry points (bound with ctypes by ops/cuda/march_kernel.py)
// ---------------------------------------------------------------------------

static inline int blocks_for(int n, int threads) {
  return (n + threads - 1) / threads;
}

extern "C" int ft_march(const float* origin, const float* dir,
                        const float* length, const float* eps, const float* t0,
                        int n, const FtProgram* prog, int max_steps,
                        float omega, int occlusion, float* t_out, int* hit_out,
                        float* d_out, int* steps_out, void* stream) {
  if (n > 0) {
    march_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        origin, dir, length, eps, t0, n, *prog, max_steps, omega, occlusion,
        t_out, hit_out, d_out, steps_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int ft_surface(const float* origin, const float* dir,
                          const float* t, const float* eps, const int* hit,
                          int n, const FtProgram* prog, float* normal,
                          int* midx, float* code, void* stream) {
  if (n > 0) {
    surface_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        origin, dir, t, eps, hit, n, *prog, normal, midx, code);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
