// Shared device code of the march and surface kernels: the flattened
// scene program, the seven primitive distance functions (written once,
// templated over the scalar type: float for marching, a 3-component
// forward-mode dual number for exact gradients), the scene program
// interpreter, and the culled groups' candidate-table passes.
//
// The formulas are those of fraytracer_tpu_torch/ops/sdf.py (the plain
// PyTorch versions the kernels are held against), which are algebraically
// the same as the TPU kernel's _d_*_gen functions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define FT_BIG 3.0e38f
#define FT_PSTRIDE 10    // floats per primitive row (widest kind: triangle)
#define FT_MAX_STACK 16  // CSG value-stack depth; the host checks plans
// culled tables (ops/cuda/cull.py: TILE, CAND_UNROLL, PSTRIDE + 2, MAX_PAIRS)
#define FT_TILE 1024       // rays per candidate table
#define FT_CAND_UNROLL 8   // table rows per window chunk
#define FT_TABLE_W 12      // floats per table row: params, material, slot
#define FT_MAX_PAIRS 8     // culled (group, kind) pairs per launch
#define FT_FULL_MASK 0xffffffffu

// primitive kinds, in the flattener's KINDS order
enum { K_SPHERE = 0, K_CAPSULE, K_TORUS, K_TRIANGLE, K_BOX, K_CONE, K_PLANE };
// postfix tree opcodes
enum { OP_GROUP = 0, OP_UNION, OP_INTERSECT, OP_SUBTRACT, OP_SMOOTH };
// group reductions
enum { G_MIN = 0, G_MAX, G_SUMEXP };

// The scene lowered to a small program (built by ops/cuda/march_kernel.py,
// mirrored there as a ctypes Structure — keep the field order in step).
// Entries are the primitives ordered by group, members of a group in
// ascending global slot; each group is one contiguous entry range.  The
// rows of culled pairs come after every group's range: their group reads
// them from the per-tile candidate tables (FtCull), and K3 finds the
// winning leaf's parameters through slot_entry.
struct FtProgram {
  const int* ops;           // [n_ops * 2] (opcode, arg): arg = group id or
                            // operand count
  const float* op_k;        // [n_ops] smooth-union strength
  int n_ops;
  const int* groups;        // [n_groups * 3] (entry start, entry end, op)
  const float* group_k;     // [n_groups]
  int n_groups;
  const int* ent_kind;      // [n_ent]
  const int* ent_slot;      // [n_ent] global slot
  const int* ent_mat;       // [n_ent] CSG-visible material, -1 = none
  const float* ent_params;  // [n_ent * FT_PSTRIDE]; torus axes unit length
  int n_ent;
  const int* slot_entry;    // [n_slots] entry of a global slot
  int n_slots;
  const int* group_pairs;   // [n_groups * 2] the group's pairs [start, end)
};

// One culled (group, kind) pair: per-tile tables built on the host
// (ops/cuda/cull.py build_pair_tables), G = number of ray tiles.
struct FtPair {
  const float* table;  // [G, m, FT_TABLE_W] candidates, ascending axial key
  const float* keys;   // [G, 2, m / FT_CAND_UNROLL] chunk max(a+r), min(a-r)
  const float* misc;   // [G, 4] count, cos_lo, window clamp, surface margin
  const float* hsuf;   // [G, m / FT_CAND_UNROLL] suffix-min of a-r per chunk
  int m;               // table rows per tile (whole chunks)
  int kind;            // primitive kind of every row
  int group_size;      // the pair's rows (count < group_size: cone-excluded)
  int pad_;
};

// What a launch reads besides rays and program; n_pairs == 0 is the dense
// form.
struct FtCull {
  const float* oa;  // [n] (origin - apex) . axis of the lane's tile cone
  const float* ca;  // [n] direction . axis
  int n_pairs;
  int early_out;    // running-min early-out of min-group windows
  FtPair pairs[FT_MAX_PAIRS];
};

// A lane as the culled passes see it.  K1/K2 call the scene with every
// lane of a warp (inactive ones included): the window is warp-collective.
struct Lane {
  int tile;       // the warp's ray tile
  float oa, ca;   // axial origin offset and direction cosine
  float t, eps;   // ray parameter of this step, hit threshold
  bool active;    // takes part in the window statistics
};

// ---------------------------------------------------------------------------
// forward-mode dual number: value + gradient w.r.t. the query point
// ---------------------------------------------------------------------------

struct Dual {
  float v, x, y, z;
};

__device__ __forceinline__ Dual dual(float v) { return {v, 0.f, 0.f, 0.f}; }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return {a.v + b.v, a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return {a.v - b.v, a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ Dual operator-(Dual a) {
  return {-a.v, -a.x, -a.y, -a.z};
}
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.x * b.v + a.v * b.x, a.y * b.v + a.v * b.y,
          a.z * b.v + a.v * b.z};
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  float inv = 1.f / b.v;
  float q = a.v / b.v;
  return {q, (a.x - q * b.x) * inv, (a.y - q * b.y) * inv,
          (a.z - q * b.z) * inv};
}
__device__ __forceinline__ Dual operator+(Dual a, float b) {
  return {a.v + b, a.x, a.y, a.z};
}
__device__ __forceinline__ Dual operator+(float a, Dual b) { return b + a; }
__device__ __forceinline__ Dual operator-(Dual a, float b) {
  return {a.v - b, a.x, a.y, a.z};
}
__device__ __forceinline__ Dual operator-(float a, Dual b) {
  return {a - b.v, -b.x, -b.y, -b.z};
}
__device__ __forceinline__ Dual operator*(Dual a, float b) {
  return {a.v * b, a.x * b, a.y * b, a.z * b};
}
__device__ __forceinline__ Dual operator*(float a, Dual b) { return b * a; }
__device__ __forceinline__ Dual operator/(Dual a, float b) {
  return {a.v / b, a.x / b, a.y / b, a.z / b};
}

__device__ __forceinline__ float val(float a) { return a; }
__device__ __forceinline__ float val(Dual a) { return a.v; }

__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual sqrt_(Dual a) {
  float s = sqrtf(a.v);
  float h = 0.5f / s;
  return {s, a.x * h, a.y * h, a.z * h};
}
template <typename T>
__device__ __forceinline__ T max_(T a, T b) { return val(a) >= val(b) ? a : b; }
template <typename T>
__device__ __forceinline__ T min_(T a, T b) { return val(a) <= val(b) ? a : b; }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
// constant promoted to the scalar type of the second argument
__device__ __forceinline__ float dual_or(float c, float) { return c; }
__device__ __forceinline__ Dual dual_or(float c, Dual) { return dual(c); }
template <typename T>
__device__ __forceinline__ T cmax(T a, float b) {
  return val(a) >= b ? a : dual_or(b, a);
}
template <typename T>
__device__ __forceinline__ T cmin(T a, float b) {
  return val(a) <= b ? a : dual_or(b, a);
}
template <typename T>
__device__ __forceinline__ T clamp01(T a) { return cmin(cmax(a, 0.f), 1.f); }
template <typename T>
__device__ __forceinline__ T abs_(T a) { return val(a) < 0.f ? -a : a; }
template <typename T>
__device__ __forceinline__ float sign_(T a) {
  float v = val(a);
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float ld(const float* g, int j) {
  return __ldg(g + j);
}

// ---------------------------------------------------------------------------
// the seven distance functions (ops/sdf.py formulas)
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T d_sphere(const float* g, T px, T py, T pz) {
  T dx = px - ld(g, 0), dy = py - ld(g, 1), dz = pz - ld(g, 2);
  return sqrt_(dx * dx + dy * dy + dz * dz + 1e-20f) - ld(g, 3);
}

template <typename T>
__device__ __forceinline__ T d_capsule(const float* g, T px, T py, T pz) {
  float ax = ld(g, 0), ay = ld(g, 1), az = ld(g, 2);
  float bax = ld(g, 3) - ax, bay = ld(g, 4) - ay, baz = ld(g, 5) - az;
  T pax = px - ax, pay = py - ay, paz = pz - az;
  float denom = fmaxf(bax * bax + bay * bay + baz * baz, 1e-20f);
  T h = clamp01((pax * bax + pay * bay + paz * baz) / denom);
  T ex = pax - h * bax, ey = pay - h * bay, ez = paz - h * baz;
  return sqrt_(ex * ex + ey * ey + ez * ez + 1e-20f) - ld(g, 6);
}

template <typename T>
__device__ __forceinline__ T d_torus(const float* g, T px, T py, T pz) {
  // axis (g[3..5]) is normalized host-side with the plain version's formula
  float nx = ld(g, 3), ny = ld(g, 4), nz = ld(g, 5);
  T qx = px - ld(g, 0), qy = py - ld(g, 1), qz = pz - ld(g, 2);
  T h = qx * nx + qy * ny + qz * nz;
  T wx = qx - h * nx, wy = qy - h * ny, wz = qz - h * nz;
  T radial = sqrt_(wx * wx + wy * wy + wz * wz + 1e-20f) - ld(g, 6);
  return sqrt_(h * h + radial * radial + 1e-20f) - ld(g, 7);
}

template <typename T>
__device__ __forceinline__ T edge_d2(float ex, float ey, float ez, T qx, T qy,
                                     T qz) {
  float denom = fmaxf(ex * ex + ey * ey + ez * ez, 1e-20f);
  T h = clamp01((qx * ex + qy * ey + qz * ez) / denom);
  T ux = qx - h * ex, uy = qy - h * ey, uz = qz - h * ez;
  return ux * ux + uy * uy + uz * uz;
}

template <typename T>
__device__ __forceinline__ T d_triangle(const float* g, T px, T py, T pz) {
  float v1x = ld(g, 0), v1y = ld(g, 1), v1z = ld(g, 2);
  float v2x = ld(g, 3), v2y = ld(g, 4), v2z = ld(g, 5);
  float v3x = ld(g, 6), v3y = ld(g, 7), v3z = ld(g, 8);
  float ax = v2x - v1x, ay = v2y - v1y, az = v2z - v1z;  // v21
  float bx = v3x - v2x, by = v3y - v2y, bz = v3z - v2z;  // v32
  float cx = v1x - v3x, cy = v1y - v3y, cz = v1z - v3z;  // v13
  // nor = cross(v21, v13)
  float nx = ay * cz - az * cy, ny = az * cx - ax * cz, nz = ax * cy - ay * cx;
  T p1x = px - v1x, p1y = py - v1y, p1z = pz - v1z;
  T p2x = px - v2x, p2y = py - v2y, p2z = pz - v2z;
  T p3x = px - v3x, p3y = py - v3y, p3z = pz - v3z;
  T d2e = min_(edge_d2(ax, ay, az, p1x, p1y, p1z),
               min_(edge_d2(bx, by, bz, p2x, p2y, p2z),
                    edge_d2(cx, cy, cz, p3x, p3y, p3z)));
  // inside test: signs of the edge half-planes, cross(edge, nor) · p_i
  float s = sign_((ay * nz - az * ny) * p1x + (az * nx - ax * nz) * p1y +
                  (ax * ny - ay * nx) * p1z) +
            sign_((by * nz - bz * ny) * p2x + (bz * nx - bx * nz) * p2y +
                  (bx * ny - by * nx) * p2z) +
            sign_((cy * nz - cz * ny) * p3x + (cz * nx - cx * nz) * p3y +
                  (cx * ny - cy * nx) * p3z);
  float nor2 = fmaxf(nx * nx + ny * ny + nz * nz, 1e-20f);
  T h = nx * p1x + ny * p1y + nz * p1z;
  T d2f = h * h / nor2;
  return sqrt_((s >= 2.f ? d2f : d2e) + 1e-20f) - ld(g, 9);
}

template <typename T>
__device__ __forceinline__ T d_box(const float* g, T px, T py, T pz) {
  T qx = abs_(px - ld(g, 0)) - ld(g, 3);
  T qy = abs_(py - ld(g, 1)) - ld(g, 4);
  T qz = abs_(pz - ld(g, 2)) - ld(g, 5);
  T ox = cmax(qx, 0.f), oy = cmax(qy, 0.f), oz = cmax(qz, 0.f);
  T outside = sqrt_(ox * ox + oy * oy + oz * oz + 1e-20f);
  T inside = cmin(max_(max_(qx, qy), qz), 0.f);
  return outside + inside - ld(g, 6);
}

template <typename T>
__device__ __forceinline__ T d_cone(const float* g, T px, T py, T pz) {
  float ax = ld(g, 0), ay = ld(g, 1), az = ld(g, 2);
  float bax = ld(g, 3) - ax, bay = ld(g, 4) - ay, baz = ld(g, 5) - az;
  float ra = ld(g, 6), rb = ld(g, 7);
  float rba = rb - ra;
  float baba = fmaxf(bax * bax + bay * bay + baz * baz, 1e-20f);
  T pax = px - ax, pay = py - ay, paz = pz - az;
  T papa = pax * pax + pay * pay + paz * paz;
  T paba = (pax * bax + pay * bay + paz * baz) / baba;
  T x = sqrt_(cmax(papa - paba * paba * baba, 1e-20f));
  T cax = cmax(x - (val(paba) < 0.5f ? ra : rb), 0.f);
  T cay = abs_(paba - 0.5f) - 0.5f;
  float k = rba * rba + baba;
  T f = clamp01((rba * (x - ra) + paba * baba) / k);
  T cbx = x - ra - f * rba;
  T cby = paba - f;
  float s = (val(cbx) < 0.f && val(cay) < 0.f) ? -1.f : 1.f;
  return s * sqrt_(min_(cax * cax + cay * cay * baba,
                        cbx * cbx + cby * cby * baba) + 1e-20f);
}

template <typename T>
__device__ __forceinline__ T d_plane(const float* g, T px, T py, T pz) {
  return px * ld(g, 0) + py * ld(g, 1) + pz * ld(g, 2) - ld(g, 3);
}

template <typename T>
__device__ __forceinline__ T prim_dist(int kind, const float* g, T px, T py,
                                       T pz) {
  switch (kind) {
    case K_SPHERE: return d_sphere(g, px, py, pz);
    case K_CAPSULE: return d_capsule(g, px, py, pz);
    case K_TORUS: return d_torus(g, px, py, pz);
    case K_TRIANGLE: return d_triangle(g, px, py, pz);
    case K_BOX: return d_box(g, px, py, pz);
    case K_CONE: return d_cone(g, px, py, pz);
    default: return d_plane(g, px, py, pz);
  }
}

// ---------------------------------------------------------------------------
// warp reductions of floats (order-preserving int image, sm_80+ redux)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int ft_ord(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float ft_unord(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}
__device__ __forceinline__ float warp_min(float x) {
  return ft_unord(__reduce_min_sync(FT_FULL_MASK, ft_ord(x)));
}
__device__ __forceinline__ float warp_max(float x) {
  return ft_unord(__reduce_max_sync(FT_FULL_MASK, ft_ord(x)));
}

// ---------------------------------------------------------------------------
// scene program interpreter
// ---------------------------------------------------------------------------
//
// One interpreter, three stack value types:
// - Dist, the distance alone (K1/K2);
// - DistCode, the distance and the signed code +-(slot + 1) of the
//   CSG-winning leaf (K3, slot mode): min/max keep the first extremum,
//   subtract flips the sign of its b side.  A smooth reduction names no
//   single leaf (code 0); the host keeps smooth plans out of slot mode;
// - DistGrad, the distance and its gradient at the query point (K3, AD
//   mode, the plans with a smooth union): min/max keep the first
//   extremum's gradient, subtract negates its b side's, a smooth reduction
//   blends the gradients with the weights e = exp(-d / k).  A value that
//   no leaf owns (an empty group, a floored max group) has gradient
//   (0, 0, 1).
// The per-type rules are the overloads below; on_prim(d, mat, slot) sees
// every primitive distance (K3's material argmin).  A group with culled
// pairs folds each pair first (culled_pair: the windowed march pass for
// Dist, the whole-table surface scan for DistCode and DistGrad), then its
// dense entries.

struct Dist {
  float v;
};
struct DistCode {
  float v, code;
};
struct DistGrad {
  float v, x, y, z;
};

// a value that no leaf owns
__device__ __forceinline__ void smooth_value(Dist& a, float v) { a.v = v; }
__device__ __forceinline__ void smooth_value(DistCode& a, float v) {
  a = {v, 0.f};
}
__device__ __forceinline__ void smooth_value(DistGrad& a, float v) {
  a = {v, 0.f, 0.f, 1.f};
}

// exact gradient of one primitive's distance (forward-mode dual numbers)
__device__ __forceinline__ Dual prim_dual(int kind, const float* g, float px,
                                          float py, float pz) {
  return prim_dist(kind, g, Dual{px, 1.f, 0.f, 0.f}, Dual{py, 0.f, 1.f, 0.f},
                   Dual{pz, 0.f, 0.f, 1.f});
}

// group member e with distance d; members run in ascending slot.  DistGrad
// only notes the winning entry (won): its gradient is evaluated once, after
// the group's last member (finish_members)
__device__ __forceinline__ void take_member(Dist& acc, int&, bool mn, float d,
                                            const FtProgram&, int) {
  acc.v = mn ? fminf(acc.v, d) : fmaxf(acc.v, d);
}
__device__ __forceinline__ void take_member(DistCode& acc, int&, bool mn,
                                            float d, const FtProgram& P,
                                            int e) {
  // strict compares keep the first extremum
  if (mn ? d < acc.v : d > acc.v) {
    acc = {d, (float)(__ldg(P.ent_slot + e) + 1)};
  }
}
__device__ __forceinline__ void take_member(DistGrad& acc, int& won, bool mn,
                                            float d, const FtProgram&, int e) {
  if (mn ? d < acc.v : d > acc.v) {
    acc.v = d;
    won = e;
  }
}
__device__ __forceinline__ void finish_members(Dist&, int, const FtProgram&,
                                               float, float, float) {}
__device__ __forceinline__ void finish_members(DistCode&, int,
                                               const FtProgram&, float, float,
                                               float) {}
__device__ __forceinline__ void finish_members(DistGrad& acc, int won,
                                               const FtProgram& P, float px,
                                               float py, float pz) {
  if (won < 0) return;
  const Dual g = prim_dual(__ldg(P.ent_kind + won),
                           P.ent_params + (size_t)won * FT_PSTRIDE, px, py,
                           pz);
  acc = {acc.v, g.x, g.y, g.z};
}
__device__ __forceinline__ Dist csg_subtract(Dist a, Dist b) {
  return {fmaxf(a.v, -b.v)};
}
__device__ __forceinline__ DistCode csg_subtract(DistCode a, DistCode b) {
  return a.v > -b.v ? a : DistCode{-b.v, -b.code};
}
__device__ __forceinline__ DistGrad csg_subtract(DistGrad a, DistGrad b) {
  return a.v > -b.v ? a : DistGrad{-b.v, -b.x, -b.y, -b.z};
}
// n-ary union / intersect: the earlier operand wins ties
__device__ __forceinline__ Dist csg_pick(Dist out, Dist v, bool uni) {
  return {uni ? fminf(out.v, v.v) : fmaxf(out.v, v.v)};
}
__device__ __forceinline__ DistCode csg_pick(DistCode out, DistCode v,
                                             bool uni) {
  return (uni ? out.v <= v.v : out.v >= v.v) ? out : v;
}
__device__ __forceinline__ DistGrad csg_pick(DistGrad out, DistGrad v,
                                             bool uni) {
  return (uni ? out.v <= v.v : out.v >= v.v) ? out : v;
}

// smooth union of n stack values: -k log(max(sum e, 1e-30)), e = exp(-v/k);
// the gradient is the e-weighted mean of the operands' gradients
template <typename V>
__device__ __forceinline__ V smooth_fold(const V* st, int n, float k) {
  float s = 0.f;
  for (int j = 0; j < n; ++j) s += expf(-st[j].v / k);
  V out;
  smooth_value(out, -k * logf(fmaxf(s, 1e-30f)));
  return out;
}
__device__ __forceinline__ DistGrad smooth_fold(const DistGrad* st, int n,
                                                float k) {
  float s = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  for (int j = 0; j < n; ++j) {
    const float e = expf(-st[j].v / k);
    s += e;
    sx += e * st[j].x;
    sy += e * st[j].y;
    sz += e * st[j].z;
  }
  s = fmaxf(s, 1e-30f);
  return {-k * logf(s), sx / s, sy / s, sz / s};
}

struct NoPrimHook {
  __device__ __forceinline__ void operator()(float, int, int) const {}
};

// K1/K2: one culled pair's windowed pass (march_kernel.py culled_pass
// :877-980 with _pair_window :641-697), collective over the warp.  The
// window is the hull of the chunks that are neither behind
// (max(a+r) < min p_ax - clamp) nor ahead (min(a-r) > max p_ax + clamp) of
// the warp's active lanes; each lane splits the chunk keys, and redux
// instructions combine the statistics.  A min group takes
// min(window min, cap) with the per-lane cap min(AH - p_ax, p_ax - BH)
// over the skipped chunks; a max group max(window max, skip_lb, excl),
// where excl = 2 eps floors a group whose cone excluded members.
template <typename OnPrim>
__device__ __forceinline__ void culled_pair(Dist& acc, const FtPair& q,
                                            const Lane& L, bool mn,
                                            int early_out, float px, float py,
                                            float pz, OnPrim&) {
  const int chunks = q.m / FT_CAND_UNROLL;
  const int lane = threadIdx.x & 31;
  const float* keys = q.keys + (size_t)L.tile * 2 * chunks;
  const float* misc = q.misc + (size_t)L.tile * 4;
  const float clamp = __ldg(misc + 2);
  // the plain version rounds o + t*c twice: no FMA here, same windows
  const float p_ax = __fadd_rn(L.oa, __fmul_rn(L.t, L.ca));
  const float plo = warp_min(L.active ? p_ax : FT_BIG);
  const float phi = warp_max(L.active ? p_ax : -FT_BIG);
  const float lo_lim = plo - clamp, hi_lim = phi + clamp;
  int w_lo = chunks, w_hi = 0;
  float bh = -FT_BIG, ah = FT_BIG, bh_min = FT_BIG, ah_max = -FT_BIG;
  bool any_b = false, any_a = false;
  for (int c = lane; c < chunks; c += 32) {
    const float lo = __ldg(keys + c), hi = __ldg(keys + chunks + c);
    const bool behind = lo < lo_lim, ahead = hi > hi_lim;
    if (!behind && !ahead) {
      w_lo = min(w_lo, c);
      w_hi = max(w_hi, c + 1);
    }
    if (behind) {
      bh = fmaxf(bh, lo);
      bh_min = fminf(bh_min, lo);
      any_b = true;
    }
    if (ahead) {
      ah = fminf(ah, hi);
      ah_max = fmaxf(ah_max, hi);
      any_a = true;
    }
  }
  w_lo = __reduce_min_sync(FT_FULL_MASK, w_lo);
  w_hi = __reduce_max_sync(FT_FULL_MASK, w_hi);

  const float* tab = q.table + (size_t)L.tile * q.m * FT_TABLE_W;
  const float* hsuf = q.hsuf + (size_t)L.tile * chunks;
  float win = mn ? FT_BIG : -FT_BIG;
  for (int c = w_lo; c < w_hi; ++c) {
    if (mn && early_out) {
      // no later candidate can lower any active lane's running min
      const float amax = warp_max(L.active ? win : -FT_BIG);
      if (!(amax + phi > __ldg(hsuf + c))) break;
    }
    const float* row = tab + (size_t)c * FT_CAND_UNROLL * FT_TABLE_W;
#pragma unroll 2
    for (int k = 0; k < FT_CAND_UNROLL; ++k) {
      const float d = prim_dist(q.kind, row + k * FT_TABLE_W, px, py, pz);
      win = mn ? fminf(win, d) : fmaxf(win, d);
    }
  }
  if (mn) {
    bh = warp_max(bh);
    ah = warp_min(ah);
    acc.v = fminf(acc.v, fminf(win, fminf(ah - p_ax, p_ax - bh)));
  } else {
    bh_min = warp_min(bh_min);
    ah_max = warp_max(ah_max);
    any_b = __any_sync(FT_FULL_MASK, any_b);
    any_a = __any_sync(FT_FULL_MASK, any_a);
    const float skip_lb = fmaxf(any_b ? p_ax - bh_min : -FT_BIG,
                                any_a ? ah_max - p_ax : -FT_BIG);
    const float excl =
        __ldg(misc) < (float)q.group_size ? 2.f * L.eps : -FT_BIG;
    acc.v = fmaxf(acc.v, fmaxf(fmaxf(win, skip_lb), excl));
  }
}

// K3: the scan of one culled pair over the tile's whole candidate list
// (culled_sp :1051-1144): the first ceil8(min(count, m)) rows, leaf
// arg-extremum with ties to the lower slot, every row seen by the material
// hook.  Returns the extremum, its slot and its table row (none: bslot
// stays 0x7fffffff); floored is set when a max group's cone excluded
// members and the extremum lies below 2 eps (:1122-1138, :1416-1432): the
// pair's value is then 2 eps and no leaf owns it.
struct PairScan {
  float bd;
  int bslot, brow;
  bool floored;
};

template <typename OnPrim>
__device__ __forceinline__ PairScan scan_pair(const FtPair& q, const Lane& L,
                                              bool mn, float px, float py,
                                              float pz, OnPrim& on_prim) {
  const float* misc = q.misc + (size_t)L.tile * 4;
  const float count = __ldg(misc);
  const int n_c = (int)fminf(count, (float)q.m);
  const int rows = (n_c + FT_CAND_UNROLL - 1) / FT_CAND_UNROLL * FT_CAND_UNROLL;
  const float* tab = q.table + (size_t)L.tile * q.m * FT_TABLE_W;
  PairScan r = {mn ? FT_BIG : -FT_BIG, 0x7fffffff, 0, false};
  for (int i = 0; i < rows; ++i) {
    const float* row = tab + (size_t)i * FT_TABLE_W;
    const float d = prim_dist(q.kind, row, px, py, pz);
    const int slot = (int)__ldg(row + FT_PSTRIDE + 1);
    on_prim(d, (int)__ldg(row + FT_PSTRIDE), slot);
    if ((mn ? d < r.bd : d > r.bd) || (d == r.bd && slot < r.bslot)) {
      r.bd = d;
      r.bslot = slot;
      r.brow = i;
    }
  }
  if (!mn && count < (float)q.group_size && r.bd < 2.f * L.eps) {
    r.bd = 2.f * L.eps;
    r.floored = true;
  }
  return r;
}

// folded into the group strictly, before its dense entries
template <typename OnPrim>
__device__ __forceinline__ void culled_pair(DistCode& acc, const FtPair& q,
                                            const Lane& L, bool mn, int,
                                            float px, float py, float pz,
                                            OnPrim& on_prim) {
  const PairScan r = scan_pair(q, L, mn, px, py, pz, on_prim);
  const float code =
      r.floored || r.bslot == 0x7fffffff ? 0.f : (float)(r.bslot + 1);
  if (mn ? r.bd < acc.v : r.bd > acc.v) acc = {r.bd, code};
}

// AD mode scans the whole list as slot mode does (the TPU body windows the
// scan by the hit shell and caps the value by the skipped chunks' bounds,
// :1372-1432; the winner lies inside that window by construction, so both
// name the same leaf) and evaluates the winner's gradient once
template <typename OnPrim>
__device__ __forceinline__ void culled_pair(DistGrad& acc, const FtPair& q,
                                            const Lane& L, bool mn, int,
                                            float px, float py, float pz,
                                            OnPrim& on_prim) {
  const PairScan r = scan_pair(q, L, mn, px, py, pz, on_prim);
  if (!(mn ? r.bd < acc.v : r.bd > acc.v)) return;
  if (r.floored || r.bslot == 0x7fffffff) {
    smooth_value(acc, r.bd);
    return;
  }
  const float* row =
      q.table + ((size_t)L.tile * q.m + r.brow) * FT_TABLE_W;
  const Dual g = prim_dual(q.kind, row, px, py, pz);
  acc = {r.bd, g.x, g.y, g.z};
}

// a sumexp group's members: sum e, and for DistGrad sum e * gradient
template <typename V, typename OnPrim>
__device__ __forceinline__ V sumexp_members(const FtProgram& P, int e0, int e1,
                                            float k, float px, float py,
                                            float pz, OnPrim& on_prim, V*) {
  float s = 0.f;
  for (int e = e0; e < e1; ++e) {
    const float d = prim_dist(__ldg(P.ent_kind + e),
                              P.ent_params + (size_t)e * FT_PSTRIDE, px, py,
                              pz);
    on_prim(d, __ldg(P.ent_mat + e), __ldg(P.ent_slot + e));
    s += expf(-d / k);
  }
  V acc;
  smooth_value(acc, -k * logf(fmaxf(s, 1e-30f)));
  return acc;
}
template <typename OnPrim>
__device__ __forceinline__ DistGrad sumexp_members(const FtProgram& P, int e0,
                                                   int e1, float k, float px,
                                                   float py, float pz,
                                                   OnPrim& on_prim,
                                                   DistGrad*) {
  float s = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  for (int e = e0; e < e1; ++e) {
    const Dual g = prim_dual(__ldg(P.ent_kind + e),
                             P.ent_params + (size_t)e * FT_PSTRIDE, px, py,
                             pz);
    on_prim(g.v, __ldg(P.ent_mat + e), __ldg(P.ent_slot + e));
    const float w = expf(-g.v / k);
    s += w;
    sx += w * g.x;
    sy += w * g.y;
    sz += w * g.z;
  }
  s = fmaxf(s, 1e-30f);
  return {-k * logf(s), sx / s, sy / s, sz / s};
}

template <typename V, typename OnPrim>
__device__ __forceinline__ V eval_group(const FtProgram& P, const FtCull& C,
                                        const Lane& L, int gid, float px,
                                        float py, float pz, OnPrim& on_prim) {
  const int e0 = __ldg(P.groups + 3 * gid), e1 = __ldg(P.groups + 3 * gid + 1);
  const int op = __ldg(P.groups + 3 * gid + 2);
  if (op == G_SUMEXP) {
    return sumexp_members(P, e0, e1, __ldg(P.group_k + gid), px, py, pz,
                          on_prim, (V*)nullptr);
  }
  V acc;
  const bool mn = op == G_MIN;
  smooth_value(acc, mn ? FT_BIG : -FT_BIG);
  if (C.n_pairs > 0) {
    const int q1 = __ldg(P.group_pairs + 2 * gid + 1);
    for (int q = __ldg(P.group_pairs + 2 * gid); q < q1; ++q) {
      culled_pair(acc, C.pairs[q], L, mn, C.early_out, px, py, pz, on_prim);
    }
  }
  int won = -1;
  for (int e = e0; e < e1; ++e) {
    const float d = prim_dist(__ldg(P.ent_kind + e),
                              P.ent_params + (size_t)e * FT_PSTRIDE, px, py,
                              pz);
    on_prim(d, __ldg(P.ent_mat + e), __ldg(P.ent_slot + e));
    take_member(acc, won, mn, d, P, e);
  }
  finish_members(acc, won, P, px, py, pz);
  return acc;
}

template <typename V, typename OnPrim>
__device__ __forceinline__ V eval_scene(const FtProgram& P, const FtCull& C,
                                        const Lane& L, float px, float py,
                                        float pz, OnPrim& on_prim) {
  V st[FT_MAX_STACK];
  int sp = 0;
  for (int i = 0; i < P.n_ops; ++i) {
    const int op = __ldg(P.ops + 2 * i), arg = __ldg(P.ops + 2 * i + 1);
    if (op == OP_GROUP) {
      st[sp++] = eval_group<V>(P, C, L, arg, px, py, pz, on_prim);
      continue;
    }
    if (op == OP_SUBTRACT) {
      const V b = st[--sp];
      st[sp - 1] = csg_subtract(st[sp - 1], b);
      continue;
    }
    const int base = sp - arg;
    V out = st[base];
    if (op == OP_SMOOTH) {
      out = smooth_fold(st + base, arg, __ldg(P.op_k + i));
    } else {
      for (int j = 1; j < arg; ++j) {
        out = csg_pick(out, st[base + j], op == OP_UNION);
      }
    }
    st[base] = out;
    sp = base + 1;
  }
  return st[0];
}

__device__ __forceinline__ float scene_distance(const FtProgram& P,
                                                const FtCull& C, const Lane& L,
                                                float px, float py, float pz) {
  NoPrimHook none;
  return eval_scene<Dist>(P, C, L, px, py, pz, none).v;
}
