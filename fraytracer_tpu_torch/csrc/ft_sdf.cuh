// Shared device code of the march and surface kernels: the flattened
// scene program, the seven primitive distance functions (written once,
// templated over the scalar type: float for marching, a 3-component
// forward-mode dual number for exact leaf gradients), and the scene
// program interpreter.
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

// primitive kinds, in the flattener's KINDS order
enum { K_SPHERE = 0, K_CAPSULE, K_TORUS, K_TRIANGLE, K_BOX, K_CONE, K_PLANE };
// postfix tree opcodes
enum { OP_GROUP = 0, OP_UNION, OP_INTERSECT, OP_SUBTRACT, OP_SMOOTH };
// group reductions
enum { G_MIN = 0, G_MAX, G_SUMEXP };

// The scene lowered to a small program (built by ops/cuda/march_kernel.py,
// mirrored there as a ctypes Structure — keep the field order in step).
// Entries are the primitives ordered by group, members of a group in
// ascending global slot; each group is one contiguous entry range.
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
// scene program interpreter
// ---------------------------------------------------------------------------
//
// One interpreter, two stack value types:
// - Dist, the distance alone (K1/K2);
// - DistCode, the distance and the signed code +-(slot + 1) of the
//   CSG-winning leaf (K3, slot mode): min/max keep the first extremum,
//   subtract flips the sign of its b side.  A smooth reduction names no
//   single leaf (code 0); the host keeps smooth plans out of K3.
// The per-type rules are the overloads below; on_prim(d, e) sees every
// primitive distance (K3's material argmin).

struct Dist {
  float v;
};
struct DistCode {
  float v, code;
};

__device__ __forceinline__ void smooth_value(Dist& a, float v) { a.v = v; }
__device__ __forceinline__ void smooth_value(DistCode& a, float v) {
  a = {v, 0.f};
}
// group member e with distance d; members run in ascending slot
__device__ __forceinline__ void take_member(Dist& acc, bool mn, float d,
                                            const FtProgram&, int) {
  acc.v = mn ? fminf(acc.v, d) : fmaxf(acc.v, d);
}
__device__ __forceinline__ void take_member(DistCode& acc, bool mn, float d,
                                            const FtProgram& P, int e) {
  // strict compares keep the first extremum
  if (mn ? d < acc.v : d > acc.v) {
    acc = {d, (float)(__ldg(P.ent_slot + e) + 1)};
  }
}
__device__ __forceinline__ Dist csg_subtract(Dist a, Dist b) {
  return {fmaxf(a.v, -b.v)};
}
__device__ __forceinline__ DistCode csg_subtract(DistCode a, DistCode b) {
  return a.v > -b.v ? a : DistCode{-b.v, -b.code};
}
// n-ary union / intersect: the earlier operand wins ties
__device__ __forceinline__ Dist csg_pick(Dist out, Dist v, bool uni) {
  return {uni ? fminf(out.v, v.v) : fmaxf(out.v, v.v)};
}
__device__ __forceinline__ DistCode csg_pick(DistCode out, DistCode v,
                                             bool uni) {
  return (uni ? out.v <= v.v : out.v >= v.v) ? out : v;
}

struct NoPrimHook {
  __device__ __forceinline__ void operator()(float, int) const {}
};

template <typename V, typename OnPrim>
__device__ __forceinline__ V eval_group(const FtProgram& P, int gid, float px,
                                        float py, float pz, OnPrim& on_prim) {
  const int e0 = __ldg(P.groups + 3 * gid), e1 = __ldg(P.groups + 3 * gid + 1);
  const int op = __ldg(P.groups + 3 * gid + 2);
  V acc;
  if (op == G_SUMEXP) {
    const float k = __ldg(P.group_k + gid);
    float s = 0.f;
    for (int e = e0; e < e1; ++e) {
      const float d = prim_dist(__ldg(P.ent_kind + e),
                                P.ent_params + (size_t)e * FT_PSTRIDE, px, py,
                                pz);
      on_prim(d, e);
      s += expf(-d / k);
    }
    smooth_value(acc, -k * logf(fmaxf(s, 1e-30f)));
    return acc;
  }
  const bool mn = op == G_MIN;
  smooth_value(acc, mn ? FT_BIG : -FT_BIG);
  for (int e = e0; e < e1; ++e) {
    const float d = prim_dist(__ldg(P.ent_kind + e),
                              P.ent_params + (size_t)e * FT_PSTRIDE, px, py,
                              pz);
    on_prim(d, e);
    take_member(acc, mn, d, P, e);
  }
  return acc;
}

template <typename V, typename OnPrim>
__device__ __forceinline__ V eval_scene(const FtProgram& P, float px, float py,
                                        float pz, OnPrim& on_prim) {
  V st[FT_MAX_STACK];
  int sp = 0;
  for (int i = 0; i < P.n_ops; ++i) {
    const int op = __ldg(P.ops + 2 * i), arg = __ldg(P.ops + 2 * i + 1);
    if (op == OP_GROUP) {
      st[sp++] = eval_group<V>(P, arg, px, py, pz, on_prim);
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
      const float k = __ldg(P.op_k + i);
      float s = 0.f;
      for (int j = 0; j < arg; ++j) s += expf(-st[base + j].v / k);
      smooth_value(out, -k * logf(fmaxf(s, 1e-30f)));
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

__device__ __forceinline__ float scene_distance(const FtProgram& P, float px,
                                                float py, float pz) {
  NoPrimHook none;
  return eval_scene<Dist>(P, px, py, pz, none).v;
}
